"""Few-vs-few similarity over a huge feature axis with its CUDA kernel
(counterpart of arco_tpu/ops/pallas/pool_sims.py:pool_similarities).

sims[b, k] = sum_f queries[b, f] * pool[k, f] with f32 accumulation.
``pool_similarities`` launches the kernel of csrc/pool_sims.cu for CUDA
tensors and computes the plain PyTorch version ``pool_similarities_plain``
for CPU tensors.
"""

from __future__ import annotations

import torch

from arco_torch.kernels import build

LAUNCHES = {"pool_sims": 0}


def pool_similarities_plain(queries, pool, chunk: int = 1 << 20):
    """The contraction written as a sum of products, in F-chunks so that
    the [B, K, chunk] product stays bounded."""
    b, f = queries.shape
    out = torch.zeros((b, pool.shape[0]), dtype=torch.float32,
                      device=queries.device)
    for s in range(0, f, chunk):
        qs = queries[:, None, s:s + chunk].float()
        ps = pool[None, :, s:s + chunk].float()
        out += (qs * ps).sum(-1)
    return out


def pool_similarities(queries, pool):
    """queries [B, F], pool [K, F] -> [B, K] f32 (bf16 inputs on CUDA).
    Any B: up to 16 query rows share one pass over the pool, more go in
    groups of 16 (csrc/pool_sims.cu)."""
    if queries.device.type == "cpu":
        return pool_similarities_plain(queries, pool)
    if queries.device.type != "cuda":
        raise RuntimeError(f"pool_sims takes CPU or CUDA tensors, got "
                           f"{queries.device}")
    for name, t in (("queries", queries), ("pool", pool)):
        if t.device != queries.device or t.dtype != torch.bfloat16 \
                or not t.is_contiguous() or t.ndim != 2 \
                or t.data_ptr() % 16:
            raise ValueError(f"{name} must be a contiguous, 16-byte aligned "
                             f"2-D bf16 tensor on {queries.device}")
    lib = build.load_library()
    b, f = queries.shape
    k = pool.shape[0]
    if pool.shape[1] != f or f % 8 or b < 1:
        raise ValueError(f"queries {tuple(queries.shape)} / pool "
                         f"{tuple(pool.shape)}: F must match and be a "
                         f"multiple of 8, B at least 1")
    n_chunks = -(-f // lib.arco_pool_sims_chunk(b))
    partial = torch.empty((n_chunks, b, k), dtype=torch.float32,
                          device=queries.device)
    out = torch.empty((b, k), dtype=torch.float32, device=queries.device)
    build.check(lib.arco_pool_sims(
        queries.data_ptr(), pool.data_ptr(), partial.data_ptr(),
        out.data_ptr(), b, k, f, build.stream_ptr(queries.device)),
        "pool_sims")
    LAUNCHES["pool_sims"] += 1
    return out
