"""Few-vs-few similarity over a huge feature axis with its CUDA kernel
(counterpart of arco_tpu/ops/pallas/pool_sims.py:pool_similarities).

sims[b, k] = sum_f queries[b, f] * pool[k, f] with f32 accumulation.
``pool_similarities`` launches the kernel of csrc/pool_sims.cu for CUDA
tensors and computes the plain PyTorch version ``pool_similarities_plain``
for CPU tensors. On CUDA, bf16 queries against a bf16 pool take the bf16
route ("pool_sims" in LAUNCHES), f32 queries against a bf16 or f32 pool
the f32 route ("pool_sims_f32"), which widens the pool in registers.
"""

from __future__ import annotations

import torch

from arco_torch.kernels import build

LAUNCHES = {"pool_sims": 0, "pool_sims_f32": 0}

# (device index, stream) -> the kernel's workspace: a ticket the kernel
# leaves at zero, then the F-blocks' partial sums. Reused by every launch on
# that stream, which runs after the previous one ended.
_WORKSPACES: dict = {}
_MAX_BLOCKS: dict = {}


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


def _workspace(lib, device, stream: int, b: int, k: int):
    """(workspace, the F-blocks a launch may use) for ``stream``: 16 bytes
    of ticket and max_blocks * round_up(b * k, 4) floats, allocated zeroed
    once and grown when a launch needs more."""
    idx = device.index
    if idx not in _MAX_BLOCKS:
        _MAX_BLOCKS[idx] = lib.arco_pool_sims_blocks_per_sm() * \
            torch.cuda.get_device_properties(idx).multi_processor_count
    max_blocks = _MAX_BLOCKS[idx]
    need = 16 + max_blocks * (-(-b * k // 4) * 4) * 4
    ws = _WORKSPACES.get((idx, stream))
    if ws is None or ws.numel() < need:
        ws = torch.zeros(need, dtype=torch.uint8, device=device)
        _WORKSPACES[(idx, stream)] = ws
    return ws, max_blocks


def pool_similarities(queries, pool):
    """queries [B, F], pool [K, F] -> [B, K] f32. On CUDA: bf16 queries
    against a bf16 pool, or f32 queries against a bf16 or f32 pool. Any B
    and K, F a multiple of 8: up to 16 (bf16) or 8 (f32) query rows and 48
    pool rows share one pass over the operands, more go in groups
    (csrc/pool_sims.cu)."""
    if queries.device.type == "cpu":
        return pool_similarities_plain(queries, pool)
    if queries.device.type != "cuda":
        raise RuntimeError(f"pool_sims takes CPU or CUDA tensors, got "
                           f"{queries.device}")
    f32 = queries.dtype == torch.float32
    pool_dtypes = (torch.bfloat16, torch.float32) if f32 \
        else (torch.bfloat16,)
    for name, t, dtypes in (("queries", queries,
                             (torch.bfloat16, torch.float32)),
                            ("pool", pool, pool_dtypes)):
        if t.device != queries.device or t.dtype not in dtypes \
                or not t.is_contiguous() or t.ndim != 2 \
                or t.data_ptr() % 16:
            raise ValueError(
                f"{name} must be a contiguous, 16-byte aligned 2-D tensor "
                f"on {queries.device}: bf16 queries with a bf16 pool, or "
                f"f32 queries with a bf16 or f32 pool")
    b, f = queries.shape
    k = pool.shape[0]
    if pool.shape[1] != f or f % 8 or b < 1 or k < 1:
        raise ValueError(f"queries {tuple(queries.shape)} / pool "
                         f"{tuple(pool.shape)}: F must match and be a "
                         f"multiple of 8, B and K at least 1")
    lib = build.load_library()
    stream = build.stream_ptr(queries.device)
    ws, max_blocks = _workspace(lib, queries.device, stream, b, k)
    out = torch.empty((b, k), dtype=torch.float32, device=queries.device)
    if f32:
        build.check(lib.arco_pool_sims_f32(
            queries.data_ptr(), pool.data_ptr(),
            int(pool.dtype == torch.float32), ws.data_ptr(), out.data_ptr(),
            b, k, f, max_blocks, stream), "pool_sims_f32")
        LAUNCHES["pool_sims_f32"] += 1
        return out
    build.check(lib.arco_pool_sims(
        queries.data_ptr(), pool.data_ptr(), ws.data_ptr(), out.data_ptr(),
        b, k, f, max_blocks, stream), "pool_sims")
    LAUNCHES["pool_sims"] += 1
    return out
