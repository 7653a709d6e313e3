"""Sampled memory-bank InfoNCE with its CUDA kernel pair (counterpart of
arco_tpu/ops/pallas/infonce.py).

Batched over classes: anchors a_n [K, Q, C] and prototypes p_n [K, C]
(L2-normalized), the bank [K, cap, C] (rows L2-normalized at enqueue) and
the sampled negatives neg_idx [K, Q, N]. Per class:

    denom[q] = sum_n exp(s_qn / T - 1 / T),  s_qn = <a_n[q], bank[idx_qn]>
    loss     = mean_q log(exp(pos_q / T - 1 / T) + denom[q]) - (pos_q/T - 1/T)

``infonce_fwd`` (the denominator and e_qn = exp(s_qn / T - 1 / T)) and
``infonce_bwd`` (the softmax-weighted key sum, from e) launch the kernels of
csrc/infonce.cu for CUDA tensors and compute their plain PyTorch versions,
``infonce_denom_plain`` / ``infonce_grad_plain``, for CPU tensors. On CUDA
a bf16 bank (with bf16 anchors) takes the bf16 route, an f32 bank (with f32
anchors: the step at --compute_dtype float32) the f32 route, each counted
under its own name in LAUNCHES.
``FusedInfoNCE`` pairs them as an autograd Function that saves e for the
backward; the normalization chain and the positive logit stay in PyTorch
around it, and the bank receives no gradient (it holds detached teacher
keys).
"""

from __future__ import annotations

import functools

import torch

from arco_torch.kernels import build
from arco_torch.ops.normalize import l2_normalize

LAUNCHES = {"infonce_fwd": 0, "infonce_bwd": 0, "infonce_fwd_f32": 0,
            "infonce_bwd_f32": 0}

# (device index, stream, ticket count) -> the f32 route's workspace: a
# ticket a (class, query group), which the kernels leave at zero, then the
# partials. Reused by every f32 launch of that many tickets on that
# stream, which runs after the previous one ended; the ticket count in the
# key keeps the partials of one shape off the tickets of another.
_WORKSPACES: dict = {}


def _gather_rows(bank, neg_idx):
    k = torch.arange(bank.shape[0], device=bank.device)[:, None, None]
    return bank[k, neg_idx.long()].float()                # [K, Q, N, C]


def infonce_denom_plain(a_n, bank, neg_idx, inv_temp: float):
    """(denom [K, Q], e [K, Q, N]), both f32."""
    rows = _gather_rows(bank, neg_idx)
    s = torch.einsum("kqc,kqnc->kqn", a_n.float(), rows)
    e = torch.exp(s * inv_temp - inv_temp)
    return e.sum(-1), e


def infonce_grad_plain(e, bank, neg_idx, invtot):
    w = e * invtot[..., None]
    return torch.einsum("kqn,kqnc->kqc", w, _gather_rows(bank, neg_idx))


def _check(*named):
    """Each (name, tensor, dtype) is a contiguous, 16-byte aligned tensor of
    that dtype on the first one's CUDA device."""
    dev = named[0][1].device
    if dev.type != "cuda":
        raise RuntimeError(f"infonce kernels take CPU or CUDA tensors, got "
                           f"{dev}")
    for name, t, dtype in named:
        if t.device != dev or t.dtype != dtype \
                or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be a contiguous, 16-byte aligned "
                             f"{dtype} tensor on {dev}")


def _check_bank(bank, neg_idx, k, q, c):
    if bank.ndim != 3 or bank.shape[0] != k or bank.shape[2] != c \
            or neg_idx.ndim != 3 or neg_idx.shape[:2] != (k, q):
        raise ValueError(f"shapes bank {tuple(bank.shape)}, neg_idx "
                         f"{tuple(neg_idx.shape)} for K={k}, Q={q}, C={c}")


@functools.cache
def _splits(k, q, n, c, f32: bool):
    """The kernels' chunks of the samples at this shape, each with its own
    partials, after checking that the route's kernels take N samples of C
    channels."""
    lib = build.load_library()
    if not lib.arco_infonce_smem(n, c, int(f32)):
        raise ValueError(f"the infonce kernels do not take N={n}, C={c}")
    return lib.arco_infonce_splits(k, q, n, c)


def _workspace(lib, device, k, q, n, c, fwd: bool):
    """The f32 route's workspace for this shape and the current stream,
    allocated zeroed and grown (zeroed) when a launch needs more."""
    need = lib.arco_infonce_work(k, q, n, c, int(fwd))
    key = (device.index, build.stream_ptr(device),
           k * -(-q // lib.arco_infonce_group()))
    ws = _WORKSPACES.get(key)
    if ws is None or ws.numel() < need:
        ws = torch.zeros(need, dtype=torch.uint8, device=device)
        _WORKSPACES[key] = ws
    return ws


def _route(bank):
    """(the bank's dtype, whether it takes the f32 route) on CUDA."""
    if bank.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"the infonce kernels take a bf16 or f32 bank, got "
                         f"{bank.dtype}")
    return bank.dtype, bank.dtype == torch.float32


def infonce_fwd(a_n, bank, neg_idx, inv_temp: float):
    """(denom [K, Q], e [K, Q, N]) f32, e = exp(s / T - 1 / T) of each
    sampled similarity. neg_idx entries must lie in [0, cap). The anchors
    have the bank's dtype, bf16 or f32. One call is one launch in LAUNCHES:
    on the bf16 route two grids (the kernel and the fixed-order sum of its
    partial denominators), on the f32 route one, whose last block of each
    query group sums the partials in the same order."""
    if a_n.device.type == "cpu":
        return infonce_denom_plain(a_n, bank, neg_idx, inv_temp)
    dtype, f32 = _route(bank)
    _check(("a_n", a_n, dtype), ("bank", bank, dtype),
           ("neg_idx", neg_idx, torch.int32))
    k, q, c = a_n.shape
    _check_bank(bank, neg_idx, k, q, c)
    n = neg_idx.shape[2]
    s = _splits(k, q, n, c, f32)
    out = dict(dtype=torch.float32, device=a_n.device)
    denom = torch.empty((k, q), **out)
    e = torch.empty((k, q, n), **out)
    lib = build.load_library()
    dpart = _workspace(lib, a_n.device, k, q, n, c, True) if f32 \
        else torch.empty((k, s, q), **out)
    name = "infonce_fwd_f32" if f32 else "infonce_fwd"
    build.check(getattr(lib, "arco_" + name)(
        a_n.data_ptr(), bank.data_ptr(), neg_idx.data_ptr(), e.data_ptr(),
        dpart.data_ptr(), denom.data_ptr(), k, q, n, c, bank.shape[1],
        float(inv_temp), build.stream_ptr(a_n.device)), name)
    LAUNCHES[name] += 1
    return denom, e


def infonce_bwd(e, bank, neg_idx, invtot):
    """ga [K, Q, C] f32 = invtot * sum_n e * bank[idx], e from infonce_fwd.
    One call is one launch in LAUNCHES: on the bf16 route two grids (the
    kernel and the fixed-order sum of its per-chunk [K, Q, C] partials),
    on the f32 route one, which sums them itself."""
    if e.device.type == "cpu":
        return infonce_grad_plain(e, bank, neg_idx, invtot)
    dtype, f32 = _route(bank)
    _check(("e", e, torch.float32), ("bank", bank, dtype),
           ("neg_idx", neg_idx, torch.int32),
           ("invtot", invtot, torch.float32))
    k, q, n = e.shape
    c = bank.shape[-1]
    _check_bank(bank, neg_idx, k, q, c)
    if neg_idx.shape != e.shape or invtot.shape != (k, q):
        raise ValueError(f"neg_idx {tuple(neg_idx.shape)} and invtot "
                         f"{tuple(invtot.shape)} for e {tuple(e.shape)}")
    s = _splits(k, q, n, c, f32)
    out = dict(dtype=torch.float32, device=e.device)
    ga = torch.empty((k, q, c), **out)
    lib = build.load_library()
    gpart = _workspace(lib, e.device, k, q, n, c, False) if f32 \
        else torch.empty((k, s, q, c), **out)
    name = "infonce_bwd_f32" if f32 else "infonce_bwd"
    build.check(getattr(lib, "arco_" + name)(
        e.data_ptr(), bank.data_ptr(), neg_idx.data_ptr(), invtot.data_ptr(),
        gpart.data_ptr(), ga.data_ptr(), k, q, n, c, bank.shape[1],
        build.stream_ptr(e.device)), name)
    LAUNCHES[name] += 1
    return ga


class FusedInfoNCE(torch.autograd.Function):
    """Per-class loss [K] with the hand-derived backward of
    arco_tpu/ops/pallas/infonce.py:_fused_ce_bwd:

        d loss / d a_n[q] = (g / (T Q)) [ga_q + (sigma_pos_q - 1) p_n]
        d loss / d p_n    = (g / (T Q)) sum_q (sigma_pos_q - 1) a_n[q]

    with ga from the backward kernel; bank and indices get no gradient."""

    @staticmethod
    def forward(ctx, a_n, p_n, bank, neg_idx, inv_temp: float):
        denom, e = infonce_fwd(a_n, bank, neg_idx, inv_temp)
        pos_logit = (a_n.float() * p_n.float()[:, None, :]).sum(-1) \
            * inv_temp
        pos_exp = torch.exp(pos_logit - inv_temp)
        loss = (torch.log(pos_exp + denom) + inv_temp - pos_logit).mean(-1)
        ctx.save_for_backward(a_n, p_n, bank, neg_idx, e, denom, pos_exp)
        ctx.inv_temp = inv_temp
        return loss

    @staticmethod
    def backward(ctx, g):
        a_n, p_n, bank, neg_idx, e, denom, pos_exp = ctx.saved_tensors
        it = ctx.inv_temp
        invtot = 1.0 / (pos_exp + denom)                  # [K, Q]
        ga = infonce_bwd(e, bank, neg_idx, invtot)
        sigma_m1 = (pos_exp * invtot - 1.0)[..., None]    # [K, Q, 1]
        scale = (g.float() * it / a_n.shape[1])[:, None, None]
        grad_a = scale * (ga + sigma_m1 * p_n.float()[:, None, :])
        grad_p = scale[:, 0] * (sigma_m1 * a_n.float()).sum(1)
        return grad_a.to(a_n.dtype), grad_p.to(p_n.dtype), None, None, None


def fused_sampled_infonce(anchor, proto, bank, neg_idx, temp: float = 0.5,
                          bank_normalized: bool = True):
    """Per-class losses [K] through the kernel pair (counterpart of
    pallas_sampled_infonce, vmapped over classes). anchor [K, Q, C],
    proto [K, C], bank [K, cap, C], neg_idx [K, Q, N]."""
    # eps 1e-12 as losses/contrastive.py normalizes (ops/normalize: 1e-24)
    a_n = l2_normalize(anchor, eps=1e-12).contiguous()
    p_n = l2_normalize(proto, eps=1e-12)
    bank_n = bank if bank_normalized else l2_normalize(bank, eps=1e-12)
    return FusedInfoNCE.apply(a_n, p_n, bank_n.detach(),
                              neg_idx.to(torch.int32).contiguous(),
                              1.0 / temp)
