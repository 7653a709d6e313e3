#!/usr/bin/env python3
"""Drive the PyTorch port of ARCO (``arco_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero):

1. print the card's name and power limit as nvidia-smi reports them;
2. build the CUDA kernels from ``arco_torch/kernels/csrc`` (nvcc, sm_90a);
3. hold each kernel against its plain PyTorch version at the main path's
   shapes (bf16 inputs, f32 accumulation) and time kernel, plain version,
   and for pool_sims the library matmul; the InfoNCE pair at three draws of
   its negatives over full banks: uniform, and the sampler's 'smc' (the
   main path's) and 'asmc' draws, each launch pair bit-identical to the
   next; pool_sims also at 16 query rows (bs 8+8);
4. hold one small step on the card (bf16 autocast, kernels) against the
   same step on the CPU (f32, plain versions) from the same state, batch
   and draws: once with the strong augmentation off and once at the
   defaults (photometric jitter/blur and AdvMorph on, draws that fire
   them); likewise one small stage-1 pretrain step; and one small stage-2
   step with ``remat=True`` against the same step without it, both on the
   card;
5. drive the main path: ``init_arco_state`` + 3 ``make_arco_step`` steps of
   the stage-2 ARCO trainer at the ``ArcoConfig`` defaults and full width
   (U-Net 16..256, 496-channel reps, 256x256 slices, 2 labeled + 2
   unlabeled, K=36 pool, 50000/30000 banks filled with normalized rows,
   photometric and AdvMorph on, bf16), then 3 with the strong augmentation
   off, with every loss finite and every kernel's launch count equal to the
   number of steps; time the two strong augmentations alone; and take two
   more steps with ``remat=True``, whose peak memory it prints beside
   that of the six steps;
6. drive the CLI: ``arco_torch.cli.train_arco_2d`` trains 4 steps at the
   defaults on a synthetic 256x256 Synapse-layout tree (npz slices: the
   card has no h5py) from the GPU slice bank and checkpoints; a rerun to 6
   steps resumes from full_iter_4; a straight 6-step run, under
   ``torch.cuda.set_sync_debug_mode("warn")``, counts the host syncs and
   must end with the same step, LR and generator state; the iter_6
   weights are evaluated with ``eval.slice2d.evaluate_2d`` on two
   in-memory volumes;
7. drive the two stages through their CLIs at full width on the same tree:
   ``arco_torch.cli.pretrain_2d`` trains 4 steps at the ``ISDConfig``
   defaults (bs 2+2, K=36 queues, 64x64 patches pooled to 8x8) and
   checkpoints, a rerun to 6 resumes from iter_4 (every loss finite, both
   queue pointers at 24, no kernel launched: stage 1 reaches none), and
   ``train_arco_2d --resume`` trains 2 stage-2 steps from its iter_6, each
   kernel launching once a step;
8. drive the 3D path (``arco_torch.cli.train_arco_3d.default_3d_config``:
   V-Net, 112x112x80, 2 classes, fused dim 16, bs 2+2): (a) hold the three
   kernels against their plain versions at its shapes (the InfoNCE pair at
   C = 16 over full 2-class banks, pool_sims over 4 x 16,056,320
   features); (b) one small 3D step on the card against the CPU, as in
   phase 4; (c) 3 full-width steps with the eqv leg and 3 without, every
   loss finite, each kernel launched once a step, step ms and peak memory;
   (d) ``train_arco_3d.train`` 4 steps on six in-memory 128x128x96 volumes
   from the GPU volume bank (log and checkpoint every 2, so both step
   functions run), a rerun to 6 from full_iter_4, and the on-card
   sliding-window evaluation of iter_6 on one volume.

It then prints one JSON line with the phases' numbers, one with the
kernels' numbers (each with its 3D record under "3d"; pool_sims also at 16
query rows under "rows16") and, last, the device line. Without a CUDA GPU, or
without the repository beside it, it prints no result and exits non-zero.

Each kernel's "ms", "plain_ms" and "library_ms" time one call between two
CUDA events, the host's work before the launch included. Its "device_ms"
is the device's time per call alone: calls queued behind a GPU sleep,
between two CUDA events.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM data sheet: HBM3 bandwidth and dense bf16 tensor-core peak.
PEAK_BYTES_PER_S = 3.35e12
PEAK_BF16_OPS_PER_S = 989e12

# the main path's kernel shapes: 4 classes (one bank each) x 256 anchors x
# 512 negatives over 496-channel bank rows; 2 + 2 reps of 496 x 256 x 256
# against 36 pool rows
Q, N, C, TEMP = 256, 512, 496, 0.5
CAPS = (50000, 30000, 30000, 30000)
HW, B_L, B_U, POOL_K = 256, 2, 2, 36
STEPS = 3
# the main path draws its negatives with ArcoConfig.func = "smc"
MAIN_DRAW = "smc"
# ~10 ms of GPU sleep: longer than the host takes to queue the timed calls
SLEEP_CYCLES = 20_000_000


def _log(*args):
    print(*args, flush=True)


def _time_ms(fn, reps):
    """Median ms of ``reps`` calls, each between two CUDA events (the
    host's work before the launch included)."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _device_ms(fn, reps):
    """Device ms per call: ``reps`` calls back to back behind a GPU sleep
    long enough for the host to queue them all, so the time between the
    two CUDA events is the device's alone; the median of three such runs."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def _bound_ms(n_bytes, n_ops):
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_BF16_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def _l2n_rows(x):
    """L2-normalize the rows of a bf16 matrix in place, in blocks of rows
    of at most 2^26 elements (no f32 copy of a multi-GB matrix)."""
    from arco_torch.ops.normalize import l2_normalize
    step = max(1, 2 ** 26 // x.shape[1])
    for r in range(0, x.shape[0], step):
        x[r:r + step] = l2_normalize(x[r:r + step])
    return x


def phase_gpu_name():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    _log(out[0])
    return out[0]


def phase_build():
    from arco_torch.kernels import build
    t0 = time.perf_counter()
    lib = build.library_path()
    build.load_library()
    _log(f"build: {lib.relative_to(ROOT)} in "
         f"{time.perf_counter() - t0:.1f} s")
    for line in lib.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "Compiling entry" in line:
            _log("  ptxas:", line.strip())


def _neg_draws(gen, device, caps, funcs):
    """neg_idx [K, Q, N] int32 drawn over the full banks of capacities
    ``caps``, for each of ``funcs``: uniform (the draw phase 3 first timed),
    and Q*N stratified ('smc', the main path's) or antithetic ('asmc') ranks
    per class, reshaped as losses/contrastive.py does, so that
    neg_idx[k, q, n] = rank[k, n*Q + q]."""
    import torch
    from arco_torch.ops import sampling
    k = len(caps)
    caps = torch.tensor(caps, device=device)
    out = {}
    for func in funcs:
        if func == "uniform":
            out[func] = (torch.rand((k, Q, N), generator=gen, device=device)
                         * caps[:, None, None]).to(torch.int32)
            continue
        ranks = sampling.draw_indices(caps, Q * N, func=func, generator=gen,
                                      device=device)
        out[func] = ranks.reshape(k, N, Q).transpose(1, 2) \
            .to(torch.int32).contiguous()
    return out


def _infonce_inputs(gen, device, caps, c, funcs):
    """A full bank (steady state) of normalized c-channel rows, anchors,
    prototypes, and negatives drawn from each class's capacity."""
    import torch
    bf = torch.bfloat16
    k = len(caps)
    bank = torch.randn((k, max(caps), c), generator=gen, device=device,
                       dtype=bf)
    for i in range(k):
        _l2n_rows(bank[i])
    a_n = _l2n_rows(torch.randn((k * Q, c), generator=gen, device=device,
                                dtype=bf)).view(k, Q, c)
    p_n = _l2n_rows(torch.randn((k, c), generator=gen, device=device,
                                dtype=bf))
    return a_n, p_n, bank, _neg_draws(gen, device, caps, funcs)


def _staged_rows(neg_idx):
    """Rows the kernels' staging copies: a (k, q, n) draw is copied unless
    query q - 1 of the same block's group drew the same row at the same
    n."""
    import torch
    from arco_torch.kernels import build
    group = build.load_library().arco_infonce_group()
    new = torch.ones_like(neg_idx, dtype=torch.bool)
    new[:, 1:] = neg_idx[:, 1:] != neg_idx[:, :-1]
    new[:, ::group] = True
    return int(new.sum())


def _infonce_at(a_n, p_n, bank, neg_idx):
    """Both InfoNCE kernels at one draw of neg_idx: each against its plain
    version (rtol 1e-3: the same bf16 products summed in f32 in another
    order), two launches bit-identical, the autograd Function against
    autograd through the plain sampled_infonce, and the times."""
    import torch
    from arco_torch.kernels import infonce
    from arco_torch.losses import contrastive
    it = 1.0 / TEMP
    pos = (a_n.float() * p_n.float()[:, None]).sum(-1) * it
    denom, e = infonce.infonce_fwd(a_n, bank, neg_idx, it)
    denom_ref, e_ref = infonce.infonce_denom_plain(a_n, bank, neg_idx, it)
    torch.cuda.synchronize()
    err = max((denom - denom_ref).abs().max().item(),
              (e - e_ref).abs().max().item())
    torch.testing.assert_close(denom, denom_ref, rtol=1e-3, atol=0)
    torch.testing.assert_close(e, e_ref, rtol=1e-3, atol=0)
    invtot = 1.0 / (torch.exp(pos - it) + denom_ref)
    ga = infonce.infonce_bwd(e, bank, neg_idx, invtot)
    ga_ref = infonce.infonce_grad_plain(e_ref, bank, neg_idx, invtot)
    torch.cuda.synchronize()
    err_g = (ga - ga_ref).abs().max().item()
    torch.testing.assert_close(ga, ga_ref, rtol=1e-3,
                               atol=1e-3 * ga_ref.abs().max().item())
    denom2, e2 = infonce.infonce_fwd(a_n, bank, neg_idx, it)
    if not (torch.equal(denom, denom2) and torch.equal(e, e2)
            and torch.equal(ga, infonce.infonce_bwd(e2, bank, neg_idx,
                                                    invtot))):
        raise AssertionError("infonce: two launches differ")
    del denom2, e2

    # loss rtol 1e-3; the gradients come back in the anchors' bf16
    # (ulp 2^-8), so rtol 1e-2
    def loss_and_grads(fn):
        a = a_n.detach().clone().requires_grad_()
        p = p_n.detach().clone().requires_grad_()
        loss = fn(a, p, bank, neg_idx, TEMP, bank_normalized=True)
        loss.sum().backward()
        return loss.detach(), a.grad, p.grad
    got = loss_and_grads(infonce.fused_sampled_infonce)
    want = loss_and_grads(contrastive.sampled_infonce)
    torch.testing.assert_close(got[0], want[0].float(), rtol=1e-3, atol=0)
    for g, w in zip(got[1:], want[1:]):
        torch.testing.assert_close(g.float(), w.float(), rtol=1e-2,
                                   atol=1e-2 * w.float().abs().max().item())
    del denom_ref, e_ref, ga_ref, got, want

    # the bounds: each distinct row read once, the small tensors once
    k, q, c = a_n.shape
    distinct = sum(int(torch.unique(neg_idx[i]).numel()) for i in range(k))
    rows = {"rows_distinct": distinct, "rows_fetched": _staged_rows(neg_idx)}
    row_bytes = c * 2
    small = neg_idx.numel() * 4 + e.numel() * 4
    fwd_bytes = (distinct * row_bytes + a_n.numel() * 2 + small
                 + denom.numel() * 4)
    bwd_bytes = (distinct * row_bytes + small + invtot.numel() * 4
                 + ga.numel() * 4)
    ops = 2 * k * q * neg_idx.shape[2] * c
    out = {}
    for name, fn, plain, n_bytes, n_ops, max_err in (
            ("infonce_fwd",
             lambda: infonce.infonce_fwd(a_n, bank, neg_idx, it),
             lambda: infonce.infonce_denom_plain(a_n, bank, neg_idx, it),
             fwd_bytes, ops, err),
            ("infonce_bwd",
             lambda: infonce.infonce_bwd(e, bank, neg_idx, invtot),
             lambda: infonce.infonce_grad_plain(e, bank, neg_idx, invtot),
             bwd_bytes, ops, err_g)):
        bound, by = _bound_ms(n_bytes, n_ops)
        out[name] = {"max_abs_err": max_err, "ms": _time_ms(fn, 50),
                     "device_ms": _device_ms(fn, 50),
                     "plain_ms": _time_ms(plain, 5), "bound_ms": bound,
                     "bound_by": by, **rows}
        _log(f"  {name}: {out[name]['ms']:.4f} ms (device "
             f"{out[name]['device_ms']:.4f}), bound {bound:.4f} ms, "
             f"plain {out[name]['plain_ms']:.3f} ms, max err {max_err:.3g}")
    return out


def _infonce_draws(gen, device, caps, c, funcs):
    """The InfoNCE pair against its plain versions at each draw of
    ``funcs``: {kernel name: {func: record}}."""
    import torch
    a_n, p_n, bank, draws = _infonce_inputs(gen, device, caps, c, funcs)
    per_draw = {"infonce_fwd": {}, "infonce_bwd": {}}
    for func, neg_idx in draws.items():
        for name, r in _infonce_at(a_n, p_n, bank, neg_idx).items():
            per_draw[name][func] = r
        _log(f"infonce (K={len(caps)}, C={c}) at {func} draws: "
             f"{r['rows_distinct']} distinct rows, {r['rows_fetched']} "
             f"staged of {neg_idx.numel()} draws")
    del a_n, p_n, bank, draws
    torch.cuda.empty_cache()
    return per_draw


def _pool_sims_at(gen, device, b, f):
    """pool_sims on b queries of f features against POOL_K pool rows: each
    query near one pool row, so the sims span [0, ~0.7]; against its plain
    version (max error at most 1e-3 of the largest |sim|), timed, and
    torch.matmul timed as the library yardstick."""
    import torch
    from arco_torch.kernels import pool_sims
    bf = torch.bfloat16
    pool = _l2n_rows(torch.randn((POOL_K, f), generator=gen, device=device,
                                 dtype=bf))
    queries = torch.randn((b, f), generator=gen, device=device, dtype=bf)
    for i in range(b):
        queries[i] = (queries[i].float() * (1.0 / math.sqrt(f))
                      + 0.7 * (i + 1) / b * pool[i % POOL_K].float()).to(bf)
    _l2n_rows(queries)
    sims = pool_sims.pool_similarities(queries, pool)
    sims_ref = pool_sims.pool_similarities_plain(queries, pool)
    torch.cuda.synchronize()
    err = (sims - sims_ref).abs().max().item()
    scale = sims_ref.abs().max().item()
    if not err <= 1e-3 * scale:
        raise AssertionError(f"pool_sims ({b} x {f}): max err {err} > "
                             f"1e-3 * {scale}")
    bound, by = _bound_ms((b + POOL_K) * f * 2 + sims.numel() * 4,
                          2 * b * POOL_K * f)

    def sims_fn():
        return pool_sims.pool_similarities(queries, pool)
    out = {"max_abs_err": err, "ms": _time_ms(sims_fn, 20),
           "device_ms": _device_ms(sims_fn, 20),
           "plain_ms": _time_ms(
               lambda: pool_sims.pool_similarities_plain(queries, pool), 3),
           "bound_ms": bound, "bound_by": by,
           "library_ms": _time_ms(lambda: torch.matmul(queries, pool.t()),
                                  20)}
    _log(f"pool_sims ({b} x {f}): max err {err:.3g} of max |sims| "
         f"{scale:.3g}; {out['ms']:.4f} ms (device {out['device_ms']:.4f}), "
         f"bound {bound:.4f}, plain {out['plain_ms']:.3f}, matmul "
         f"{out['library_ms']:.4f}")
    del pool, queries
    torch.cuda.empty_cache()
    return out


def phase_kernels(device):
    """Each kernel against its plain version at the main path's shapes;
    pool_sims also at 16 query rows (bs 8+8)."""
    import torch
    gen = torch.Generator(device=device).manual_seed(0)
    results = []

    # ---- K1 / K2
    per_draw = _infonce_draws(gen, device, CAPS, C,
                              ("uniform", "smc", "asmc"))
    for name, replaces in (("infonce_fwd", "infonce.py:127"),
                           ("infonce_bwd", "infonce.py:147")):
        # the top-level numbers are at the main path's draws
        main = per_draw[name][MAIN_DRAW]
        results.append({
            "name": name, "route": "cuda",
            "source": "arco_torch/kernels/csrc/infonce.cu",
            "replaces": f"arco_tpu/ops/pallas/{replaces}",
            **{k: main[k] for k in ("max_abs_err", "ms", "device_ms",
                                    "plain_ms", "bound_ms", "bound_by")},
            "library_ms": None, "draws": per_draw[name]})

    # ---- K3: queries are the student + teacher reps of the 2 unlabeled
    # images; then 16 rows, the unlabeled reps of bs 8+8
    f = C * HW * HW
    results.append({
        "name": "pool_sims", "route": "cuda",
        "source": "arco_torch/kernels/csrc/pool_sims.cu",
        "replaces": "arco_tpu/ops/pallas/pool_sims.py:54",
        **_pool_sims_at(gen, device, 2 * B_U, f),
        "rows16": _pool_sims_at(gen, device, 16, f)})
    for r in results:
        _log(f"  {r['name']}: {r['ms']:.4f} ms (device "
             f"{r['device_ms']:.4f} ms, plain {r['plain_ms']:.3f} ms, bound "
             f"{r['bound_ms']:.4f} ms by {r['bound_by']}, library "
             f"{r['library_ms']})")
    return results


def _synthetic_batch(b, hw, gen, device, num_classes=4):
    """Label maps of a few discs and images = label / 3 + noise."""
    import torch
    ys = torch.arange(hw, device=device).view(1, hw, 1)
    xs = torch.arange(hw, device=device).view(1, 1, hw)
    label = torch.zeros((b, hw, hw), dtype=torch.int32, device=device)
    for cls in range(1, num_classes):
        c = torch.rand((b, 2, 1, 1), generator=gen, device=device) * hw
        r = (0.1 + 0.2 * torch.rand((b, 1, 1), generator=gen,
                                    device=device)) * hw
        disc = (ys - c[:, 0]) ** 2 + (xs - c[:, 1]) ** 2 < r ** 2
        label = torch.where(disc, cls, label)
    noise = 0.1 * torch.randn((b, 1, hw, hw), generator=gen, device=device)
    image = label[:, None].float() / (num_classes - 1) + noise
    return image, label


def _draws(cfg, b_l, b_u, hw, num_classes, gen):
    """Every random draw of one step, made on the CPU (for dropout-free
    models): the cutmix boxes, the strong augmentations' draws, the TPS
    draws and the sampler uniforms. The strong draws fire AdvMorph on both
    copies and the jitter and the blur on one sample of each."""
    import torch
    from arco_torch.augment.mixing import draw_cutout_boxes
    from arco_torch.augment.morph import draw_morph
    from arco_torch.augment.photometric import draw_photometric
    from arco_torch.augment.tps import draw_tps
    q, n, e = cfg.num_queries, cfg.num_negatives, cfg.memobank_enqueue
    fire = torch.tensor([0.9] + [0.1] * (b_u - 1))
    photo = {}
    for name in ("cj1", "cj2"):
        photo[name] = {**draw_photometric(b_u, gen), "p_jitter": fire,
                       "p_blur": fire}
    morph = {name: {**draw_morph(b_u, (hw // 8, hw // 8), gen),
                    "p": torch.tensor(0.9)} for name in ("m1", "m2")}
    return {"mix_boxes": draw_cutout_boxes(b_u, (hw, hw), generator=gen),
            "photometric": photo, "morph": morph,
            "tps": draw_tps(b_l + b_u, cfg.tps_sigma, generator=gen),
            "contra": {"enq": torch.rand((num_classes, e), generator=gen),
                       "anchor": torch.rand((num_classes, q), generator=gen),
                       "neg": torch.rand((num_classes, q * n),
                                         generator=gen)}}


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to(v, device) for v in tree]
    return tree.to(device)


def phase_reference(device):
    """One small step on ``device`` (bf16 autocast, the kernels) against the
    same step on the CPU in f32 with the plain versions: the same initial
    weights, pool, batch and draws; with the strong augmentation off, then
    at the defaults. Tolerance rtol 5e-2 / atol 2e-2 per loss term: bf16
    autocast (8-bit mantissa) against f32 leaves logit errors of ~1e-2,
    which move the O(0.1) KL of the eqv term by about as much and the O(1)
    terms by a few percent at most."""
    import torch
    from arco_torch.config import ArcoConfig
    from arco_torch.models import net_factory
    from arco_torch.train import arco2d
    hw, b, nc = 64, 2, 4
    small = dict(K=4, num_queries=32, num_negatives=64, memobank_size=256,
                 memobank_size_bg=512, memobank_enqueue=64, topk=2)

    def build(cfg, dev, dtype):
        torch.manual_seed(1)
        mods = arco2d.make_arco_modules(
            net_factory("unet", in_chns=1, class_num=nc,
                        dropout=(0.0,) * 5), hw, hw, batch_size=b)
        state = arco2d.init_arco_state(mods, cfg, (b, 1, hw, hw), seed=1,
                                       device=dev, compute_dtype=dtype)
        step = arco2d.make_arco_step(mods, cfg, num_classes=nc,
                                     max_iterations=100, device=dev)
        return state, step

    for strong in (False, True):
        cfg = ArcoConfig(use_photometric=strong, use_adv_morph=strong,
                         **small)
        ref_state, ref_step = build(cfg, "cpu", torch.float32)
        state, step = build(cfg, device, torch.bfloat16)
        state.random_pool.copy_(ref_state.random_pool)
        gen = torch.Generator().manual_seed(2)
        image_l, label_l = _synthetic_batch(b, hw, gen, "cpu")
        image_u, _ = _synthetic_batch(b, hw, gen, "cpu")
        batch = {"image_l": image_l, "label_l": label_l, "image_u": image_u}
        draws = _draws(cfg, b, b, hw, nc, gen)
        want = ref_step(ref_state, batch, draws)
        got = step(state, _to(batch, device), _to(draws, device))
        label = "defaults" if strong else "strong aug off"
        for k in ("loss", "reco_loss", "loss_q", "unsup_loss", "loss_ce",
                  "loss_dice", "loss_eqv"):
            g, w = float(got[k]), float(want[k])
            _log(f"  reference ({label}) {k}: card {g:.6f} cpu {w:.6f}")
            if not abs(g - w) <= 2e-2 + 5e-2 * abs(w):
                raise AssertionError(f"{label} {k}: card {g} vs cpu {w}")
    _pretrain_reference(device)
    _remat_reference(device, small)


def _pretrain_reference(device):
    """One small stage-1 step on ``device`` (bf16 autocast) against the same
    step on the CPU (f32): the same weights, queues and batch, dropout-free
    U-Nets; phase 4's tolerance per loss term."""
    import torch
    from arco_torch.config import ISDConfig
    from arco_torch.models import net_factory
    from arco_torch.train import pretrain
    hw, b, nc = 64, 2, 4
    cfg = ISDConfig(K=4, latent_feature_size=64, output_pooling_size=4,
                    patch_size=32)

    def build(dev, dtype):
        torch.manual_seed(1)
        mods = pretrain.make_isd_modules(
            net_factory("unet", in_chns=1, class_num=nc,
                        dropout=(0.0,) * 5), nc, latent_feature_size=64,
            output_pooling_size=4)
        state = pretrain.init_pretrain_state(mods, cfg, (b, 1, hw, hw),
                                             seed=1, device=dev,
                                             compute_dtype=dtype)
        return state, pretrain.make_pretrain_step(cfg, 1, nc, 100,
                                                  device=dev)

    ref_state, ref_step = build("cpu", torch.float32)
    state, step = build(device, torch.bfloat16)
    state.queue.copy_(ref_state.queue)
    state.queue_mask.copy_(ref_state.queue_mask)
    gen = torch.Generator().manual_seed(2)
    image, label = _synthetic_batch(b, hw, gen, "cpu")
    teacher = image + 0.05 * torch.randn(image.shape, generator=gen)
    batch = {"student_image": image, "teacher_image": teacher,
             "label": label}
    want = ref_step(ref_state, batch)
    got = step(state, _to(batch, device))
    for k in want:
        g, w = float(got[k]), float(want[k])
        _log(f"  reference (pretrain) {k}: card {g:.6f} cpu {w:.6f}")
        if not abs(g - w) <= 2e-2 + 5e-2 * abs(w):
            raise AssertionError(f"pretrain {k}: card {g} vs cpu {w}")
    if (state.queue_ptr, state.mask_queue_ptr) != (2, 2):
        raise AssertionError("pretrain: the queue pointers are off")


def _remat_reference(device, small):
    """One small stage-2 step with ``remat=True`` against the same step
    without it, both on the card (U-Net dropout and the strong augmentation
    on, drawn from the state's generator): loss terms and BatchNorm running
    statistics within 1e-3 relative."""
    import torch
    from arco_torch.config import ArcoConfig
    from arco_torch.models import net_factory
    from arco_torch.train import arco2d
    hw, b, nc = 64, 2, 4
    gen = torch.Generator().manual_seed(3)
    image_l, label_l = _synthetic_batch(b, hw, gen, "cpu")
    image_u, _ = _synthetic_batch(b, hw, gen, "cpu")
    batch = _to({"image_l": image_l, "label_l": label_l,
                 "image_u": image_u}, device)
    runs = []
    for remat in (False, True):
        cfg = ArcoConfig(remat=remat, **small)
        torch.manual_seed(1)
        mods = arco2d.make_arco_modules(
            net_factory("unet", in_chns=1, class_num=nc), hw, hw,
            batch_size=b)
        state = arco2d.init_arco_state(mods, cfg, (b, 1, hw, hw), seed=1,
                                       device=device)
        step = arco2d.make_arco_step(mods, cfg, num_classes=nc,
                                     max_iterations=100, device=device)
        runs.append((step(state, batch), state.model.state_dict()))
    (want, sd_want), (got, sd_got) = runs
    for k, w in want.items():
        if w.ndim:
            continue
        g, w = float(got[k]), float(w)
        _log(f"  reference (remat) {k}: on {g:.6f} off {w:.6f}")
        if not abs(g - w) <= 1e-6 + 1e-3 * abs(w):
            raise AssertionError(f"remat {k}: on {g} vs off {w}")
    stats = [k for k in sd_want if "running" in k]
    err = max(((sd_got[k] - sd_want[k]).abs()
               / (sd_want[k].abs() + 1e-6)).max().item() for k in stats)
    _log(f"  reference (remat) BatchNorm statistics: max rel err {err:.3g}")
    if not err <= 1e-3:
        raise AssertionError(f"remat: running statistics differ by {err}")


def _check_steps(label, metrics, step_ms, b_l, hw):
    for i, m in enumerate(metrics):
        terms = {k: float(v) for k, v in m.items() if v.ndim == 0}
        _log(f"{label} step {i}: {step_ms[i]:.1f} ms " + json.dumps(terms))
        bad = [k for k, v in terms.items() if not math.isfinite(v)]
        if bad:
            raise AssertionError(f"{label} step {i}: non-finite {bad}")
        if tuple(m["pred_l_label"].shape) != (b_l, hw, hw):
            raise AssertionError(f"pred_l_label {m['pred_l_label'].shape}")


def _time_strong_aug(device, b_u, hw):
    """Device ms of the two strong augmentations alone, at the main path's
    unlabeled batch, with draws that fire them."""
    import torch
    from arco_torch.augment.morph import adv_morph_batch, draw_morph
    from arco_torch.augment.photometric import (batch_photometric,
                                                draw_photometric)
    gen = torch.Generator(device=device).manual_seed(3)
    x = torch.rand((b_u, 1, hw, hw), generator=gen, device=device)
    photo = {**draw_photometric(b_u, gen, device),
             "p_jitter": torch.ones(b_u, device=device),
             "p_blur": torch.ones(b_u, device=device)}
    morph = {**draw_morph(b_u, (hw // 8, hw // 8), gen, device),
             "p": torch.ones((), device=device)}
    out = {"batch_photometric": _device_ms(
        lambda: batch_photometric(x, photo), 20)}
    for coarse in (True, False):
        out[f"adv_morph_batch(coarse_exp={coarse})"] = _device_ms(
            lambda: adv_morph_batch(x, coarse_exp=coarse, draws=morph), 20)
    for k, v in out.items():
        _log(f"  {k}: {v:.4f} device ms at [{b_u}, 1, {hw}, {hw}]")
    return out


def phase_main_path(device):
    """The stage-2 ARCO trainer at full width, through its entry points:
    3 steps at the defaults, then 3 with the strong augmentation off."""
    import torch
    from arco_torch.config import ArcoConfig, DataConfig
    from arco_torch.kernels import launch_counts, reset_launch_counts
    from arco_torch.models import net_factory
    from arco_torch.train import arco2d
    data = DataConfig()
    cfg = ArcoConfig()
    cfg_off = ArcoConfig(use_photometric=False, use_adv_morph=False)
    hw = data.patch_size[0]
    b_l, b_u = data.labeled_bs, data.batch_size - data.labeled_bs
    torch.manual_seed(0)
    model = net_factory("unet", in_chns=data.in_channels,
                        class_num=data.num_classes)
    mods = arco2d.make_arco_modules(model, hw, hw, batch_size=b_l,
                                    total_batch=b_l + b_u)
    t0 = time.perf_counter()
    state = arco2d.init_arco_state(mods, cfg, (b_l, 1, hw, hw), seed=0,
                                   device=device)
    steps = {label: arco2d.make_arco_step(mods, c,
                                          num_classes=data.num_classes,
                                          max_iterations=30000,
                                          device=device)
             for label, c in (("defaults", cfg), ("strong aug off", cfg_off))}
    torch.cuda.synchronize()
    _log(f"init_arco_state: {time.perf_counter() - t0:.2f} s; pool "
         f"{tuple(state.random_pool.shape)} {state.random_pool.dtype}, "
         f"bank {tuple(state.memobank.data.shape)}")
    gen = torch.Generator(device=device).manual_seed(0)
    # full banks of normalized rows, as training holds them after ~200
    # steps (each step enqueues 256 keys per class)
    bank = state.memobank
    for k in range(bank.num_classes):
        _l2n_rows(bank.data[k].normal_(generator=gen))
    bank.count = torch.tensor(bank.capacities, dtype=torch.int32,
                              device=device)
    batches = []
    for _ in range(2 * STEPS):
        image_l, label_l = _synthetic_batch(b_l, hw, gen, device)
        image_u, _ = _synthetic_batch(b_u, hw, gen, device)
        batches.append({"image_l": image_l, "label_l": label_l,
                        "image_u": image_u})
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    step_ms = {label: [] for label in steps}
    metrics = {label: [] for label in steps}
    for i, batch in enumerate(batches):
        label = "defaults" if i < STEPS else "strong aug off"
        t0 = time.perf_counter()
        m = steps[label](state, batch)
        torch.cuda.synchronize()
        step_ms[label].append((time.perf_counter() - t0) * 1e3)
        metrics[label].append(m)
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    for label in steps:
        _check_steps(label, metrics[label], step_ms[label], b_l, hw)
    if state.step != 2 * STEPS \
            or state.random_pool_ptr != 2 * STEPS * b_u % cfg.K:
        raise AssertionError("the step counter or pool pointer is off")
    if bool((state.memobank.ptr == 1).all()):
        raise AssertionError("no keys reached the memory bank")
    _log(f"launches over {2 * STEPS} steps: {counts}")
    for name, n in counts.items():
        if n != 2 * STEPS:
            raise AssertionError(f"{name} launched {n} times in "
                                 f"{2 * STEPS} steps")
    for label in steps:
        _log(f"step ms ({label}) {[round(t, 2) for t in step_ms[label]]}")
    _log(f"peak memory {peak / 2**30:.2f} GiB")
    aug_ms = _time_strong_aug(device, b_u, hw)

    # two more steps at the defaults with remat=True, their own peak
    remat_step = arco2d.make_arco_step(
        mods, dataclasses.replace(cfg, remat=True),
        num_classes=data.num_classes, max_iterations=30000, device=device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    remat_ms, remat_metrics = [], []
    for batch in batches[:2]:
        t0 = time.perf_counter()
        remat_metrics.append(remat_step(state, batch))
        torch.cuda.synchronize()
        remat_ms.append((time.perf_counter() - t0) * 1e3)
    remat_peak = torch.cuda.max_memory_allocated()
    _check_steps("remat", remat_metrics, remat_ms, b_l, hw)
    _log(f"peak memory: {peak / 2**30:.2f} GiB over the 6 steps, "
         f"{remat_peak / 2**30:.2f} GiB over 2 steps with remat=True")
    del state, steps, remat_step, batches, metrics, bank, remat_metrics
    torch.cuda.empty_cache()
    return counts, {"step_ms": step_ms, "peak_gib": peak / 2**30,
                    "strong_aug_device_ms": aug_ms,
                    "remat_step_ms": remat_ms,
                    "remat_peak_gib": remat_peak / 2**30}


# the CLI phase's tree: 64 slices of 256x256, of which labeled_num 1 of the
# Synapse budget (config.PATIENTS_TO_SLICES) makes the first 44 labeled
CLI_SLICES, CLI_VOLUMES, CLI_DEPTH = 64, 2, 8


def _cli_sync_sites(run):
    """Run ``run()`` under sync debug mode "warn"; the host syncs it made,
    counted by the innermost line of the port that made them."""
    import collections
    import traceback
    import warnings
    import torch
    port = str(ROOT / "arco_torch")
    sites = collections.Counter()

    def record(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" not in str(message):
            return
        stack = [f for f in traceback.extract_stack()[:-1]
                 if not f.filename.endswith("warnings.py")]
        ours = [f for f in stack
                if os.path.abspath(f.filename).startswith(port)]
        f = ours[-1] if ours else stack[-1]
        sites[f"{os.path.relpath(f.filename, ROOT)}:{f.lineno}"] += 1

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            run()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return dict(sites.most_common())


def phase_cli(device, workdir, root):
    """The port's CLI at the defaults on the npz tree ``root``: train 4
    steps and checkpoint, resume to 6, a straight 6-step run under sync
    debug mode, and an evaluation of the iter_6 weights."""
    import pickle
    import numpy as np
    import torch
    from arco_torch.cli import train_arco_2d
    from arco_torch.data.synthetic import make_volume
    from arco_torch.eval.slice2d import evaluate_2d, model_predictor
    from arco_torch.kernels import launch_counts, reset_launch_counts
    from arco_torch.models import net_factory
    from arco_torch.train import checkpoint as ckpt
    from arco_torch.train.schedule import poly_lr
    model_dir = str(workdir / "model")
    snap = lambda exp: Path(model_dir) / f"{exp}_1_labeledfinal" / "unet"

    def cli(exp, iterations, log_every=1, ckpt_every=2):
        train_arco_2d.main([
            "--root_path", root, "--exp", exp, "--labeled_num", "1",
            "--snapshot_dir", model_dir, "--max_iterations", str(iterations),
            "--log_every", str(log_every), "--ckpt_every", str(ckpt_every)])

    reset_launch_counts()
    t0 = time.perf_counter()
    cli("Synapse/smoke", 4)
    t1 = time.perf_counter()
    cli("Synapse/smoke", 6)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    counts = launch_counts()
    _log(f"cli: 4 steps in {t1 - t0:.1f} s, resumed to 6 in {t2 - t1:.1f} s "
         f"(set-up included); launches {counts}")
    for name, n in counts.items():
        if n != 6:
            raise AssertionError(f"cli: {name} launched {n} times in 6 "
                                 "steps")
    run = snap("Synapse/smoke")
    log = (run / "log.txt").read_text()
    for want in (f"device data path: 44 + 20 slices staged on {device}",
                 "resuming full train state from full_iter_4",
                 "iteration 6 : loss"):
        if want not in log:
            raise AssertionError(f"cli: log.txt lacks {want!r}")
    with open(run / "record.pkl", "rb") as f:
        history = pickle.load(f)
    if len(history) != 6 or not all(math.isfinite(v) for v in history):
        raise AssertionError(f"cli: record.pkl holds {history}")
    ips = [json.loads(line)["images_per_sec"]
           for line in (run / "metrics.jsonl").read_text().splitlines()]
    # the first step of each run includes cuDNN's and the allocator's
    # warm-up
    steady = ips[1:4] + ips[5:]
    _log(f"cli img/s per step {[round(v, 2) for v in ips]}; median after "
         f"each run's first step {statistics.median(steady):.2f}")

    # a straight 6-step run ends in the resumed run's step, LR and
    # generator state
    syncs = _cli_sync_sites(lambda: cli("Synapse/straight", 6, log_every=3,
                                        ckpt_every=6))
    _log(f"cli host syncs over a straight 6-step run (log every 3): {syncs}")
    load = lambda d: torch.load(d / "full_iter_6" / "state.pt",
                                map_location="cpu", weights_only=True)
    resumed, straight = load(run), load(snap("Synapse/straight"))
    lr = resumed["optimizer"]["param_groups"][0]["lr"]
    if not (resumed["step"] == straight["step"] == 6
            and torch.equal(resumed["generator"], straight["generator"])
            and lr == straight["optimizer"]["param_groups"][0]["lr"]
            == poly_lr(0.01, 5, 6)):
        raise AssertionError("cli: the resumed run's step, LR or generator "
                             "differs from the straight run's")

    model = net_factory("unet", in_chns=1, class_num=4).to(device)
    model.load_state_dict(ckpt.load_model_params(str(run), 6))
    rng = np.random.RandomState(1)
    volumes = {f"vol{i}": make_volume(rng, (256, 256), 4, CLI_DEPTH)
               for i in range(CLI_VOLUMES)}
    res = evaluate_2d(list(volumes), volumes.__getitem__,
                      model_predictor(model, device), 4)
    dice = res["per_class"][:, 0]
    _log(f"eval of iter_6: per-class (dice, jc, hd95, asd) "
         f"{res['per_class'].tolist()}")
    if not (np.isfinite(res["raw"]).all() and (dice >= 0).all()
            and (dice <= 1).all()):
        raise AssertionError(f"cli: eval gave {res['per_class']}")
    return counts, {"images_per_sec": ips, "syncs": syncs,
                    "eval_per_class": res["per_class"].tolist()}


def phase_two_stage(device, workdir, root):
    """Stage 1 then stage 2 through the CLIs at the defaults: pretrain 4
    steps and checkpoint, resume to 6, then train_arco_2d --resume for 2
    steps from the pretrain's iter_6."""
    import torch
    from arco_torch.cli import pretrain_2d, train_arco_2d
    from arco_torch.data.datasets import SynapseDataset
    from arco_torch.kernels import launch_counts, reset_launch_counts
    model_dir = str(workdir / "two_stage")
    exp = "Synapse/pretrain"
    common = ["--root_path", root, "--labeled_num", "1", "--snapshot_dir",
              model_dir, "--log_every", "1", "--ckpt_every", "2"]

    def pretrain(iterations):
        cfg, snap = pretrain_2d.parse(
            common + ["--exp", exp, "--max_iterations", str(iterations)])
        # the card has no h5py: the npz slices, all 64 (44 labeled)
        pretrain_2d.train(cfg, snap, dataset=SynapseDataset(
            root, root, "train", output_size=cfg.data.patch_size))
        return cfg, Path(snap)

    reset_launch_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    pretrain(4)
    t1 = time.perf_counter()
    cfg, run = pretrain(6)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    peak = torch.cuda.max_memory_allocated()
    if any(launch_counts().values()):
        raise AssertionError(f"stage 1 launched kernels: {launch_counts()}")
    log = (run / "log.txt").read_text()
    for want in (f"device data path: {CLI_SLICES} slices staged on {device}",
                 "resuming pretrain state from iter_4",
                 "iteration 6 : loss"):
        if want not in log:
            raise AssertionError(f"pretrain: log.txt lacks {want!r}")
    rows = [json.loads(line)
            for line in (run / "metrics.jsonl").read_text().splitlines()]
    terms = ("loss", "loss_ce", "loss_dice", "loss_latent", "loss_output")
    if len(rows) != 6 or not all(math.isfinite(r[k]) for r in rows
                                 for k in terms):
        raise AssertionError(f"pretrain: metrics {rows}")
    tree = torch.load(run / "iter_6" / "state.pt", map_location="cpu",
                      weights_only=True)
    ptrs = (tree["queue_ptr"], tree["mask_queue_ptr"])
    bs = cfg.data.batch_size
    if tree["step"] != 6 or ptrs != (6 * bs % cfg.isd.K,) * 2:
        raise AssertionError(f"pretrain: step {tree['step']}, queue "
                             f"pointers {ptrs}")
    ips = [r["images_per_sec"] for r in rows]
    # the first step of each run includes cuDNN's and the allocator's
    # warm-up; a log line every step, so each interval is one step
    steady = ips[1:4] + ips[5:]
    step_ms = [1e3 * bs / v for v in ips]
    _log(f"pretrain: 4 steps in {t1 - t0:.1f} s, resumed to 6 in "
         f"{t2 - t1:.1f} s (set-up included); queue pointers {ptrs}")
    _log(f"pretrain step ms {[round(t, 2) for t in step_ms]}; img/s median "
         f"after each run's first step {statistics.median(steady):.2f}; "
         f"peak memory {peak / 2**30:.2f} GiB")

    reset_launch_counts()
    train_arco_2d.main(common + ["--exp", "Synapse/arco", "--resume", exp,
                                 "--max_iterations", "2"])
    torch.cuda.synchronize()
    counts = launch_counts()
    arco_run = Path(model_dir) / "Synapse/arco_1_labeledfinal" / "unet"
    log = (arco_run / "log.txt").read_text()
    if "loading stage-1 checkpoint iter_6" not in log:
        raise AssertionError("stage 2: log.txt lacks the stage-1 handoff")
    rows2 = [json.loads(line) for line in
             (arco_run / "metrics.jsonl").read_text().splitlines()]
    if len(rows2) != 2 or not all(math.isfinite(r["loss"]) for r in rows2):
        raise AssertionError(f"stage 2: metrics {rows2}")
    _log(f"stage 2 from the pretrain's iter_6: losses "
         f"{[r['loss'] for r in rows2]}; launches {counts}")
    for name, n in counts.items():
        if n != 2:
            raise AssertionError(f"stage 2: {name} launched {n} times in 2 "
                                 "steps")
    return counts, {"pretrain_images_per_sec": ips,
                    "pretrain_step_ms": step_ms,
                    "pretrain_peak_gib": peak / 2**30,
                    "stage2_losses": [r["loss"] for r in rows2]}


# the 3D path (train_arco_3d.default_3d_config): 2 classes, banks of 50000
# / 30000 16-channel rows (the V-Net's maps fused to 16 channels) over
# 112x112x80 patches, bs 2 + 2
CAPS_3D, C_3D, PATCH_3D = (50000, 30000), 16, (112, 112, 80)
# the 3D CLI's volumes: larger than the patch, square in-plane; 2 labeled
CLI3D_SIZE, CLI3D_VOLUMES, CLI3D_LABELED = (128, 128, 96), 6, 2


def phase_kernels_3d(device):
    """The three kernels at the 3D path's shapes, each against its plain
    version: the InfoNCE pair at C = 16 over the full 2-class banks
    (uniform and 'smc' draws), pool_sims on 2 * 2 reps of 16 x 112 x 112 x
    80 features against 36 pool rows."""
    import torch
    gen = torch.Generator(device=device).manual_seed(4)
    per_draw = _infonce_draws(gen, device, CAPS_3D, C_3D, ("uniform", "smc"))
    out = {name: {**per_draw[name][MAIN_DRAW], "library_ms": None,
                  "draws": per_draw[name]} for name in per_draw}
    out["pool_sims"] = _pool_sims_at(gen, device, 2 * B_U,
                                     C_3D * math.prod(PATCH_3D))
    return out


def _synthetic_volumes(b, size, gen, device):
    """Label volumes of one sphere each, images = label + noise."""
    import torch
    axes = [torch.arange(n, device=device, dtype=torch.float32).view(
        [1] + [n if i == j else 1 for j in range(3)])
        for i, n in enumerate(size)]
    c = torch.rand((b, 3), generator=gen, device=device) \
        * torch.tensor(size, device=device) * 0.5 \
        + torch.tensor(size, device=device) * 0.25
    r = (0.15 + 0.15 * torch.rand((b,), generator=gen, device=device)) \
        * min(size)
    d2 = sum((ax - c[:, i].view(b, 1, 1, 1)) ** 2
             for i, ax in enumerate(axes))
    label = (d2 < r.view(b, 1, 1, 1) ** 2).to(torch.int32)
    noise = 0.2 * torch.randn((b, 1) + tuple(size), generator=gen,
                              device=device)
    return label[:, None].float() + noise, label


def _draws_3d(cfg, model, b_l, b_u, size, gen):
    """Every random draw of one 3D step, made on the CPU: the 3-D cutmix
    boxes, the TPS draws, the sampler uniforms, and the V-Net's dropout
    masks (x5, x9) of the six forwards."""
    import torch
    from arco_torch.augment.mixing import draw_cutout_boxes
    from arco_torch.augment.tps import draw_tps
    q, n, e = cfg.num_queries, cfg.num_negatives, cfg.memobank_enqueue
    nc = 2
    masks = {name: model.draw_dropout_masks((b, 1) + tuple(size), gen)
             for name, b in (("pseudo", b_u), ("tl", b_l), ("tu", b_u),
                             ("l", b_l), ("u", b_u), ("tps", b_l + b_u))}
    return {"mix_boxes": draw_cutout_boxes(b_u, size, generator=gen),
            "tps": draw_tps(b_l + b_u, cfg.tps_sigma, generator=gen),
            "contra": {"enq": torch.rand((nc, e), generator=gen),
                       "anchor": torch.rand((nc, q), generator=gen),
                       "neg": torch.rand((nc, q * n), generator=gen)},
            "dropout": masks}


def _make_3d(cfg, size, b, device, dtype, seed=1):
    """A V-Net ARCO state and its step (``cfg``: the ArcoConfig) on
    ``device``, weights from ``seed``."""
    import torch
    from arco_torch.cli.train_arco_3d import FEATURE_CHANNELS, FUSED_DIM
    from arco_torch.models import net_factory_3d
    from arco_torch.train import arco2d
    torch.manual_seed(seed)
    mods = arco2d.make_arco_modules(
        net_factory_3d("vnet", in_chns=1, class_num=2), size[1], size[0],
        batch_size=b, feature_channels=FEATURE_CHANNELS, fused_dim=FUSED_DIM)
    state = arco2d.init_arco_state(mods, cfg, (b, 1) + tuple(size),
                                   seed=seed, device=device,
                                   compute_dtype=dtype)
    return mods, state


def phase_reference_3d(device):
    """One small 3D step (32x32x16, bs 2+2, default_3d_config's flags) on
    ``device`` in bf16 with the kernels against the same step on the CPU in
    f32 with the plain versions: the same weights, pool, bank, batch and
    draws (dropout masks included); phase 4's tolerance per loss term."""
    import torch
    from arco_torch.cli.train_arco_3d import default_3d_config
    from arco_torch.train import arco2d
    size, b = (32, 32, 16), 2
    cfg = dataclasses.replace(
        default_3d_config().arco, K=4, num_queries=32, num_negatives=64,
        memobank_size=256, memobank_size_bg=512, memobank_enqueue=64, topk=2)
    runs = []
    for dev, dtype in (("cpu", torch.float32), (device, torch.bfloat16)):
        mods, state = _make_3d(cfg, size, b, dev, dtype)
        step = arco2d.make_arco_step(mods, cfg, num_classes=2,
                                     max_iterations=100, device=dev)
        runs.append((mods, state, step))
    (ref_mods, ref_state, ref_step), (_, state, step) = runs
    state.random_pool.copy_(ref_state.random_pool)
    state.memobank.data.copy_(ref_state.memobank.data)
    gen = torch.Generator().manual_seed(2)
    image_l, label_l = _synthetic_volumes(b, size, gen, "cpu")
    image_u, _ = _synthetic_volumes(b, size, gen, "cpu")
    batch = {"image_l": image_l, "label_l": label_l, "image_u": image_u}
    draws = _draws_3d(cfg, ref_mods.model, b, b, size, gen)
    want = ref_step(ref_state, batch, draws)
    got = step(state, _to(batch, device), _to(draws, device))
    for k in ("loss", "reco_loss", "loss_q", "unsup_loss", "loss_ce",
              "loss_dice", "loss_eqv"):
        g, w = float(got[k]), float(want[k])
        _log(f"  reference (3D) {k}: card {g:.6f} cpu {w:.6f}")
        if not abs(g - w) <= 2e-2 + 5e-2 * abs(w):
            raise AssertionError(f"3D {k}: card {g} vs cpu {w}")


def phase_main_path_3d(device):
    """The 3D trainer's two step functions at default_3d_config and full
    width: 3 steps with the eqv leg, 3 without, on 2 + 2 synthetic
    112x112x80 volumes with full banks."""
    import torch
    from arco_torch.cli.train_arco_3d import default_3d_config
    from arco_torch.kernels import launch_counts, reset_launch_counts
    from arco_torch.train import arco2d
    cfg = default_3d_config()
    b_l = cfg.data.labeled_bs
    b_u = cfg.data.batch_size - b_l
    t0 = time.perf_counter()
    mods, state = _make_3d(cfg.arco, PATCH_3D, b_l, device, torch.bfloat16,
                           seed=0)
    steps = {label: arco2d.make_arco_step(
        mods, dataclasses.replace(cfg.arco, compute_eqv=eqv), num_classes=2,
        max_iterations=cfg.optim.max_iterations, device=device)
        for label, eqv in (("eqv", True), ("no eqv", False))}
    torch.cuda.synchronize()
    _log(f"3D init_arco_state: {time.perf_counter() - t0:.2f} s; pool "
         f"{tuple(state.random_pool.shape)} {state.random_pool.dtype}, "
         f"bank {tuple(state.memobank.data.shape)}")
    gen = torch.Generator(device=device).manual_seed(5)
    bank = state.memobank
    for k in range(bank.num_classes):
        _l2n_rows(bank.data[k].normal_(generator=gen))
    bank.count = torch.tensor(bank.capacities, dtype=torch.int32,
                              device=device)
    batches = []
    for _ in range(2 * STEPS):
        image_l, label_l = _synthetic_volumes(b_l, PATCH_3D, gen, device)
        image_u, _ = _synthetic_volumes(b_u, PATCH_3D, gen, device)
        batches.append({"image_l": image_l, "label_l": label_l,
                        "image_u": image_u})
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    step_ms = {label: [] for label in steps}
    for i, batch in enumerate(batches):
        label = "eqv" if i < STEPS else "no eqv"
        t0 = time.perf_counter()
        m = steps[label](state, batch)
        torch.cuda.synchronize()
        step_ms[label].append((time.perf_counter() - t0) * 1e3)
        terms = {k: float(v) for k, v in m.items() if v.ndim == 0}
        _log(f"3D {label} step {i % STEPS}: {step_ms[label][-1]:.1f} ms "
             + json.dumps(terms))
        if not all(math.isfinite(v) for v in terms.values()):
            raise AssertionError(f"3D step {i}: non-finite {terms}")
        if (terms["loss_eqv"] > 0) != (label == "eqv"):
            raise AssertionError(f"3D {label} step: loss_eqv "
                                 f"{terms['loss_eqv']}")
        if tuple(m["pred_l_label"].shape) != (b_l,) + PATCH_3D:
            raise AssertionError(f"pred_l_label {m['pred_l_label'].shape}")
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    _log(f"3D launches over {2 * STEPS} steps: {counts}")
    for name, n in counts.items():
        if n != 2 * STEPS:
            raise AssertionError(f"3D: {name} launched {n} times in "
                                 f"{2 * STEPS} steps")
    if state.step != 2 * STEPS or bool((state.memobank.ptr != 1).any()):
        # 2 classes: the negative mask is empty (the labeled pixels of a
        # class are never its negatives), so no key is enqueued
        raise AssertionError("3D: the step counter or bank pointer is off")
    for label in steps:
        _log(f"3D step ms ({label}) {[round(t, 2) for t in step_ms[label]]}")
    _log(f"3D peak memory {peak / 2**30:.2f} GiB")
    del state, steps, batches, bank, mods
    torch.cuda.empty_cache()
    return counts, {"step_ms": step_ms, "peak_gib": peak / 2**30}


def phase_cli_3d(device, workdir):
    """The 3D CLI: train_arco_3d.train 4 steps on in-memory LA-like volumes
    from the GPU volume bank (log and checkpoint every 2, so both step
    functions run), a rerun to 6 that resumes from full_iter_4, then the
    sliding-window evaluation of iter_6 on one volume on the card."""
    import functools
    import pickle
    import numpy as np
    import torch
    from arco_torch.cli import train_arco_3d
    from arco_torch.data.datasets import InMemoryVolumes
    from arco_torch.data.synthetic import la_volume
    from arco_torch.eval.sliding_window import evaluate_3d, model_predictor
    from arco_torch.eval.sliding_window_device import \
        test_single_case_3d_device
    from arco_torch.kernels import launch_counts, reset_launch_counts
    from arco_torch.models import net_factory_3d
    from arco_torch.train import checkpoint as ckpt
    rs = np.random.RandomState(2)
    vols = [la_volume(rs, CLI3D_SIZE) for _ in range(CLI3D_VOLUMES)]
    dataset = (InMemoryVolumes(vols[:CLI3D_LABELED], PATCH_3D),
               InMemoryVolumes(vols[CLI3D_LABELED:], PATCH_3D))
    model_dir = str(workdir / "model3d")

    def run(iterations):
        cfg, snap = train_arco_3d.parse([
            "--exp", "LA/smoke", "--labeled_num", str(CLI3D_LABELED),
            "--snapshot_dir", model_dir, "--max_iterations", str(iterations),
            "--log_every", "2", "--ckpt_every", "2"])
        train_arco_3d.train(cfg, snap, dataset=dataset)
        return Path(snap)

    reset_launch_counts()
    t0 = time.perf_counter()
    run(4)
    t1 = time.perf_counter()
    snap = run(6)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    counts = launch_counts()
    _log(f"3D cli: 4 steps in {t1 - t0:.1f} s, resumed to 6 in "
         f"{t2 - t1:.1f} s (set-up included); launches {counts}")
    for name, n in counts.items():
        if n != 6:
            raise AssertionError(f"3D cli: {name} launched {n} times in 6 "
                                 "steps")
    log = (snap / "log.txt").read_text()
    for want in (f"device data path: {CLI3D_LABELED} + "
                 f"{CLI3D_VOLUMES - CLI3D_LABELED} volumes staged on "
                 f"{device}", "resuming full train state from full_iter_4",
                 "iteration 6 : loss"):
        if want not in log:
            raise AssertionError(f"3D cli: log.txt lacks {want!r}")
    with open(snap / "record.pkl", "rb") as f:
        history = pickle.load(f)
    rows = [json.loads(line)
            for line in (snap / "metrics.jsonl").read_text().splitlines()]
    if len(history) != 6 or not all(math.isfinite(v) for v in history) \
            or [r["step"] for r in rows] != [2, 4, 6] \
            or not all(r["loss_eqv"] > 0 for r in rows):
        raise AssertionError(f"3D cli: record.pkl {history}, metrics {rows}")
    vps = [r["volumes_per_sec"] for r in rows]
    _log(f"3D cli vol/s per 2-step log interval {[round(v, 3) for v in vps]}")

    model = net_factory_3d("vnet", in_chns=1, class_num=2).to(device)
    model.load_state_dict(ckpt.load_model_params(str(snap), 6))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = evaluate_3d(["vol0"], {"vol0": vols[0]}.__getitem__,
                      model_predictor(model, device), 2, PATCH_3D, 18, 4,
                      case_fn=functools.partial(test_single_case_3d_device,
                                                device=device))
    eval_s = time.perf_counter() - t0
    metrics = res["per_class"][0]
    _log(f"3D eval of iter_6 on one {CLI3D_SIZE} volume in {eval_s:.2f} s: "
         f"(dice, jc, hd95, asd) {metrics.tolist()}")
    if not (np.isfinite(res["raw"]).all() and 0 <= metrics[0] <= 1
            and 0 <= metrics[1] <= 1 and (metrics[2:] >= 0).all()):
        raise AssertionError(f"3D cli: eval gave {metrics}")
    return counts, {"volumes_per_sec": vps, "eval_s": eval_s,
                    "eval_per_class": res["per_class"].tolist()}


def main():
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA GPU", file=sys.stderr)
        return 2
    if not (ROOT / "arco_torch" / "__init__.py").exists():
        print("chip_smoke: arco_torch/ is not beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda")
    phase_gpu_name()
    phase_build()
    kernels = phase_kernels(device)
    phase_reference(device)
    counts, main_path = phase_main_path(device)
    from arco_torch.data.synthetic import make_synapse_like
    with tempfile.TemporaryDirectory() as workdir:
        workdir = Path(workdir)
        root = make_synapse_like(str(workdir / "Synapse"),
                                 n_train=CLI_SLICES, size=(256, 256))
        cli_counts, cli = phase_cli(device, workdir, root)
        two_counts, two_stage = phase_two_stage(device, workdir, root)
        kernels_3d = phase_kernels_3d(device)
        phase_reference_3d(device)
        counts_3d, main_path_3d = phase_main_path_3d(device)
        cli3d_counts, cli_3d = phase_cli_3d(device, workdir)
    for k in kernels:
        name = k["name"]
        k["launches"] = counts[name]
        k["launches_cli"] = cli_counts[name]
        k["launches_two_stage"] = two_counts[name]
        k["3d"] = {**kernels_3d[name], "launches": counts_3d[name],
                   "launches_cli": cli3d_counts[name]}
    print(json.dumps({"main_path": main_path, "cli": cli,
                      "two_stage": two_stage, "main_path_3d": main_path_3d,
                      "cli_3d": cli_3d}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
