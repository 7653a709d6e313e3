#!/usr/bin/env python3
"""Drive the PyTorch port of ARCO (``arco_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero):

1. print the card's name and power limit as nvidia-smi reports them;
2. build the CUDA kernels from ``arco_torch/kernels/csrc`` (nvcc, sm_90a);
3. hold each kernel against its plain PyTorch version at the main path's
   shapes (bf16 inputs, f32 accumulation) and time kernel, plain version,
   and for pool_sims the library matmul (one call, and its device time as
   the kernel's); the InfoNCE pair at three draws of its negatives over
   full banks: uniform, and the sampler's 'smc' (the main path's) and
   'asmc' draws; pool_sims also at 16 query rows (bs 8+8); each kernel's
   launch bit-identical to the next at every shape (here and in 8a, 12a);
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
   sliding-window evaluation of iter_6 on one volume;
9. drive the 3D two-stage path and the 3-D U-Nets: (a) one small 3D
   stage-1 step (V-Net with dropout, 32x32x16, patch 16) on the card in
   bf16 against the CPU in f32 from one state, batch and set of dropout
   masks, at phase 4's tolerance; (b) ``pretrain_3d.train`` at its
   ``default_3d_config`` (V-Net, 112x112x80, 700 patches of 20^3 pooled to
   8^3, K=36 queues, latent 512, bs 2+2) on six in-memory 128x128x96
   volumes from the GPU volume bank, logging and checkpointing every 2: 4
   steps, a rerun to 6 from iter_4 (every loss finite, both queue pointers
   at 24, no kernel launched), then ``train_arco_3d --resume`` for 2 steps
   from its iter_6, each kernel launching once a step; (c)
   ``pretrain_3d --model unet_3D`` for 2 steps, one train-mode forward and
   backward of AttentionUNet3D and of UNet3DDVSemi at bs 2, 112x112x80, a
   small eval-mode forward of each 3-D U-Net against the CPU, and
   ``test_3d --model unet_3D`` on one 128x128x96 volume;
10. drive the 2D zoo (every ``net_factory`` key but nnUNet): (a) a
   seeded eval forward of each at 64x64 on the card against the CPU (f32,
   TF32 off); (b) each at 256x256, bs 4, bf16 autocast: two train-mode
   forwards + backwards and two eval forwards, ms and peak memory; (c)
   ``train_arco_2d --model unet_stego`` at the defaults on phase 6's npz
   tree, 4 steps and 2 resumed, each kernel launching once a step, and an
   evaluation of its iter_6; (d) ``evaluate_2d`` of enet, pnet,
   efficient_unet, ViT_Seg and swin_unet from saved checkpoints; (e)
   ``pretrain_2d`` for 2 steps of each key JAX's stage 1 takes;
11. drive the rest of the zoo, which runs no kernel (every launch count
   stays 0): (a) a seeded eval forward of nnU-Net 2D (64x64) and 3D
   (128x128x8), VoxResNet (32x32x16), both generators and
   NLayerDiscriminator (64x64), the FC discriminators (224x224, 32^3),
   VGG19Features (64x64) and DeepClusterVGG16 (224x224) on the card
   against the CPU (f32, TF32 off), and ``grid_sample_3d`` over a
   112x112x80 volume; (b) at a user's shapes under bf16 autocast (nnU-Net
   2D at 256x256 bs 4, 3D at 128x128x80 bs 2, VoxResNet at 112x112x80 bs
   2, ResnetGenerator and NLayerDiscriminator at 256x256 bs 4,
   VGG19Features at 224x224 bs 4): two train-mode forwards + backwards
   and two eval forwards, ms and peak memory; (c) nnU-Net's tiled
   predictor: ``predict_tiled`` of the 3D model over a 128x128x96 volume
   (patch 128x128x80, 8 mirror combinations) and ``predict_3d_via_2d`` of
   the 2D model over 256x256 slices, seconds a case and the card's busy
   share from CUDA events around the forwards; (d) ``test_2d``'s
   evaluation of nnUNet, ``test_3d --model nnUNet --patch_size 128 128 80``
   and ``--model voxresnet`` from saved checkpoints, and 2 steps of
   ``pretrain_2d --model nnUNet`` and ``pretrain_3d --model nnUNet`` /
   ``voxresnet``;
12. drive the natural-image branch (``train_arco_natural`` at its
   defaults: DeepLab-v2 / ResNet-101 on Pascal, 321x321 crops, 21 classes,
   bs 4+4, 256-channel reps fused from the four ResNet maps, bf16): (a)
   the three kernels at its shapes against their plain versions (the
   InfoNCE pair over full 21-class banks at C = 256 and at the U-Net's C =
   496, pool_sims on 8 query rows at F = 41*41*256, 21*21*256 and
   320*320*496, beside torch.matmul); (b) one small DeepLab-v2 step
   (65x65, 4 classes, bs 2+2) on the card against the CPU, as in phase 4;
   (c) ``train_arco_natural`` for 4 steps on a synthetic VOC tree (24
   train and 4 val images of VOC's sizes, every class present), logging
   and checkpointing every 2, every loss finite and each kernel launched
   once a step, step ms and peak memory; (d) 2 steps of ``--model
   deeplabv3`` and of ``--model unet --crop_size 320``; (e)
   ``--resume_snapshot`` from (c)'s iter_4 for 2 steps; (f)
   ``--restore_from`` a ``module.``-prefixed state dict of the phase's own
   DeepLab-v2, the trunk checked against the file right after the load;
   (g) ``eval_natural`` of (c)'s iter_4 on the val images, JAX's JSON
   schema and an mIoU in [0, 1];
13. drive ``--pretrained_path``: ``pretrain_2d --model ViT_Seg`` at its
   defaults (the full R50+ViT-B_16 at 256x256) from a synthetic .npz of
   the reference's names and shapes at the model's width, 2 steps on
   phase 6's tree; the weights in the model right after the load must
   equal ``compat.pretrained.convert_vit_npz``'s, every loss be finite and
   no kernel launch;
14. drive the serving surface, which runs no kernel (every launch count
   stays 0): (a) one small supervised step (``train/supervised.py``, U-Net
   64x64, 4 classes, bs 2, f32) on the card against the CPU from the same
   weights, batch and dropout masks at phase 4's tolerance, then the U-Net
   at 256x256, 4 classes, bs 4 for 5 steps through ``step_timer`` (ms a
   step, peak memory); (b) ``measure_fp_time`` and ``measure_fp_bp_time``
   of that U-Net at bs 4, and ``trace()`` around two supervised steps,
   whose Chrome trace must hold CUDA kernel events; (c)
   ``Segmenter.from_snapshot`` of phase 6's iter_6 on an in-memory
   12x224x240 volume, its labels equal to ``eval/slice2d``'s (s a case);
   (d) ``test_synapse`` on two in-memory volumes against a seeded 8-class
   U-Net checkpoint, its JSON line finite and in range; (e)
   ``Segmenter3D.from_snapshot`` of phase 8d's iter_6 on a 144x144x88
   volume, equal to the sliding window called directly (s a case); (f)
   ``predict_volume_sharded`` of that V-Net over a one-rank NCCL process
   group, against the unsharded whole-volume forward (>= 97% agreement,
   scores within 1e-3 away from the depth edges and labels equal there
   but at near-ties, the input's shape, int32); (g)
   ``export_model --batch dynamic --output argmax --device cuda`` of
   phase 6's iter_6, the artifact equal to the eager model at batch 1, 3
   and 8, a softmax export within 1e-5, a CPU-traced artifact moved to the
   card equal too, artifact and eager ms at bs 8; (h) ``repro
   --validate``;
15. drive the data-parallel stage-2 step (``make_arco_step(mesh=)``) at
   phase 5's configuration: (a) 3 steps over a one-rank NCCL mesh against
   3 mesh-less steps from the same seeds, then one step of each under
   the profiler (kernels, NCCL kernels, busy share); (b) two gloo ranks
   on the one card at bs 2+2 each against one process at bs 4+4: one
   f32 step (TF32 off; every term on, through the kernels' f32 routes)
   and 3 bf16 steps, each rank's state equal to the other's; every state
   check reads, beside how far the state is from one process's, how far
   the steps moved it, which must lie beyond the limit; (c) each rank's
   ms a step, peak memory and launches (each kernel route of the step's
   dtype once a step on each rank), and pool_sims at 2 query rows (a
   rank's share of a global bs 2+2 over 2 ranks) against its plain
   version, beside torch.matmul; (d) ``parallel.dryrun``'s
   ``dryrun_multichip(4)`` at its defaults: 4 gloo ranks on the card, a
   2x2 ("data", "space") mesh;
16. drive stage 2 at ``--compute_dtype float32`` through the kernels' f32
   routes (f32 anchors and bank; f32 reps against the bf16 pool, read in
   place): (a) each f32 route against its plain version (TF32 off, rtol
   1e-5) at the 2D and 3D shapes, two launches bit-identical, timed with
   its bound (f32 FMAs at 67 TFLOP/s), and for pool_sims also against an
   f32 pool and beside torch.matmul (with the pool's widening copy where
   the pool is bf16, also timed alone); (b) phase 4's small step at f32
   on the card against the CPU's, strong aug off and at the defaults, each
   loss term at rtol 1e-4 / atol 1e-6; (c) 3 full-width steps of phase
   5's configuration at f32, ms a step and peak memory, the revisiting
   loss handed the state's bf16 pool itself; (d) ``train_arco_2d
   --compute_dtype float32`` for 4 steps on phase 6's tree and (e)
   ``train_arco_3d --compute_dtype float32`` for 4 on phase 9's volumes.
   Every other path launches no f32 route, and phase 16 no bf16 one.
   Phase 16 runs before phase 15.

It then prints one JSON line with the phases' numbers (phase 14's under
"serving", phase 15's under "data_parallel", phase 16's under "f32"), one
with the kernels' numbers (the three bf16 routes, then the three f32
routes "infonce_fwd_f32", "infonce_bwd_f32" and "pool_sims_f32", whose
top-level numbers are at the 2D shape against the bf16 pool, launches from
16c and 16d, every shape's record under "shapes"; each bf16 route with its
3D record under "3d", whose "launches_two_stage"
counts phase 9's handoff leg; "launches_zoo" counts phase 10's unet_stego
leg, "launches_natural" phase 12's DeepLab-v2 leg, whose shapes' records
sit under "natural", "launches_data_parallel" phase 15a's mesh steps and
"launches_data_parallel_ranks" each rank's steps of the route's dtype in
15b; pool_sims
also at 16 and 2 query rows under "rows16" and "rows2") and, last, the
device line. Without a CUDA GPU, or
without the repository beside it, it prints no result and exits non-zero.

Each kernel's "ms", "plain_ms" and "library_ms" time one call between two
CUDA events, the host's work before the launch included. Its "device_ms"
(and pool_sims' "library_device_ms") is the device's time per call alone:
calls queued behind a GPU sleep, between two CUDA events.
"""

from __future__ import annotations

import contextlib
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

# H100 SXM data sheet: HBM3 bandwidth, dense bf16 tensor-core peak and
# f32 outside the tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_BF16_OPS_PER_S = 989e12
PEAK_F32_OPS_PER_S = 67e12

# the kernels' routes, as named in their LAUNCHES: bf16 operands (the bf16
# steps), and f32 anchors and bank, f32 queries against a bf16 or f32 pool
# (the steps at --compute_dtype float32)
BF16_ROUTES = ("infonce_fwd", "infonce_bwd", "pool_sims")
F32_ROUTES = ("infonce_fwd_f32", "infonce_bwd_f32", "pool_sims_f32")

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


def _grid_ms(fn, reps=20):
    """{CUDA kernel name: device ms per call} over ``reps`` calls under
    torch.profiler, or None where it records no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
    except RuntimeError:       # no CUPTI: the timings stand without it
        return None
    out = {}
    for ev in prof.key_averages():
        t = getattr(ev, "device_time_total", 0) or 0
        if t > 0 and ev.device_type == torch.autograd.DeviceType.CUDA:
            out[ev.key[:60]] = t / 1e3 / reps
    return out or None


def _bound_ms(n_bytes, n_ops, peak_ops=PEAK_BF16_OPS_PER_S):
    """The larger of the bytes over the memory rate and the operations over
    ``peak_ops`` (bf16 tensor cores by default, PEAK_F32_OPS_PER_S for the
    f32 routes' FMAs), and which of the two it is."""
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_ops / peak_ops * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def _check_launches(label, counts, n, routes=BF16_ROUTES):
    """Each kernel route of ``routes`` launched ``n`` times over a path,
    every other route none."""
    for name, got in counts.items():
        want = n if name in routes else 0
        if got != want:
            raise AssertionError(f"{label}: {name} launched {got} times, "
                                 f"not {want}")


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


def _infonce_inputs(gen, device, caps, c, funcs, dtype=None):
    """A full bank (steady state) of normalized c-channel rows, anchors,
    prototypes, and negatives drawn from each class's capacity; bf16, or
    ``dtype``."""
    import torch
    bf = dtype or torch.bfloat16
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


def _infonce_bounds(a_n, neg_idx):
    """The row counts of one draw, and each InfoNCE kernel's bound
    (_bound_ms): each distinct sampled row read once, the small tensors
    (anchors, indices, e, invtot, the outputs) once, 2 K Q N C flops (on
    the tensor cores for bf16 rows, in f32 FMAs for f32 rows)."""
    import torch
    k, q, c = a_n.shape
    n = neg_idx.shape[2]
    distinct = sum(int(torch.unique(neg_idx[i]).numel()) for i in range(k))
    rows = {"rows_distinct": distinct, "rows_fetched": _staged_rows(neg_idx)}
    size = a_n.element_size()
    row_bytes = c * size
    small = neg_idx.numel() * 4 + k * q * n * 4          # indices and e
    fwd_bytes = distinct * row_bytes + a_n.numel() * size + small + k * q * 4
    bwd_bytes = (distinct * row_bytes + small + k * q * 4
                 + k * q * c * 4)
    ops = 2 * k * q * n * c
    peak = PEAK_F32_OPS_PER_S if size == 4 else PEAK_BF16_OPS_PER_S
    return rows, {"infonce_fwd": _bound_ms(fwd_bytes, ops, peak),
                  "infonce_bwd": _bound_ms(bwd_bytes, ops, peak)}


def _infonce_at(a_n, p_n, bank, neg_idx):
    """Both InfoNCE kernels at one draw of neg_idx: each against its plain
    version, two launches bit-identical, the autograd Function against
    autograd through the plain sampled_infonce, and the times. bf16 rows:
    rtol 1e-3 (the same bf16 products summed in f32 in another order), the
    gradients, which come back in the anchors' bf16 (ulp 2^-8), rtol 1e-2.
    f32 rows (the f32 route, "infonce_fwd_f32" / "infonce_bwd_f32"): exact
    f32 products against the plain versions' with TF32 off, rtol 1e-5
    throughout; each f32 record also holds "grids", the device ms a call of
    each CUDA kernel it runs (torch.profiler)."""
    import torch
    from arco_torch.kernels import infonce
    from arco_torch.losses import contrastive
    f32 = a_n.dtype == torch.float32
    tol, grad_tol = (1e-5, 1e-5) if f32 else (1e-3, 1e-2)
    it = 1.0 / TEMP
    pos = (a_n.float() * p_n.float()[:, None]).sum(-1) * it
    denom, e = infonce.infonce_fwd(a_n, bank, neg_idx, it)
    denom_ref, e_ref = infonce.infonce_denom_plain(a_n, bank, neg_idx, it)
    torch.cuda.synchronize()
    err = max((denom - denom_ref).abs().max().item(),
              (e - e_ref).abs().max().item())
    torch.testing.assert_close(denom, denom_ref, rtol=tol, atol=0)
    torch.testing.assert_close(e, e_ref, rtol=tol, atol=0)
    invtot = 1.0 / (torch.exp(pos - it) + denom_ref)
    ga = infonce.infonce_bwd(e, bank, neg_idx, invtot)
    ga_ref = infonce.infonce_grad_plain(e_ref, bank, neg_idx, invtot)
    torch.cuda.synchronize()
    err_g = (ga - ga_ref).abs().max().item()
    torch.testing.assert_close(ga, ga_ref, rtol=tol,
                               atol=tol * ga_ref.abs().max().item())
    denom2, e2 = infonce.infonce_fwd(a_n, bank, neg_idx, it)
    if not (torch.equal(denom, denom2) and torch.equal(e, e2)
            and torch.equal(ga, infonce.infonce_bwd(e2, bank, neg_idx,
                                                    invtot))):
        raise AssertionError("infonce: two launches differ")
    del denom2, e2

    def loss_and_grads(fn):
        a = a_n.detach().clone().requires_grad_()
        p = p_n.detach().clone().requires_grad_()
        loss = fn(a, p, bank, neg_idx, TEMP, bank_normalized=True)
        loss.sum().backward()
        return loss.detach(), a.grad, p.grad
    got = loss_and_grads(infonce.fused_sampled_infonce)
    want = loss_and_grads(contrastive.sampled_infonce)
    torch.testing.assert_close(got[0], want[0].float(), rtol=tol, atol=0)
    for g, w in zip(got[1:], want[1:]):
        torch.testing.assert_close(
            g.float(), w.float(), rtol=grad_tol,
            atol=grad_tol * w.float().abs().max().item())
    del denom_ref, e_ref, ga_ref, got, want

    rows, bounds = _infonce_bounds(a_n, neg_idx)
    out = {}
    suffix = "_f32" if f32 else ""
    for name, fn, plain, max_err in (
            ("infonce_fwd",
             lambda: infonce.infonce_fwd(a_n, bank, neg_idx, it),
             lambda: infonce.infonce_denom_plain(a_n, bank, neg_idx, it),
             err),
            ("infonce_bwd",
             lambda: infonce.infonce_bwd(e, bank, neg_idx, invtot),
             lambda: infonce.infonce_grad_plain(e, bank, neg_idx, invtot),
             err_g)):
        bound, by = bounds[name]
        name += suffix
        out[name] = {"max_abs_err": max_err, "ms": _time_ms(fn, 50),
                     "device_ms": _device_ms(fn, 50),
                     "plain_ms": _time_ms(plain, 5), "bound_ms": bound,
                     "bound_by": by, **rows}
        _log(f"  {name}: {out[name]['ms']:.4f} ms (device "
             f"{out[name]['device_ms']:.4f}), bound {bound:.4f} ms, "
             f"plain {out[name]['plain_ms']:.3f} ms, max err {max_err:.3g}")
        if f32:
            out[name]["grids"] = _grid_ms(fn)
            _log(f"  {name} grids (device ms a call): "
                 f"{out[name]['grids']}")
    return out


def _infonce_draws(gen, device, caps, c, funcs, dtype=None):
    """The InfoNCE pair (bf16, or the route of ``dtype``) against its plain
    versions at each draw of ``funcs``: {kernel name: {func: record}}."""
    import torch
    a_n, p_n, bank, draws = _infonce_inputs(gen, device, caps, c, funcs,
                                            dtype)
    per_draw = {}
    for func, neg_idx in draws.items():
        for name, r in _infonce_at(a_n, p_n, bank, neg_idx).items():
            per_draw.setdefault(name, {})[func] = r
        _log(f"infonce (K={len(caps)}, C={c}) at {func} draws: "
             f"{r['rows_distinct']} distinct rows, {r['rows_fetched']} "
             f"staged of {neg_idx.numel()} draws")
    del a_n, p_n, bank, draws
    torch.cuda.empty_cache()
    return per_draw


def _pool_sims_at(gen, device, b, f, query_dtype=None, pool_dtype=None):
    """pool_sims on b queries of f features against POOL_K pool rows: each
    query near one pool row, so the sims span [0, ~0.7]; against its plain
    version, two launches bit-identical, timed, and torch.matmul timed as
    the library yardstick ("library_ms" one call, "library_device_ms" as
    the kernel's "device_ms"). bf16 queries and pool by default: max error
    at most 1e-3 of the largest |sim|. f32 queries (the f32 route) against
    a ``pool_dtype`` pool: rtol 1e-5 and atol 1e-5 of the largest |sim|
    (exact products, f32 sums in another order); against a bf16 pool the
    matmul needs an f32 copy of the pool, which its times include and
    "widen_ms" / "widen_device_ms" time alone."""
    import torch
    from arco_torch.kernels import pool_sims
    bf = torch.bfloat16
    qd, pd = query_dtype or bf, pool_dtype or bf
    f32 = qd == torch.float32
    pool = _l2n_rows(torch.randn((POOL_K, f), generator=gen, device=device,
                                 dtype=pd))
    queries = torch.randn((b, f), generator=gen, device=device, dtype=qd)
    for i in range(b):
        queries[i] = (queries[i].float() * (1.0 / math.sqrt(f))
                      + 0.7 * (i + 1) / b * pool[i % POOL_K].float()).to(qd)
    _l2n_rows(queries)
    label = f"pool_sims{'_f32' if f32 else ''} ({b} x {f}, {pd} pool)"
    sims = pool_sims.pool_similarities(queries, pool)
    sims_ref = pool_sims.pool_similarities_plain(queries, pool)
    torch.cuda.synchronize()
    err = (sims - sims_ref).abs().max().item()
    scale = sims_ref.abs().max().item()
    if f32:
        torch.testing.assert_close(sims, sims_ref, rtol=1e-5,
                                   atol=1e-5 * scale)
    elif not err <= 1e-3 * scale:
        raise AssertionError(f"{label}: max err {err} > 1e-3 * {scale}")
    # the revisiting loss takes top-k of these: the same bits every launch
    if not torch.equal(sims, pool_sims.pool_similarities(queries, pool)):
        raise AssertionError(f"{label}: two launches differ")
    bound, by = _bound_ms(
        b * f * queries.element_size() + POOL_K * f * pool.element_size()
        + sims.numel() * 4, 2 * b * POOL_K * f,
        PEAK_F32_OPS_PER_S if f32 else PEAK_BF16_OPS_PER_S)

    def sims_fn():
        return pool_sims.pool_similarities(queries, pool)

    def matmul():
        return torch.matmul(queries, pool.to(qd).t())
    out = {"max_abs_err": err, "ms": _time_ms(sims_fn, 20),
           "device_ms": _device_ms(sims_fn, 20),
           "plain_ms": _time_ms(
               lambda: pool_sims.pool_similarities_plain(queries, pool), 3),
           "bound_ms": bound, "bound_by": by,
           "library_ms": _time_ms(matmul, 20),
           "library_device_ms": _device_ms(matmul, 20)}
    widen = ""
    if pd != qd:
        out["widen_ms"] = _time_ms(lambda: pool.to(qd), 20)
        out["widen_device_ms"] = _device_ms(lambda: pool.to(qd), 20)
        widen = (f", of which the pool's widening {out['widen_ms']:.4f} "
                 f"(device {out['widen_device_ms']:.4f})")
    _log(f"{label}: max err {err:.3g} of max |sims| "
         f"{scale:.3g}; {out['ms']:.4f} ms (device {out['device_ms']:.4f}), "
         f"bound {bound:.4f}, plain {out['plain_ms']:.3f}, matmul "
         f"{out['library_ms']:.4f} (device {out['library_device_ms']:.4f})"
         + widen)
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


# phase 4's small stage-2 configuration
SMALL_ARCO = dict(K=4, num_queries=32, num_negatives=64, memobank_size=256,
                  memobank_size_bg=512, memobank_enqueue=64, topk=2)
BF16_LOSS_TOL = dict(rtol=5e-2, atol=2e-2)
# f32 on the card against f32 on the CPU: tests/test_torch_port_step.py's
# LOSS_TOL (the port against JAX, both f32)
F32_LOSS_TOL = dict(rtol=1e-4, atol=1e-6)


def phase_reference(device):
    """One small step on ``device`` (bf16 autocast, the kernels) against the
    same step on the CPU in f32 with the plain versions: the same initial
    weights, pool, batch and draws; with the strong augmentation off, then
    at the defaults. Tolerance rtol 5e-2 / atol 2e-2 per loss term: bf16
    autocast (8-bit mantissa) against f32 leaves logit errors of ~1e-2,
    which move the O(0.1) KL of the eqv term by about as much and the O(1)
    terms by a few percent at most."""
    _step_reference(device, "bfloat16", BF16_LOSS_TOL)
    _pretrain_reference(device)
    _remat_reference(device, SMALL_ARCO)


def _step_reference(device, compute_dtype, tol):
    """Phase 4's small step on ``device`` in ``compute_dtype`` ("bfloat16":
    autocast; "float32") against the CPU's in f32, strong aug off, then at
    the defaults, each loss term within ``tol``; returns the card's launch
    counts over the two steps."""
    import torch
    from arco_torch.config import ArcoConfig
    from arco_torch.kernels import launch_counts, reset_launch_counts
    from arco_torch.models import net_factory
    from arco_torch.train import arco2d
    hw, b, nc = 64, 2, 4
    small = SMALL_ARCO
    counts = {}

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
        state, step = build(cfg, device, getattr(torch, compute_dtype))
        state.random_pool.copy_(ref_state.random_pool)
        gen = torch.Generator().manual_seed(2)
        image_l, label_l = _synthetic_batch(b, hw, gen, "cpu")
        image_u, _ = _synthetic_batch(b, hw, gen, "cpu")
        batch = {"image_l": image_l, "label_l": label_l, "image_u": image_u}
        draws = _draws(cfg, b, b, hw, nc, gen)
        want = ref_step(ref_state, batch, draws)
        reset_launch_counts()
        got = step(state, _to(batch, device), _to(draws, device))
        label = ("defaults" if strong else "strong aug off") + \
            ("" if compute_dtype == "bfloat16" else f", {compute_dtype}")
        for k, n in launch_counts().items():
            counts[k] = counts.get(k, 0) + n
        for k in ("loss", "reco_loss", "loss_q", "unsup_loss", "loss_ce",
                  "loss_dice", "loss_eqv"):
            g, w = float(got[k]), float(want[k])
            _log(f"  reference ({label}) {k}: card {g:.8g} cpu {w:.8g}")
            if not abs(g - w) <= tol["atol"] + tol["rtol"] * abs(w):
                raise AssertionError(f"{label} {k}: card {g} vs cpu {w}")
    return counts


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
    _check_launches(f"{2 * STEPS} steps", counts, 2 * STEPS)
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
    _check_launches("cli, 6 steps", counts, 6)
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
    _check_launches("stage 2, 2 steps", counts, 2)
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
    _check_launches(f"3D, {2 * STEPS} steps", counts, 2 * STEPS)
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
    _check_launches("3D cli, 6 steps", counts, 6)
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


def _pretrain_reference_3d(device):
    """One small 3D stage-1 step (V-Net with its dropout, 32x32x16, bs 2
    with 1 labeled, patch 16 pooled to 4^3) on ``device`` in bf16 against
    the same step on the CPU in f32: the same weights, queues, batch and
    dropout masks (drawn on the CPU); phase 4's tolerance per loss term."""
    import torch
    from arco_torch.config import ISDConfig
    from arco_torch.models import net_factory_3d
    from arco_torch.train import pretrain
    size, b = (32, 32, 16), 2
    cfg = ISDConfig(K=4, latent_feature_size=64, output_pooling_size=4,
                    patch_size=16)

    def build(dev, dtype):
        torch.manual_seed(1)
        mods = pretrain.make_isd_modules(
            net_factory_3d("vnet", in_chns=1, class_num=2), 2,
            latent_feature_size=64, output_pooling_size=4)
        state = pretrain.init_pretrain_state(mods, cfg, (b, 1) + size,
                                             seed=1, device=dev,
                                             compute_dtype=dtype)
        return state, pretrain.make_pretrain_step(cfg, 1, 2, 100,
                                                  device=dev)

    ref_state, ref_step = build("cpu", torch.float32)
    state, step = build(device, torch.bfloat16)
    state.queue.copy_(ref_state.queue)
    state.queue_mask.copy_(ref_state.queue_mask)
    gen = torch.Generator().manual_seed(2)
    image, label = _synthetic_volumes(b, size, gen, "cpu")
    teacher = image + 0.05 * torch.randn(image.shape, generator=gen)
    batch = {"student_image": image, "teacher_image": teacher,
             "label": label}
    masks = {who: ref_state.model.draw_dropout_masks((b, 1) + size, gen)
             for who in ("student", "teacher")}
    want = ref_step(ref_state, batch, {"dropout": masks})
    got = step(state, _to(batch, device), {"dropout": _to(masks, device)})
    for k in want:
        g, w = float(got[k]), float(want[k])
        _log(f"  reference (3D pretrain) {k}: card {g:.6f} cpu {w:.6f}")
        if not abs(g - w) <= 2e-2 + 5e-2 * abs(w):
            raise AssertionError(f"3D pretrain {k}: card {g} vs cpu {w}")
    if (state.queue_ptr, state.mask_queue_ptr) != (2, 2):
        raise AssertionError("3D pretrain: the queue pointers are off")


def phase_pretrain_3d(device, workdir):
    """The 3D two-stage path: (a) a small 3D stage-1 step against the CPU;
    (b) pretrain_3d.train at default_3d_config (V-Net, 112x112x80, 700
    patches of 20^3 pooled to 8^3, K=36, latent 512, bs 2+2) on six
    in-memory 128x128x96 volumes from the GPU volume bank, logging and
    checkpointing every 2: 4 steps, a rerun to 6 from iter_4, then
    train_arco_3d --resume for 2 steps from its iter_6."""
    import numpy as np
    import torch
    from arco_torch.cli import pretrain_3d, train_arco_3d
    from arco_torch.data.datasets import InMemoryVolumes
    from arco_torch.data.synthetic import la_volume
    from arco_torch.kernels import launch_counts, reset_launch_counts
    from arco_torch.train import pretrain
    _pretrain_reference_3d(device)
    rs = np.random.RandomState(3)
    vols = [la_volume(rs, CLI3D_SIZE) for _ in range(CLI3D_VOLUMES)]
    model_dir = str(workdir / "pretrain3d")
    exp = "LA/pretrain"
    common = ["--labeled_num", str(CLI3D_LABELED), "--snapshot_dir",
              model_dir, "--log_every", "2", "--ckpt_every", "2"]

    def run_pretrain(iterations):
        cfg, snap = pretrain_3d.parse(
            common + ["--exp", exp, "--max_iterations", str(iterations)])
        pretrain_3d.train(cfg, snap, dataset=InMemoryVolumes(
            vols, cfg.data.patch_size))
        return cfg, Path(snap)

    reset_launch_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    run_pretrain(4)
    t1 = time.perf_counter()
    cfg, run = run_pretrain(6)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    peak = torch.cuda.max_memory_allocated()
    if any(launch_counts().values()):
        raise AssertionError(f"3D stage 1 launched kernels: "
                             f"{launch_counts()}")
    log = (run / "log.txt").read_text()
    for want in (f"device data path: {CLI3D_VOLUMES} volumes staged on "
                 f"{device}", "resuming pretrain state from iter_4",
                 "iteration 6 : loss"):
        if want not in log:
            raise AssertionError(f"3D pretrain: log.txt lacks {want!r}")
    rows = [json.loads(line)
            for line in (run / "metrics.jsonl").read_text().splitlines()]
    terms = ("loss", "loss_ce", "loss_dice", "loss_latent", "loss_output")
    if [r["step"] for r in rows] != [2, 4, 6] or not all(
            math.isfinite(r[k]) for r in rows for k in terms):
        raise AssertionError(f"3D pretrain: metrics {rows}")
    tree = torch.load(run / "iter_6" / "state.pt", map_location="cpu",
                      weights_only=True)
    ptrs = (tree["queue_ptr"], tree["mask_queue_ptr"])
    bs, isd = cfg.data.batch_size, cfg.isd
    # at the defaults [36, 700, 1024]: 10 * 10 * 7 patches of 2 * 8^3
    queue_mask = (isd.K, pretrain._num_patches(
        cfg.data.patch_size, isd.patch_size, isd.patch_size // 2),
        cfg.data.num_classes * isd.output_pooling_size ** 3)
    if tree["step"] != 6 or ptrs != (6 * bs % isd.K,) * 2 \
            or tuple(tree["queue_mask"].shape) != queue_mask:
        raise AssertionError(f"3D pretrain: step {tree['step']}, queue "
                             f"pointers {ptrs}, queue_mask "
                             f"{tuple(tree['queue_mask'].shape)}")
    vps = [r["volumes_per_sec"] for r in rows]
    step_ms = [1e3 * bs / v for v in vps]
    _log(f"3D pretrain: 4 steps in {t1 - t0:.1f} s, resumed to 6 in "
         f"{t2 - t1:.1f} s (set-up included); queue pointers {ptrs}")
    _log(f"3D pretrain vol/s per 2-step log interval "
         f"{[round(v, 3) for v in vps]} (ms a step "
         f"{[round(t, 2) for t in step_ms]}); peak memory "
         f"{peak / 2**30:.2f} GiB")

    reset_launch_counts()
    cfg2, snap2 = train_arco_3d.parse(common + [
        "--exp", "LA/arco", "--resume", exp, "--max_iterations", "2",
        "--log_every", "1"])
    train_arco_3d.train(cfg2, snap2, dataset=(
        InMemoryVolumes(vols[:CLI3D_LABELED], PATCH_3D),
        InMemoryVolumes(vols[CLI3D_LABELED:], PATCH_3D)))
    torch.cuda.synchronize()
    counts = launch_counts()
    log2 = (Path(snap2) / "log.txt").read_text()
    if "loading stage-1 checkpoint iter_6" not in log2:
        raise AssertionError("3D stage 2: log.txt lacks the stage-1 handoff")
    rows2 = [json.loads(line) for line in
             (Path(snap2) / "metrics.jsonl").read_text().splitlines()]
    if len(rows2) != 2 or not all(math.isfinite(r["loss"]) for r in rows2):
        raise AssertionError(f"3D stage 2: metrics {rows2}")
    _log(f"3D stage 2 from the pretrain's iter_6: losses "
         f"{[r['loss'] for r in rows2]}; launches {counts}")
    _check_launches("3D stage 2, 2 steps", counts, 2)
    return counts, vols, {"pretrain_volumes_per_sec": vps,
                          "pretrain_step_ms": step_ms,
                          "pretrain_peak_gib": peak / 2**30,
                          "stage2_losses": [r["loss"] for r in rows2]}


def phase_unet3d(device, workdir, vols):
    """The 3-D U-Nets at full width: pretrain_3d --model unet_3D for 2
    steps; one train-mode forward and backward of AttentionUNet3D and of
    UNet3DDVSemi at bs 2, 112x112x80 (bf16 autocast); a small eval-mode
    forward of each model against the CPU (f32, TF32 off, atol 1e-4); and
    test_3d --model unet_3D on one 128x128x96 volume."""
    import contextlib
    import io
    import numpy as np
    import torch
    from arco_torch.cli import pretrain_3d, test_3d
    from arco_torch.data.datasets import InMemoryVolumes
    from arco_torch.models import net_factory_3d
    model_dir = str(workdir / "unet3d")
    cfg, snap = pretrain_3d.parse([
        "--exp", "LA/unet3d", "--model", "unet_3D", "--labeled_num",
        str(CLI3D_LABELED), "--snapshot_dir", model_dir, "--max_iterations",
        "2", "--log_every", "1", "--ckpt_every", "2"])
    pretrain_3d.train(cfg, snap, dataset=InMemoryVolumes(vols, PATCH_3D))
    rows = [json.loads(line) for line in
            (Path(snap) / "metrics.jsonl").read_text().splitlines()]
    if len(rows) != 2 or not all(math.isfinite(r[k]) for r in rows
                                 for k in ("loss", "loss_latent",
                                           "loss_output")):
        raise AssertionError(f"unet_3D pretrain: metrics {rows}")
    out = {"unet_3D_pretrain_losses": [r["loss"] for r in rows],
           "unet_3D_pretrain_volumes_per_sec":
               [r["volumes_per_sec"] for r in rows]}
    _log(f"unet_3D pretrain: losses {out['unet_3D_pretrain_losses']}, "
         f"vol/s {out['unet_3D_pretrain_volumes_per_sec']}")

    gen = torch.Generator(device=device).manual_seed(6)
    x, _ = _synthetic_volumes(2, PATCH_3D, gen, device)
    for name in ("attention_unet", "unet_3D_dv_semi"):
        torch.manual_seed(0)
        model = net_factory_3d(name, in_chns=1, class_num=2).to(device)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ms = []
        for _ in range(2):      # the first call selects cuDNN's algorithms
            model.zero_grad(set_to_none=True)
            t0 = time.perf_counter()
            with torch.autocast(device.type, dtype=torch.bfloat16):
                y = model(x)
            outs = y if name == "unet_3D_dv_semi" else y[:1]
            loss = sum(o.float().square().mean() for o in outs)
            loss.backward()
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        grads = [p.grad for p in model.parameters()]
        if not (math.isfinite(float(loss.detach())) and all(
                g is not None and bool(torch.isfinite(g).all())
                for g in grads)):
            raise AssertionError(f"{name}: non-finite loss or gradients")
        peak = torch.cuda.max_memory_allocated()
        out[f"{name}_fwd_bwd"] = {"ms": ms, "peak_gib": peak / 2**30}
        _log(f"{name} train-mode forward + backward at [2, 1, "
             f"{PATCH_3D}]: {[round(t, 1) for t in ms]} ms (two calls), "
             f"peak {peak / 2**30:.2f} GiB")
        del model, y, outs, loss, grads
    torch.cuda.empty_cache()

    xs = torch.randn((1, 1, 48, 48, 32),
                     generator=torch.Generator().manual_seed(7))
    for name in ("unet_3D", "unet_3D_dv_semi", "attention_unet"):
        torch.manual_seed(0)
        model = net_factory_3d(name, in_chns=1, class_num=2).eval()
        with torch.no_grad():
            want = model(xs)[0]
            got = model.to(device)(xs.to(device))[0].cpu()
        err = (got - want).abs().max().item()
        _log(f"  reference ({name} eval forward): max err {err:.3g}")
        if not err <= 1e-4 + 1e-4 * want.abs().max().item():
            raise AssertionError(f"{name}: card vs cpu max err {err}")

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        res = test_3d.main([
            "--exp", "LA/unet3d", "--model", "unet_3D", "--labeled_num",
            str(CLI3D_LABELED), "--snapshot_dir", model_dir, "--device",
            device.type],
            dataset=InMemoryVolumes(vols[:1], PATCH_3D))
    eval_s = time.perf_counter() - t0
    metrics = res["per_class"][0]
    _log(f"test_3d --model unet_3D on one {CLI3D_SIZE} volume in "
         f"{eval_s:.2f} s: (dice, jc, hd95, asd) {metrics.tolist()}")
    if not (np.isfinite(res["raw"]).all() and 0 <= metrics[0] <= 1
            and 0 <= metrics[1] <= 1 and (metrics[2:] >= 0).all()):
        raise AssertionError(f"test_3d unet_3D: eval gave {metrics}")
    out["unet_3D_eval"] = {"s": eval_s, "per_class": metrics.tolist()}
    return out


# phase 10: the 2D zoo (every net_factory key but nnUNet), timed at the
# trainer's shapes; checked against the CPU at a small size
ZOO = ("unet_stego", "unet_har", "unet_ds", "unet_cct", "unet_urpc", "pnet",
       "enet", "efficient_unet", "ViT_Seg", "swin_unet")
ZOO_EVAL = ("enet", "pnet", "efficient_unet", "ViT_Seg", "swin_unet")
ZOO_PRETRAIN = ("unet_stego", "enet", "pnet", "efficient_unet", "ViT_Seg",
                "swin_unet")
ZOO_HW, ZOO_BS, ZOO_CHECK_HW = 256, 4, 64


def _zoo_card_vs_cpu(device):
    """(a) A seeded eval forward of each zoo model at 64x64, f32 with TF32
    off, on the card against the CPU: every output within atol 1e-4 +
    rtol 1e-4 of its scale."""
    import torch
    from arco_torch.models import net_factory
    x = torch.randn((2, 1, ZOO_CHECK_HW, ZOO_CHECK_HW),
                    generator=torch.Generator().manual_seed(8))
    errs = {}
    for key in ZOO:
        torch.manual_seed(0)
        model = net_factory(key, in_chns=1, class_num=4,
                            img_size=ZOO_CHECK_HW).eval()
        # UNetCCT perturbs in eval mode too: the same draws on both sides
        kw = {"perturb": _cct_draws(x)} if key == "unet_cct" else {}
        with torch.no_grad():
            want = _flat(model(x, **kw))
            kw = {"perturb": [[d.to(device) for d in k] for k in
                              kw["perturb"]]} if kw else {}
            got = [t.cpu() for t in _flat(model.to(device)(x.to(device),
                                                           **kw))]
        err = max((g - w).abs().max().item() for g, w in zip(got, want))
        scale = max(w.abs().max().item() for w in want)
        errs[key] = err
        if not (len(got) == len(want) and err <= 1e-4 + 1e-4 * scale):
            raise AssertionError(f"{key}: card vs cpu max err {err} "
                                 f"(scale {scale})")
    _log(f"zoo card vs cpu (eval, {ZOO_CHECK_HW}x{ZOO_CHECK_HW}, f32): max "
         f"err {errs}")
    return errs


def _cct_draws(x):
    """UNetCCT's perturbation draws for input ``x`` (CPU, seeded): the
    noise uniforms and keep-masks of its five encoder maps, and the
    feature-dropout factors."""
    import torch
    gen = torch.Generator().manual_seed(10)
    b, _, h, w = x.shape
    shapes = [(b, c, h >> k, w >> k)
              for k, c in enumerate((16, 32, 64, 128, 256))]
    return [[(torch.rand(s, generator=gen) * 2 - 1) * 0.3 for s in shapes],
            [torch.rand(s, generator=gen) < 0.7 for s in shapes],
            [0.7 + 0.2 * torch.rand((b,), generator=gen) for _ in shapes]]


def _flat(out):
    """A forward's tensors: lists and tuples flattened, dicts by key."""
    import torch
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, dict):
        return _flat([out[k] for k in sorted(out)])
    return [t for o in out for t in _flat(o)]


def _zoo_timing(device):
    """(b) Each zoo model at 256x256, 1 channel, 4 classes, bs 4 under bf16
    autocast as the trainer runs: two train-mode forwards + backwards of
    the mean square of every output, then two eval forwards (the second
    is warm); ms of each call and the peak memory."""
    import torch
    from arco_torch.models import net_factory
    gen = torch.Generator(device=device).manual_seed(9)
    x = torch.randn((ZOO_BS, 1, ZOO_HW, ZOO_HW), generator=gen,
                    device=device)
    out = {}
    for key in ZOO:
        torch.manual_seed(0)
        model = net_factory(key, in_chns=1, class_num=4,
                            img_size=ZOO_HW).to(device).train()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ms = []
        for _ in range(2):      # the first call selects cuDNN's algorithms
            model.zero_grad(set_to_none=True)
            t0 = time.perf_counter()
            with torch.autocast(device.type, dtype=torch.bfloat16):
                loss = sum(o.float().square().mean() for o in _flat(model(x)))
            loss.backward()
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        if not (math.isfinite(float(loss.detach())) and all(
                p.grad is not None and bool(torch.isfinite(p.grad).all())
                for p in model.parameters())):
            raise AssertionError(f"{key}: non-finite loss or gradients")
        model.eval()
        eval_ms = []
        for _ in range(2):      # the first no-grad call has its own set-up
            t0 = time.perf_counter()
            with torch.no_grad(), torch.autocast(device.type,
                                                 dtype=torch.bfloat16):
                logits = model(x)[0]
            torch.cuda.synchronize()
            eval_ms.append((time.perf_counter() - t0) * 1e3)
        if tuple(logits.shape) != (ZOO_BS, 4, ZOO_HW, ZOO_HW) \
                or not bool(torch.isfinite(logits).all()):
            raise AssertionError(f"{key}: eval logits {logits.shape}")
        peak = torch.cuda.max_memory_allocated() / 2**30
        out[key] = {"fwd_bwd_ms": ms, "eval_ms": eval_ms, "peak_gib": peak,
                    "params": sum(p.numel() for p in model.parameters())}
        _log(f"{key} at [{ZOO_BS}, 1, {ZOO_HW}, {ZOO_HW}] bf16: forward + "
             f"backward {[round(t, 2) for t in ms]} ms, eval forward "
             f"{[round(t, 2) for t in eval_ms]} ms (two calls each), peak "
             f"{peak:.2f} GiB")
        del model, loss, logits
    torch.cuda.empty_cache()
    return out


def _zoo_eval(device, model_dir, key, volumes, state_dict=None):
    """evaluate_2d through test_2d's predictor (eval mode, f32) of the
    weights in ``model_dir``'s newest iter_<N> (written first from
    ``state_dict`` when given); the metrics must be finite and in range."""
    import numpy as np
    from arco_torch.eval.slice2d import evaluate_2d, model_predictor
    from arco_torch.models import net_factory
    from arco_torch.train import checkpoint as ckpt
    if state_dict is not None:
        ckpt._save(ckpt._path(model_dir, 1), {"step": 1,
                                              "model": state_dict})
    model = net_factory(key, in_chns=1, class_num=4,
                        img_size=ZOO_HW).to(device)
    model.load_state_dict(ckpt.load_model_params(
        model_dir, ckpt.latest_step(model_dir)))
    res = evaluate_2d(list(volumes), volumes.__getitem__,
                      model_predictor(model, device), 4, (ZOO_HW, ZOO_HW))
    pc = res["per_class"]
    if not (np.isfinite(res["raw"]).all() and (pc[:, :2] >= 0).all()
            and (pc[:, :2] <= 1).all() and (pc[:, 2:] >= 0).all()):
        raise AssertionError(f"{key}: eval gave {pc}")
    return pc.tolist()


def phase_zoo(device, workdir, root):
    """Phase 10, the 2D zoo: (a) card vs CPU of every new key; (b) its
    full-width timing; (c) train_arco_2d --model unet_stego at the defaults
    on the npz tree, 4 steps and 2 resumed, each kernel launching once a
    step, and an evaluation of its iter_6; (d) evaluate_2d of the five
    other 3-tuple models from saved checkpoints; (e) pretrain_2d for 2
    steps of each key JAX's stage 1 takes."""
    import numpy as np
    import torch
    from arco_torch.cli import pretrain_2d, train_arco_2d
    from arco_torch.config import TrainConfig
    from arco_torch.data.datasets import SynapseDataset
    from arco_torch.data.synthetic import make_volume
    from arco_torch.kernels import launch_counts, reset_launch_counts
    from arco_torch.models import net_factory
    t_start = time.perf_counter()
    out = {"card_vs_cpu_err": _zoo_card_vs_cpu(device)}
    out["timing"] = _zoo_timing(device)

    model_dir = str(workdir / "zoo")
    common = ["--root_path", root, "--labeled_num", "1", "--snapshot_dir",
              model_dir, "--log_every", "1", "--ckpt_every", "2"]
    reset_launch_counts()
    for iterations in (4, 6):
        train_arco_2d.main(common + ["--exp", "Synapse/zoo", "--model",
                                     "unet_stego", "--max_iterations",
                                     str(iterations)])
    torch.cuda.synchronize()
    counts = launch_counts()
    run = Path(model_dir) / "Synapse/zoo_1_labeledfinal" / "unet_stego"
    log = (run / "log.txt").read_text()
    if "resuming full train state from full_iter_4" not in log:
        raise AssertionError("zoo: the unet_stego rerun did not resume")
    rows = [json.loads(line)
            for line in (run / "metrics.jsonl").read_text().splitlines()]
    if len(rows) != 6 or not all(math.isfinite(r["loss"]) for r in rows):
        raise AssertionError(f"zoo: unet_stego metrics {rows}")
    _check_launches("zoo, 6 unet_stego steps", counts, 6)
    ips = [r["images_per_sec"] for r in rows]
    bs = TrainConfig().data.batch_size
    out["unet_stego_cli"] = {"images_per_sec": ips,
                             "step_ms": [1e3 * bs / v for v in ips],
                             "losses": [r["loss"] for r in rows]}
    _log(f"train_arco_2d --model unet_stego: losses "
         f"{[round(r['loss'], 4) for r in rows]}, step ms "
         f"{[round(1e3 * bs / v, 2) for v in ips]}; launches {counts}")

    rng = np.random.RandomState(1)
    volumes = {f"vol{i}": make_volume(rng, (ZOO_HW, ZOO_HW), 4, CLI_DEPTH)
               for i in range(CLI_VOLUMES)}
    evals = {"unet_stego": _zoo_eval(device, str(run), "unet_stego",
                                     volumes)}
    for key in ZOO_EVAL:
        torch.manual_seed(0)
        sd = net_factory(key, in_chns=1, class_num=4,
                         img_size=ZOO_HW).state_dict()
        evals[key] = _zoo_eval(device, str(Path(model_dir) / key), key,
                               volumes, sd)
    out["eval_per_class"] = evals
    _log(f"zoo evaluate_2d (dice, jc, hd95, asd) of class 1: "
         f"{ {k: [round(v, 3) for v in pc[0]] for k, pc in evals.items()} }")

    pre = {}
    reset_launch_counts()
    for key in ZOO_PRETRAIN:
        cfg, snap = pretrain_2d.parse(common + [
            "--exp", "Synapse/zoo_pre", "--model", key,
            "--max_iterations", "2"])
        pretrain_2d.train(cfg, snap, dataset=SynapseDataset(
            root, root, "train", output_size=cfg.data.patch_size))
        rows = [json.loads(line) for line in
                (Path(snap) / "metrics.jsonl").read_text().splitlines()]
        if len(rows) != 2 or not all(math.isfinite(r[k]) for r in rows
                                     for k in ("loss", "loss_latent",
                                               "loss_output")):
            raise AssertionError(f"zoo pretrain {key}: metrics {rows}")
        pre[key] = [r["loss"] for r in rows]
    torch.cuda.synchronize()
    if any(launch_counts().values()):
        raise AssertionError(f"zoo pretrain launched kernels: "
                             f"{launch_counts()}")
    out["pretrain_losses"] = pre
    _log(f"pretrain_2d 2 steps: losses {pre}")
    out["s"] = time.perf_counter() - t_start
    _log(f"phase 10 (zoo) in {out['s']:.1f} s")
    return counts, out


# phase 11: the rest of the zoo (nnU-Net 2D/3D and its tiled predictor,
# VoxResNet, grid_sample_3d, the GAN, discriminator and VGG modules)
NN3D_PATCH, NN3D_VOLUME = (128, 128, 80), (128, 128, 96)
VIA2D_SLICES, VGG_HW = 4, 224


def _rest_models():
    """name -> (constructor, input shapes) of phase 11a's card-vs-CPU check."""
    from arco_torch.models import (discriminator, gan, net_factory,
                                   net_factory_3d, vgg)
    return {
        "nnUNet_2d": (lambda: net_factory("nnUNet", class_num=4),
                      [(2, 1, 64, 64)]),
        "nnUNet_3d": (lambda: net_factory_3d("nnUNet", class_num=2),
                      [(1, 1, 128, 128, 8)]),
        "voxresnet": (lambda: net_factory_3d("voxresnet", class_num=2),
                      [(2, 1, 32, 32, 16)]),
        "resnet_generator": (lambda: gan.define_g(3, 3, 64,
                                                  "resnet_9blocks"),
                             [(2, 3, 64, 64)]),
        "unet_generator": (lambda: gan.UnetGenerator(3, 3, num_downs=6),
                           [(2, 3, 64, 64)]),
        "nlayer_discriminator": (lambda: gan.define_d(3, 64, "basic"),
                                 [(2, 3, 64, 64)]),
        "fc_discriminator": (lambda: discriminator.FCDiscriminator(4),
                             [(2, 4, 224, 224), (2, 1, 224, 224)]),
        "fc3d_discriminator": (
            lambda: discriminator.FC3DDiscriminator(2),
            [(2, 2, 32, 32, 32), (2, 1, 32, 32, 32)]),
        "vgg19_features": (lambda: vgg.VGG19Features(
            normalize_features=True), [(2, 3, 64, 64)]),
        "deepcluster_vgg16": (lambda: vgg.DeepClusterVGG16(sobel=True),
                              [(2, 3, 224, 224)]),
    }


def _rest_card_vs_cpu(device):
    """(a) A seeded eval forward of each new model, f32 with TF32 off, on
    the card against the CPU, every output within atol 1e-4 + rtol 1e-4
    of its scale; and grid_sample_3d on a random grid over a 112x112x80
    volume, both padding modes."""
    import torch
    from arco_torch.ops.interpolate import grid_sample_3d
    gen = torch.Generator().manual_seed(11)
    errs = {}
    for name, (build, shapes) in _rest_models().items():
        torch.manual_seed(0)
        model = build().eval()
        xs = [torch.randn(s, generator=gen) for s in shapes]
        with torch.no_grad():
            want = _flat(model(*xs))
            got = [t.cpu() for t in _flat(model.to(device)(
                *[x.to(device) for x in xs]))]
        err = max((g - w).abs().max().item() for g, w in zip(got, want))
        scale = max(w.abs().max().item() for w in want)
        errs[name] = err
        if not (len(got) == len(want) and err <= 1e-4 + 1e-4 * scale):
            raise AssertionError(f"{name}: card vs cpu max err {err} "
                                 f"(scale {scale})")
        del model
    x = torch.randn((1, 2) + PATCH_3D, generator=gen)
    grid = torch.rand((1,) + PATCH_3D + (3,), generator=gen) * 2.4 - 1.2
    for mode in ("zeros", "border"):
        want = grid_sample_3d(x, grid, padding_mode=mode)
        got = grid_sample_3d(x.to(device), grid.to(device),
                             padding_mode=mode).cpu()
        errs[f"grid_sample_3d_{mode}"] = (got - want).abs().max().item()
        if not errs[f"grid_sample_3d_{mode}"] <= 1e-5:
            raise AssertionError(f"grid_sample_3d {mode}: card vs cpu "
                                 f"{errs[f'grid_sample_3d_{mode}']}")
    _log(f"rest of the zoo card vs cpu (eval, f32): max err {errs}")
    torch.cuda.empty_cache()
    return errs


def _timed_forwards(device, name, model, xs, shape_note):
    """Two train-mode forwards + backwards of the mean square of every
    output and two eval forwards, bf16 autocast; ms of each call and the
    peak memory."""
    import torch
    model = model.to(device).train()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms = []
    for _ in range(2):          # the first call selects cuDNN's algorithms
        model.zero_grad(set_to_none=True)
        t0 = time.perf_counter()
        with torch.autocast(device.type, dtype=torch.bfloat16):
            loss = sum(o.float().square().mean()
                       for o in _flat(model(*xs)))
        loss.backward()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    if not (math.isfinite(float(loss.detach())) and all(
            p.grad is not None and bool(torch.isfinite(p.grad).all())
            for p in model.parameters() if p.requires_grad)):
        raise AssertionError(f"{name}: non-finite loss or gradients")
    model.eval()
    eval_ms = []
    for _ in range(2):          # the first no-grad call has its own set-up
        t0 = time.perf_counter()
        with torch.no_grad(), torch.autocast(device.type,
                                             dtype=torch.bfloat16):
            out = _flat(model(*xs))
        torch.cuda.synchronize()
        eval_ms.append((time.perf_counter() - t0) * 1e3)
    if not all(bool(torch.isfinite(o).all()) for o in out):
        raise AssertionError(f"{name}: non-finite eval outputs")
    peak = torch.cuda.max_memory_allocated() / 2**30
    _log(f"{name} at {shape_note} bf16: forward + backward "
         f"{[round(t, 2) for t in ms]} ms, eval forward "
         f"{[round(t, 2) for t in eval_ms]} ms (two calls each), peak "
         f"{peak:.2f} GiB")
    return {"fwd_bwd_ms": ms, "eval_ms": eval_ms, "peak_gib": peak,
            "params": sum(p.numel() for p in model.parameters())}


def _rest_timing(device):
    """(b) At a user's shapes: nnU-Net 2D at 256², 1 channel, 4 classes, bs
    4; nnU-Net 3D at 128x128x80, 2 classes, bs 2; VoxResNet at 112x112x80,
    bs 2; ResnetGenerator (9 blocks) and NLayerDiscriminator at 256², 3
    channels, bs 4; VGG19Features at 224², bs 4."""
    import torch
    from arco_torch.models import gan, net_factory, net_factory_3d, vgg
    gen = torch.Generator(device=device).manual_seed(12)
    cases = {
        "nnUNet_2d": (lambda: net_factory("nnUNet", class_num=4),
                      (ZOO_BS, 1, ZOO_HW, ZOO_HW)),
        "nnUNet_3d": (lambda: net_factory_3d("nnUNet", class_num=2),
                      (2, 1) + NN3D_PATCH),
        "voxresnet": (lambda: net_factory_3d("voxresnet", class_num=2),
                      (2, 1) + PATCH_3D),
        "resnet_generator": (lambda: gan.define_g(3, 3, 64,
                                                  "resnet_9blocks"),
                             (ZOO_BS, 3, ZOO_HW, ZOO_HW)),
        "nlayer_discriminator": (lambda: gan.define_d(3, 64, "basic"),
                                 (ZOO_BS, 3, ZOO_HW, ZOO_HW)),
        "vgg19_features": (lambda: vgg.VGG19Features(),
                           (ZOO_BS, 3, VGG_HW, VGG_HW)),
    }
    out = {}
    for name, (build, shape) in cases.items():
        torch.manual_seed(0)
        x = torch.randn(shape, generator=gen, device=device)
        out[name] = _timed_forwards(device, name, build(), [x],
                                    list(shape))
        torch.cuda.empty_cache()
    return out


def _busy_predictor(model, device, events):
    """test_3d's softmax predictor under bf16 autocast, with a CUDA event
    pair around each forward."""
    import torch

    def predict(b):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        with torch.no_grad(), torch.autocast(device.type,
                                             dtype=torch.bfloat16):
            p = torch.softmax(model(b)[0].float(), dim=1)
        end.record()
        events.append((start, end))
        return p
    return predict


def _rest_tiled(device):
    """(c) predict_tiled with nnU-Net 3D over one 128x128x96 volume (patch
    128x128x80, 8 mirror combinations) and predict_3d_via_2d with nnU-Net
    2D over one 256x256 volume of VIA2D_SLICES slices (4 combinations);
    each case twice (the first selects cuDNN's algorithms): seconds a case
    and the share of it between the forwards' CUDA events."""
    import numpy as np
    import torch
    from arco_torch.data.synthetic import la_volume, make_volume
    from arco_torch.eval.tiled_predictor import (predict_3d_via_2d,
                                                 predict_tiled)
    from arco_torch.models import net_factory, net_factory_3d
    rng = np.random.RandomState(13)
    volume = la_volume(rng, NN3D_VOLUME)[0]
    slices = make_volume(rng, (ZOO_HW, ZOO_HW), 4, VIA2D_SLICES)[0].astype(
        np.float32)
    out = {}
    for name, k, run in (
            ("predict_tiled_nnUNet_3d", 2, lambda p: predict_tiled(
                p, volume, NN3D_PATCH, 2, device=device)),
            ("predict_3d_via_2d_nnUNet_2d", 4, lambda p: predict_3d_via_2d(
                p, slices, (ZOO_HW, ZOO_HW), 4, device=device))):
        torch.manual_seed(0)
        model = (net_factory_3d("nnUNet", class_num=2) if k == 2 else
                 net_factory("nnUNet", class_num=4)).to(device).eval()
        secs, busy = [], []
        for _ in range(2):
            events = []
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            labels, scores = run(_busy_predictor(model, device, events))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            secs.append(wall)
            busy.append(sum(s.elapsed_time(e) for s, e in events) / 1e3
                        / wall)
        total = scores.sum(0)
        if not (bool(torch.isfinite(scores).all())
                and float((total - 1).abs().max()) < 1e-3
                and labels.shape == tuple(scores.shape[1:])
                and labels.min() >= 0 and labels.max() < k):
            raise AssertionError(f"{name}: scores or labels out of range")
        out[name] = {"s_per_case": secs, "busy_share": busy,
                     "forwards": len(events)}
        _log(f"{name}: {[round(t, 3) for t in secs]} s a case, card busy "
             f"{[round(b, 3) for b in busy]} of it, {len(events)} "
             "forwards")
        del model
        torch.cuda.empty_cache()
    return out


def _pretrain_rows(snap):
    rows = [json.loads(line) for line in
            (Path(snap) / "metrics.jsonl").read_text().splitlines()]
    if len(rows) != 2 or not all(math.isfinite(r[k]) for r in rows
                                 for k in ("loss", "loss_latent",
                                           "loss_output")):
        raise AssertionError(f"{snap}: metrics {rows}")
    return [r["loss"] for r in rows]


def _rest_clis(device, workdir, root, vols):
    """(d) test_2d's path (evaluate_2d through its predictor) of nnUNet
    from a saved checkpoint; test_3d --model nnUNet --patch_size 128 128
    80 and --model voxresnet on one 128x128x96 volume from saved
    checkpoints; 2 steps of pretrain_2d (nnUNet) and pretrain_3d (nnUNet,
    voxresnet), the keys JAX's stage-1 CLIs take. No kernel launches."""
    import contextlib
    import io
    import numpy as np
    import torch
    from arco_torch.cli import pretrain_2d, pretrain_3d, test_3d
    from arco_torch.data.datasets import InMemoryVolumes, SynapseDataset
    from arco_torch.data.synthetic import make_volume
    from arco_torch.models import net_factory, net_factory_3d
    from arco_torch.train import checkpoint as ckpt
    model_dir = workdir / "rest"
    out = {}
    rng = np.random.RandomState(14)
    volumes = {f"vol{i}": make_volume(rng, (ZOO_HW, ZOO_HW), 4, CLI_DEPTH)
               for i in range(CLI_VOLUMES)}
    torch.manual_seed(0)
    out["test_2d_nnUNet"] = _zoo_eval(
        device, str(model_dir / "nnUNet_2d"), "nnUNet", volumes,
        net_factory("nnUNet", class_num=4).state_dict())

    for key, patch in (("nnUNet", NN3D_PATCH), ("voxresnet", PATCH_3D)):
        snap = model_dir / f"LA/eval_{CLI3D_LABELED}_labeledfinal" / key
        torch.manual_seed(0)
        ckpt._save(ckpt._path(str(snap), 1), {
            "step": 1, "model": net_factory_3d(key).state_dict()})
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            res = test_3d.main([
                "--exp", "LA/eval", "--model", key, "--labeled_num",
                str(CLI3D_LABELED), "--snapshot_dir", str(model_dir),
                "--patch_size", *map(str, patch), "--device", device.type],
                dataset=InMemoryVolumes(vols[:1], patch))
        eval_s = time.perf_counter() - t0
        m = res["per_class"][0]
        if not (np.isfinite(res["raw"]).all() and 0 <= m[0] <= 1
                and 0 <= m[1] <= 1 and (m[2:] >= 0).all()):
            raise AssertionError(f"test_3d {key}: eval gave {m}")
        out[f"test_3d_{key}"] = {"s": eval_s, "per_class": m.tolist()}
        _log(f"test_3d --model {key} --patch_size {patch} on one "
             f"{CLI3D_SIZE} volume in {eval_s:.2f} s: (dice, jc, hd95, asd) "
             f"{m.tolist()}")

    common = ["--labeled_num", "1", "--snapshot_dir", str(model_dir),
              "--log_every", "1", "--ckpt_every", "2", "--max_iterations",
              "2"]
    cfg, snap = pretrain_2d.parse(common + ["--root_path", root, "--exp",
                                            "Synapse/rest", "--model",
                                            "nnUNet"])
    pretrain_2d.train(cfg, snap, dataset=SynapseDataset(
        root, root, "train", output_size=cfg.data.patch_size))
    out["pretrain_2d_nnUNet"] = _pretrain_rows(snap)
    for key, patch in (("nnUNet", NN3D_PATCH), ("voxresnet", PATCH_3D)):
        cfg, snap = pretrain_3d.parse([
            "--exp", "LA/rest", "--model", key, "--labeled_num",
            str(CLI3D_LABELED), "--snapshot_dir", str(model_dir),
            "--patch_size", *map(str, patch), "--max_iterations", "2",
            "--log_every", "1", "--ckpt_every", "2"])
        pretrain_3d.train(cfg, snap, dataset=InMemoryVolumes(vols, patch))
        out[f"pretrain_3d_{key}"] = _pretrain_rows(snap)
    _log(f"rest of the zoo CLIs: pretrain losses "
         f"{ {k: v for k, v in out.items() if k.startswith('pretrain')} }")
    return out


def phase_rest(device, workdir, root, vols):
    """Phase 11, the rest of the zoo: (a) card vs CPU; (b) timing at a
    user's shapes; (c) the tiled predictor; (d) the CLIs. The path runs no
    kernel, so every launch count stays 0."""
    import torch
    from arco_torch.kernels import launch_counts, reset_launch_counts
    t_start = time.perf_counter()
    reset_launch_counts()
    out = {"card_vs_cpu_err": _rest_card_vs_cpu(device),
           "timing": _rest_timing(device), "tiled": _rest_tiled(device),
           "cli": _rest_clis(device, workdir, root, vols)}
    torch.cuda.synchronize()
    if any(launch_counts().values()):
        raise AssertionError(f"phase 11 launched kernels: {launch_counts()}")
    out["s"] = time.perf_counter() - t_start
    _log(f"phase 11 (rest of the zoo) in {out['s']:.1f} s")
    return out


# phase 12: the natural-image branch (train_arco_natural at its defaults
# on Pascal: DeepLab-v2 / ResNet-101, 321x321 crops, 21 classes, bs 4 + 4,
# 256-channel reps fused from the four ResNet maps fine -> coarse)
NAT_CLASSES, NAT_C, NAT_CROP, NAT_BS = 21, 256, 321, 4
NAT_CAPS = (50000,) + (30000,) * (NAT_CLASSES - 1)
NAT_UNET_CROP = 320
# the synthetic VOC tree: VOC-sized images, every class in train and val
NAT_TRAIN, NAT_VAL, NAT_LABEL_NUM = 24, 4, 2
NAT_STEPS, NAT_OTHER_STEPS = 4, 2


def phase_kernels_natural(device):
    """(a) The three kernels at the natural path's shapes against their
    plain versions: the InfoNCE pair over full 21-class banks at 'smc'
    draws with C = 256 (DeepLab) and C = 496 (the 3-channel U-Net);
    pool_sims on 2 * 4 query rows of DeepLab-v2's F = 41 * 41 * 256,
    DeepLab-v3+'s 21 * 21 * 256 and the U-Net's 320 * 320 * 496 (with
    torch.matmul timed beside it)."""
    import torch
    gen = torch.Generator(device=device).manual_seed(12)
    out = {}
    for c in (NAT_C, C):
        per_draw = _infonce_draws(gen, device, NAT_CAPS, c, (MAIN_DRAW,))
        for name, rec in per_draw.items():
            out.setdefault(name, {})[f"C{c}"] = {**rec[MAIN_DRAW],
                                                 "library_ms": None}
    rep_hw = {"deeplabv2": 41, "deeplabv3": 21, "unet": NAT_UNET_CROP}
    out["pool_sims"] = {}
    for model, hw in rep_hw.items():
        f = hw * hw * (C if model == "unet" else NAT_C)
        out["pool_sims"][model] = {"F": f, **_pool_sims_at(
            gen, device, 2 * NAT_BS, f)}
    return out


def _natural_batch(b, hw, gen, device, num_classes):
    """phase 4's label discs and an RGB image that follows them."""
    import torch
    image, label = _synthetic_batch(b, hw, gen, device, num_classes)
    tint = torch.tensor([0.2, 0.5, 0.8], device=device).view(1, 3, 1, 1)
    noise = 0.1 * torch.randn((b, 3, hw, hw), generator=gen, device=device)
    return image * tint + noise, label


def _natural_reference(device):
    """(b) One small natural step (DeepLab-v2, one block a layer, 65x65,
    4 classes, bs 2+2, BatchNorm affine frozen, photometric and AdvMorph
    on) on the card in bf16 with the kernels against the same step on the
    CPU in f32 with the plain versions: the same weights, pool, batch and
    draws; phase 4's tolerance per loss term."""
    import torch
    from arco_torch.config import ArcoConfig
    from arco_torch.models.deeplab import DeepLabV2
    from arco_torch.train import arco2d
    from arco_torch.train.freeze import apply_deeplab_bn_freeze
    from arco_torch.train.schedule import make_optimizer
    hw, b, nc = 65, 2, 4
    cfg = ArcoConfig(K=4, num_queries=32, num_negatives=64,
                     memobank_size=256, memobank_size_bg=512,
                     memobank_enqueue=64, topk=2)
    runs = []
    for dev, dtype in (("cpu", torch.float32), (device, torch.bfloat16)):
        torch.manual_seed(1)
        mods = arco2d.make_arco_modules(
            DeepLabV2(nc, (1, 1, 1, 1)), hw, hw, batch_size=b,
            feature_channels=(256, 512, 1024, 2048), fused_dim=NAT_C)
        state = arco2d.init_arco_state(mods, cfg, (b, 3, hw, hw), seed=1,
                                       device=dev, compute_dtype=dtype)
        state.optimizer = make_optimizer(
            apply_deeplab_bn_freeze(state.model)
            + list(state.feature_extractor.parameters())
            + list(state.q_representation.parameters()), 0.01)
        runs.append((state, arco2d.make_arco_step(
            mods, cfg, num_classes=nc, max_iterations=100, device=dev)))
    (ref_state, ref_step), (state, step) = runs
    state.random_pool.copy_(ref_state.random_pool)
    gen = torch.Generator().manual_seed(2)
    image_l, label_l = _natural_batch(b, hw, gen, "cpu", nc)
    image_u, _ = _natural_batch(b, hw, gen, "cpu", nc)
    batch = {"image_l": image_l, "label_l": label_l, "image_u": image_u}
    draws = _draws(cfg, b, b, hw, nc, gen)
    want = ref_step(ref_state, batch, draws)
    got = step(state, _to(batch, device), _to(draws, device))
    out = {}
    for k in ("loss", "reco_loss", "loss_q", "unsup_loss", "loss_ce",
              "loss_dice", "loss_eqv"):
        g, w = float(got[k]), float(want[k])
        out[k] = (g, w)
        _log(f"  reference (natural) {k}: card {g:.6f} cpu {w:.6f}")
        if not abs(g - w) <= 2e-2 + 5e-2 * abs(w):
            raise AssertionError(f"natural {k}: card {g} vs cpu {w}")
    return out


@contextlib.contextmanager
def _timed_natural_steps(times):
    """Wrap the natural CLI's step so each step's time, between two
    synchronizations, lands in ``times`` (ms)."""
    import torch
    from arco_torch.cli import train_arco_natural
    real = train_arco_natural.make_arco_step

    def make(*args, **kwargs):
        step = real(*args, **kwargs)

        def timed(state, batch, draws=None):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            metrics = step(state, batch, draws)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            return metrics
        return timed
    train_arco_natural.make_arco_step = make
    try:
        yield
    finally:
        train_arco_natural.make_arco_step = real


def _natural_run(argv, steps, label):
    """train_arco_natural.main(argv) for ``steps`` steps: its run
    directory, per-step ms, the metrics rows, peak GiB and the launches;
    every loss finite and each kernel launched once a step."""
    import torch
    from arco_torch.cli import train_arco_natural
    from arco_torch.kernels import launch_counts, reset_launch_counts
    times = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    with _timed_natural_steps(times):
        run = train_arco_natural.main(argv + ["--max_iterations",
                                              str(steps)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    rows = [json.loads(line)
            for line in (Path(run) / "metrics.jsonl").read_text()
            .splitlines()]
    if not rows or not all(math.isfinite(v) for r in rows
                           for v in r.values()):
        raise AssertionError(f"{label}: metrics {rows}")
    _check_launches(f"{label}, {steps} steps", counts, steps)
    ips = [r["images_per_sec"] for r in rows]
    _log(f"{label}: {steps} steps in {wall:.1f} s (set-up included); step "
         f"ms {[round(t, 2) for t in times]}; img/s per log interval "
         f"{[round(v, 2) for v in ips]}; peak {peak:.2f} GiB; losses "
         f"{[round(r['loss'], 4) for r in rows]}; launches {counts}")
    return Path(run), {"step_ms": times, "images_per_sec": ips,
                       "peak_gib": peak, "wall_s": wall,
                       "losses": [r["loss"] for r in rows]}, counts


def _restore_check():
    """Wrap load_torch_checkpoint so the load that --restore_from makes is
    checked in place: afterwards the trunk equals the file and the
    classifier, of another class count, keeps its initialization."""
    import torch
    from arco_torch.compat import torch_import
    real = torch_import.load_torch_checkpoint
    seen = {}

    def checked(model, p):
        before = {k: v.clone() for k, v in model.state_dict().items()}
        copied = real(model, p)
        sd = torch.load(p, map_location="cpu", weights_only=True)
        after = model.state_dict()
        for k, v in after.items():
            if k.endswith("num_batches_tracked"):
                continue
            if k.startswith("layer5"):
                ok = torch.equal(v, before[k])
            else:
                ok = torch.equal(v.cpu(), sd[f"module.{k}"])
            if not ok:
                raise AssertionError(f"restore: {k} is not as expected")
        seen["copied"] = len(copied)
        return copied
    torch_import.load_torch_checkpoint = checked
    return seen, lambda: setattr(torch_import, "load_torch_checkpoint", real)


def phase_natural(device, workdir):
    """Phase 12, the natural-image branch: (a) the kernels at its shapes;
    (b) a small step on the card against the CPU; (c) train_arco_natural
    at its defaults (DeepLab-v2 / ResNet-101, Pascal, 321x321, bs 4+4, 21
    classes, bf16) on a synthetic VOC tree, 4 steps logging and
    checkpointing every 2; (d) 2 steps of --model deeplabv3 and of --model
    unet (--crop_size 320: its skip connections need a crop divisible by
    16); (e) --resume_snapshot from (c)'s iter_4, 2 steps; (f)
    --restore_from a module.-prefixed state dict of the phase's own
    DeepLab-v2, checked right after the load, 2 steps; (g) eval_natural of
    (c)'s iter_4 on the val images."""
    import io
    import torch
    from arco_torch.cli import eval_natural
    from arco_torch.data.synthetic import make_pascal_like
    from arco_torch.models.deeplab import DeepLabV2
    t_start = time.perf_counter()
    out = {"kernels": phase_kernels_natural(device),
           "reference": _natural_reference(device)}
    root = make_pascal_like(str(workdir / "pascal"), NAT_TRAIN, NAT_VAL)
    model_dir = str(workdir / "natural")
    common = ["--root_path", root, "--dataset", "pascal", "--label_num",
              str(NAT_LABEL_NUM), "--snapshot_dir", model_dir]
    cli = common + ["--log_every", "2", "--ckpt_every", "2"]

    run, out["deeplabv2"], counts = _natural_run(
        cli + ["--exp", "natural/v2", "--model", "deeplabv2"], NAT_STEPS,
        "train_arco_natural deeplabv2")
    if not all((run / d).is_dir() for d in ("iter_2", "iter_4",
                                            "full_iter_4")):
        raise AssertionError(f"deeplabv2: checkpoints {os.listdir(run)}")
    other = {}
    for model, extra in (("deeplabv3", []),
                         ("unet", ["--crop_size", str(NAT_UNET_CROP)])):
        _, other[model], _ = _natural_run(
            cli + ["--exp", f"natural/{model}", "--model", model] + extra,
            NAT_OTHER_STEPS, f"train_arco_natural {model}")
    out.update(other)

    handoff, out["resume_snapshot"], _ = _natural_run(
        cli + ["--exp", "natural/handoff", "--model", "deeplabv2",
               "--resume_snapshot", str(run)], NAT_OTHER_STEPS,
        "train_arco_natural --resume_snapshot")
    if f"initialized model from {run} iter_{NAT_STEPS}" not in \
            (handoff / "log.txt").read_text():
        raise AssertionError("--resume_snapshot: no handoff in log.txt")

    torch.manual_seed(5)
    trunk = workdir / "trunk.pth"
    torch.save({f"module.{k}": v for k, v in
                DeepLabV2(7, (3, 4, 23, 3)).state_dict().items()}, trunk)
    seen, undo = _restore_check()
    try:
        _, out["restore_from"], _ = _natural_run(
            cli + ["--exp", "natural/restore", "--model", "deeplabv2",
                   "--restore_from", str(trunk)], NAT_OTHER_STEPS,
            "train_arco_natural --restore_from")
    finally:
        undo()
    if not seen.get("copied"):
        raise AssertionError("--restore_from: the load was not made")
    out["restore_from"]["tensors_copied"] = seen["copied"]

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        res = eval_natural.main(common + ["--exp", "natural/v2", "--model",
                                          "deeplabv2"])
    eval_s = time.perf_counter() - t0
    line = json.loads(buf.getvalue().strip().splitlines()[-1])
    if set(line) != {"iteration", "miou", "per_class_iou"} \
            or line["iteration"] != NAT_STEPS \
            or len(line["per_class_iou"]) != NAT_CLASSES \
            or not 0.0 <= res["miou"] <= 1.0:
        raise AssertionError(f"eval_natural printed {line}")
    out["eval"] = {"miou": res["miou"], "s": eval_s}
    _log(f"eval_natural of iter_{NAT_STEPS} on {NAT_VAL} val images in "
         f"{eval_s:.2f} s: mIoU {res['miou']:.4f}")
    out["s"] = time.perf_counter() - t_start
    _log(f"phase 12 (natural) in {out['s']:.1f} s")
    return counts, out


# phase 13: --pretrained_path (compat/pretrained.py) on the ViT_Seg stage 1
VIT_WIDTH = dict(hidden=768, mlp=3072, heads=12, layers=12)


def _vit_npz(path, seed=13):
    """A synthetic R50+ViT-B_16 .npz from a seed: the reference's key names
    and shapes at the model's width (the R50 stem of units 3/4/9, hidden
    768, 12 heads, MLP 3072, 12 blocks, a 14x14 + class-token position
    embedding)."""
    import numpy as np
    rs = np.random.RandomState(seed)
    hid, mlp, heads, layers = (VIT_WIDTH[k] for k in
                               ("hidden", "mlp", "heads", "layers"))
    rand = lambda *shape: (0.02 * rs.randn(*shape)).astype(np.float32)
    near1 = lambda *shape: (1 + 0.1 * rs.randn(*shape)).astype(np.float32)
    w = {"conv_root/kernel": rand(7, 7, 3, 64),
         "gn_root/scale": near1(64), "gn_root/bias": rand(64),
         "embedding/kernel": rand(1, 1, 1024, hid),
         "embedding/bias": rand(hid),
         "Transformer/encoder_norm/scale": near1(hid),
         "Transformer/encoder_norm/bias": rand(hid),
         "Transformer/posembed_input/pos_embedding": rand(1, 197, hid)}
    cin = 64
    for stage, (n_units, cout) in enumerate(zip((3, 4, 9),
                                                (256, 512, 1024))):
        cmid = cout // 4
        for u in range(1, n_units + 1):
            pre = f"block{stage + 1}/unit{u}/"
            w[pre + "conv1/kernel"] = rand(1, 1, cin, cmid)
            w[pre + "conv2/kernel"] = rand(3, 3, cmid, cmid)
            w[pre + "conv3/kernel"] = rand(1, 1, cmid, cout)
            gns = [("gn1", cmid), ("gn2", cmid), ("gn3", cout)]
            if u == 1:
                w[pre + "conv_proj/kernel"] = rand(1, 1, cin, cout)
                gns.append(("gn_proj", cout))
            for g, ch in gns:
                w[pre + f"{g}/scale"] = near1(1, 1, ch)
                w[pre + f"{g}/bias"] = rand(1, 1, ch)
            cin = cout
    for i in range(layers):
        pre = f"Transformer/encoderblock_{i}/"
        att = pre + "MultiHeadDotProductAttention_1/"
        for name in ("query", "key", "value"):
            w[att + f"{name}/kernel"] = rand(hid, heads, hid // heads)
            w[att + f"{name}/bias"] = rand(heads, hid // heads)
        w[att + "out/kernel"] = rand(heads, hid // heads, hid)
        w[att + "out/bias"] = rand(hid)
        for ln in ("LayerNorm_0", "LayerNorm_2"):
            w[pre + f"{ln}/scale"] = near1(hid)
            w[pre + f"{ln}/bias"] = rand(hid)
        w[pre + "MlpBlock_3/Dense_0/kernel"] = rand(hid, mlp)
        w[pre + "MlpBlock_3/Dense_0/bias"] = rand(mlp)
        w[pre + "MlpBlock_3/Dense_1/kernel"] = rand(mlp, hid)
        w[pre + "MlpBlock_3/Dense_1/bias"] = rand(hid)
    np.savez(path, **w)
    return w


def phase_pretrained(device, workdir, root):
    """Phase 13, ``--pretrained_path``: ``pretrain_2d --model ViT_Seg`` at
    its defaults (256x256, the full R50+ViT-B_16) from a synthetic .npz of
    the reference's names and shapes, 2 steps on phase 6's tree. The
    weights in the model right after the load must equal the converter's
    output, every loss must be finite, and no kernel launches (stage 1
    reaches none)."""
    import torch
    from arco_torch.cli import pretrain_2d
    from arco_torch.compat.pretrained import convert_vit_npz
    from arco_torch.data.datasets import SynapseDataset
    from arco_torch.kernels import launch_counts, reset_launch_counts
    t_start = time.perf_counter()
    npz = workdir / "R50+ViT-B_16.npz"
    w = _vit_npz(npz)
    cfg, snap = pretrain_2d.parse([
        "--root_path", root, "--labeled_num", "1", "--snapshot_dir",
        str(workdir / "pretrained"), "--log_every", "1", "--ckpt_every",
        "2", "--exp", "Synapse/vit_pre", "--model", "ViT_Seg",
        "--pretrained_path", str(npz), "--max_iterations", "2"])
    loaded = {}
    load = pretrain_2d.load_pretrained

    def checked(model, path, module):
        names = load(model, path, module)
        sd = module.state_dict()
        loaded.update({k: sd[k].detach().clone() for k in names})
        loaded["n_tokens"] = int(module.pos_embedding.shape[1])
        return names
    pretrain_2d.load_pretrained = checked
    reset_launch_counts()
    try:
        pretrain_2d.train(cfg, snap, dataset=SynapseDataset(
            root, root, "train", output_size=cfg.data.patch_size))
    finally:
        pretrain_2d.load_pretrained = load
    torch.cuda.synchronize()
    if any(launch_counts().values()):
        raise AssertionError(f"pretrained: kernels launched "
                             f"{launch_counts()}")
    want = convert_vit_npz(w, loaded.pop("n_tokens"))
    if sorted(loaded) != sorted(want):
        raise AssertionError("pretrained: loaded other tensors than the "
                             "converter gives")
    bad = [k for k, v in want.items() if not torch.equal(loaded[k], v)]
    if bad:
        raise AssertionError(f"pretrained: {len(bad)} tensors differ from "
                             f"the file, e.g. {bad[:3]}")
    rows = [json.loads(line) for line in
            (Path(snap) / "metrics.jsonl").read_text().splitlines()]
    if len(rows) != 2 or not all(math.isfinite(r[k]) for r in rows
                                 for k in ("loss", "loss_latent",
                                           "loss_output")):
        raise AssertionError(f"pretrained: metrics {rows}")
    if "loaded pretrained backbone" not in (Path(snap) / "log.txt") \
            .read_text():
        raise AssertionError("pretrained: the log does not say it loaded")
    out = {"tensors_loaded": len(want),
           "values_loaded": sum(v.numel() for v in want.values()),
           "losses": [r["loss"] for r in rows],
           "s": time.perf_counter() - t_start}
    _log(f"pretrain_2d --model ViT_Seg --pretrained_path: {len(want)} "
         f"tensors ({out['values_loaded']} values) equal to the file, "
         f"losses {[round(v, 4) for v in out['losses']]}; phase 13 in "
         f"{out['s']:.1f} s")
    return out


# phase 14: the serving surface (train/supervised.py, utils/profiling.py,
# inference.py with the sharded forward, export.py, cli/test_synapse.py,
# cli/export_model.py, repro.py) at full width; no kernel on its path
SUP_HW, SUP_CLASSES, SUP_BS, SUP_STEPS = 256, 4, 4, 5
# card vs CPU, both f32 with TF32 off: the losses agree to ~7 digits and the
# weights after one step within ~1e-7, so these bounds leave ~100x headroom
# and fail a step computed in bf16 or a wrong update
SUP_RTOL, SUP_W_ATOL = 1e-5, 1e-5
SYN_CLASSES, SERVE_DEPTH, LA_CASE = 8, 12, (144, 144, 88)


def _supervised(device, hw, bs, nc, seed=0, dev=None):
    """A seeded U-Net's supervised state and step on ``dev``, a seeded
    batch and dropout masks (made on the CPU)."""
    import torch
    from arco_torch.models import net_factory
    from arco_torch.train.supervised import (PolySGD, init_supervised_state,
                                             make_supervised_step)
    torch.manual_seed(seed)
    model = net_factory("unet", in_chns=1, class_num=nc)
    gen = torch.Generator().manual_seed(seed + 1)
    image, label = _synthetic_batch(bs, hw, gen, "cpu", num_classes=nc)
    masks = model.train().draw_dropout_masks(image.shape, gen)
    tx = PolySGD(0.01, 100)
    state = init_supervised_state(model, tx, seed=seed, device=dev or device)
    step = make_supervised_step(model, tx, nc)
    return state, step, {"image": image, "label": label}, masks


def _serving_supervised(device):
    """(a) one small supervised step on the card against the CPU (same
    weights, batch and dropout masks; f32, TF32 off): the losses within
    rtol SUP_RTOL and every weight after the update within SUP_W_ATOL,
    then SUP_STEPS full-width steps through step_timer."""
    import torch
    from arco_torch.utils.profiling import step_timer
    got, want = {}, {}
    for dev, rec in ((device, got), (torch.device("cpu"), want)):
        state, step, batch, masks = _supervised(device, 64, 2, SUP_CLASSES,
                                                dev=dev)
        _, m = step(state, _to(batch, dev), _to(masks, dev))
        rec.update({k: float(v) for k, v in m.items()})
        rec["weights"] = {k: v.detach().cpu() for k, v in
                          state.model.state_dict().items()}
    w_err = max((got["weights"][k].double() - v.double()).abs().max().item()
                for k, v in want["weights"].items() if v.is_floating_point())
    for k in ("loss", "loss_ce", "loss_dice"):
        _log(f"  supervised step {k}: card {got[k]:.6f} cpu {want[k]:.6f}")
        if not abs(got[k] - want[k]) <= SUP_RTOL * abs(want[k]):
            raise AssertionError(f"supervised {k}: card {got[k]} vs cpu "
                                 f"{want[k]} (rtol {SUP_RTOL})")
    if not w_err <= SUP_W_ATOL:
        raise AssertionError(f"supervised: card vs cpu weights differ by "
                             f"{w_err} after the step (> {SUP_W_ATOL})")
    state, step, batch, _ = _supervised(device, SUP_HW, SUP_BS, SUP_CLASSES)
    batch = _to(batch, device)
    torch.cuda.reset_peak_memory_stats()
    secs, state = step_timer(step, state, batch, n=SUP_STEPS, warmup=2)
    _, m = step(state, batch)
    if not all(math.isfinite(float(v)) for v in m.values()) \
            or state.step != SUP_STEPS + 3:
        raise AssertionError(f"supervised: step {state.step}, metrics {m}")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    _log(f"supervised U-Net {SUP_HW}^2 bs {SUP_BS}: {secs * 1e3:.2f} ms a "
         f"step (step_timer, {SUP_STEPS} steps after 2), peak {peak:.2f} "
         f"GiB; card vs cpu max weight diff {w_err:.3e}")
    return {"card_vs_cpu": {k: [got[k], want[k]] for k in
                            ("loss", "loss_ce", "loss_dice")},
            "card_vs_cpu_weight_err": w_err, "step_ms": secs * 1e3,
            "peak_gib": peak,
            "final_loss": {k: float(v) for k, v in m.items()}}, \
        (state, step, batch)


def _serving_timers(device, workdir, sup):
    """(b) measure_fp_time / measure_fp_bp_time of the U-Net at bs
    SUP_BS, and trace() around two supervised steps: the Chrome trace must
    hold CUDA kernel events."""
    import torch
    import torch.nn.functional as F
    from arco_torch.utils.profiling import (measure_fp_bp_time,
                                            measure_fp_time, trace)
    state, step, batch = sup
    model, x = state.model, batch["image"]
    model.eval()
    fp = measure_fp_time(lambda v: model(v), x, n=10, warmup=3)
    model.train()
    fp_bp = measure_fp_bp_time(
        lambda m, v: F.cross_entropy(m(v)[0].float(), batch["label"].long()),
        model, x, n=10, warmup=3)
    log_dir = workdir / "trace"
    with trace(str(log_dir)):
        for _ in range(2):
            state, _ = step(state, batch)
        torch.cuda.synchronize()
    files = list(log_dir.glob("*.pt.trace.json"))
    if len(files) != 1:
        raise AssertionError(f"trace: files {files}")
    events = json.loads(files[0].read_text())["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    if not kernels:
        raise AssertionError("trace: no CUDA kernel events")
    start = min(e["ts"] for e in kernels)
    end = max(e["ts"] + e.get("dur", 0) for e in kernels)
    busy = sum(e.get("dur", 0) for e in kernels)
    out = {"fp_ms": fp * 1e3, "fp_bp_ms": fp_bp * 1e3,
           "trace_kernel_events": len(kernels),
           "trace_kernel_us": busy, "trace_span_us": end - start}
    _log(f"U-Net {SUP_HW}^2 bs {SUP_BS}: forward {out['fp_ms']:.3f} ms, "
         f"forward + backward {out['fp_bp_ms']:.3f} ms (CUDA events); "
         f"trace of 2 steps: {len(kernels)} kernel events, "
         f"{busy / 1e3:.2f} ms of kernels over a "
         f"{out['trace_span_us'] / 1e3:.2f} ms span")
    return out


def _serving_segmenters(device, workdir):
    """(c) Segmenter from phase 6's iter_6 on an in-memory volume, equal to
    eval/slice2d's path; (e) Segmenter3D from phase 8d's iter_6 on an
    LA-sized volume, equal to the sliding window called directly."""
    import numpy as np
    import torch
    from arco_torch.data.synthetic import la_volume, make_volume
    from arco_torch.eval import sliding_window
    from arco_torch.eval.slice2d import model_predictor, \
        test_single_volume_2d
    from arco_torch.eval.sliding_window_device import \
        test_single_case_3d_device
    from arco_torch.inference import Segmenter, Segmenter3D
    from arco_torch.models import net_factory
    from arco_torch.train import checkpoint as ckpt
    snap = str(workdir / "model" / "Synapse/smoke_1_labeledfinal" / "unet")
    image, _ = make_volume(np.random.RandomState(3), (224, 240), 4,
                           SERVE_DEPTH)
    seg = Segmenter.from_snapshot(snap, iteration=6, device=device)
    seg.predict_volume(image[:2])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pred = seg.predict_volume(image)
    seg_s = time.perf_counter() - t0
    model = net_factory("unet", in_chns=1, class_num=4).to(device)
    model.load_state_dict(ckpt.load_model_params(snap, 6))
    _, want = test_single_volume_2d(image, np.zeros(image.shape, np.int64),
                                    model_predictor(model, device), 4)
    if pred.shape != image.shape or not np.array_equal(pred, want):
        raise AssertionError("Segmenter differs from eval/slice2d's path")

    snap3 = str(workdir / "model3d" /
                f"LA/smoke_{CLI3D_LABELED}_labeledfinal" / "vnet")
    vol, _ = la_volume(np.random.RandomState(4), LA_CASE)
    seg3 = Segmenter3D.from_snapshot(snap3, iteration=6, device=device,
                                     patch_size=PATCH_3D)
    seg3.predict_volume(vol)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pred3 = seg3.predict_volume(vol)
    seg3_s = time.perf_counter() - t0
    want3, _ = test_single_case_3d_device(
        sliding_window.model_predictor(seg3.model, device), vol, 18, 4,
        PATCH_3D, 2, device=device)
    if pred3.shape != vol.shape or not np.array_equal(pred3, want3):
        raise AssertionError("Segmenter3D differs from the sliding window")
    _log(f"Segmenter (iter_6, {SERVE_DEPTH}x224x240 in-memory volume): "
         f"{seg_s:.3f} s a case, labels equal to eval/slice2d's; "
         f"Segmenter3D (iter_6, {LA_CASE}): {seg3_s:.3f} s a case, labels "
         f"equal to the sliding window's, foreground "
         f"{float(pred3.mean()):.4f}")
    return {"segmenter_s": seg_s, "segmenter3d_s": seg3_s}, seg3


def _serving_synapse(device, workdir):
    """(d) test_synapse on in-memory volumes against an 8-class U-Net
    checkpoint: its JSON line finite and each metric in range."""
    import contextlib
    import io
    import numpy as np
    import torch
    from arco_torch.cli import test_synapse
    from arco_torch.data.datasets import InMemoryVolumes
    from arco_torch.data.synthetic import make_volume
    from arco_torch.models import net_factory
    from arco_torch.train import checkpoint as ckpt
    torch.manual_seed(5)
    model = net_factory("unet", in_chns=1, class_num=SYN_CLASSES)
    model_dir = workdir / "model_synapse"
    ckpt._save(ckpt._path(str(model_dir / "Synapse/serve_5_labeledfinal" /
                              "unet"), 3),
               {"step": 3, "model": model.state_dict()})
    rng = np.random.RandomState(6)
    vols = InMemoryVolumes([make_volume(rng, (240, 240), SYN_CLASSES,
                                        SERVE_DEPTH) for _ in range(2)])
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        test_synapse.main(["--exp", "Synapse/serve", "--snapshot_dir",
                           str(model_dir)], dataset=vols)
    secs = time.perf_counter() - t0
    line = json.loads(buf.getvalue().strip().splitlines()[-1])
    _log(f"test_synapse (8 classes, 2 in-memory volumes) in {secs:.2f} s: "
         f"{json.dumps(line)}")
    ok = line["iteration"] == 3 and all(
        math.isfinite(line[k]) for k in ("mean_dice", "mean_jc",
                                         "mean_hd95", "mean_asd")) \
        and 0 <= line["mean_dice"] <= 1 and 0 <= line["mean_jc"] <= 1 \
        and line["mean_hd95"] >= 0 and line["mean_asd"] >= 0
    if not ok:
        raise AssertionError(f"test_synapse gave {line}")
    return {"test_synapse": line, "test_synapse_s": secs}


# the interior scores of the sharded and unsharded forwards differed by up
# to 7.66e-5 on the H100 (cuDNN picks other algorithms for the two
# depths); each run also measures what a crop off by one slab would give
# and requires it to exceed this bound
SHARD_SCORE_TOL = 1e-3


def _serving_sharded(device, workdir, seg3):
    """(f) predict_volume_sharded over a one-rank NCCL process group,
    against the unsharded whole-volume forward as
    tests/test_inference_sharded.py:24-41 holds it: the input's shape,
    int32, >= 97% agreement, and away from the depth edges the same
    scores. On the card the two forwards see inputs of other depths (176
    and 144), for which cuDNN may pick other algorithms, so the scores are
    held at SHARD_SCORE_TOL and a label may differ only where the
    unsharded forward's two best scores lie within 2 * SHARD_SCORE_TOL.
    At one rank no halo is exchanged, so this holds the padding and the
    crop; the scores of a crop off by one slab (the unsharded forward
    shifted one slab in depth) must lie beyond SHARD_SCORE_TOL, so the
    bound would see that fault."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from arco_torch.data.synthetic import la_volume
    from arco_torch.parallel import create_mesh
    from arco_torch.parallel.spatial import sharded_volume_forward
    vol, _ = la_volume(np.random.RandomState(7), LA_CASE)
    d, h, w = vol.shape
    # predict_volume_sharded's padding at one rank: every axis to the
    # lattice of 16, and its halo of 16
    x = torch.from_numpy(np.pad(vol, ((0, -d % 16), (0, -h % 16),
                                      (0, -w % 16))))[None, None]
    dist.init_process_group("nccl", init_method=f"file://{workdir}/nccl",
                            rank=0, world_size=1)
    try:
        mesh = create_mesh()
        seg3.predict_volume_sharded(vol, mesh=mesh)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pred = seg3.predict_volume_sharded(vol, mesh=mesh)
        secs = time.perf_counter() - t0
        with torch.no_grad():
            got_p = sharded_volume_forward(seg3._probs, mesh, halo=16,
                                           lattice=16)(x)
    finally:
        dist.destroy_process_group()
    with torch.no_grad():
        want_p = seg3._probs(x.to(device))
    inner = (slice(None), slice(None), slice(24, d - 24), slice(0, h),
             slice(0, w))
    score_err = (got_p[inner] - want_p[inner]).abs().max().item()
    shifted = (slice(None), slice(None), slice(25, d - 23), slice(0, h),
               slice(0, w))
    crop_fault_err = (want_p[shifted] - want_p[inner]).abs().max().item()
    top2 = want_p[0, :, :d, :h, :w].topk(2, dim=0).values
    margin = (top2[0] - top2[1]).cpu().numpy()
    want = want_p.argmax(1)[0, :d, :h, :w].cpu().numpy()
    agree = float((pred == want).mean())
    flips = pred[24:d - 24] != want[24:d - 24]
    worst = float(margin[24:d - 24][flips].max()) if flips.any() else 0.0
    _log(f"predict_volume_sharded (1 NCCL rank, {LA_CASE}, halo 16): "
         f"{secs:.3f} s, agreement with the unsharded forward {agree:.6f}; "
         f"in depth [24, {d - 24}): scores within {score_err:.2e}, "
         f"{int(flips.sum())} labels differ, the widest of their margins "
         f"{worst:.2e}; a crop off by one slab would be "
         f"{crop_fault_err:.2e} off")
    if pred.shape != vol.shape or pred.dtype != np.int32 or agree < 0.97 \
            or score_err > SHARD_SCORE_TOL or worst > 2 * SHARD_SCORE_TOL:
        raise AssertionError("sharded forward differs from the unsharded")
    if not crop_fault_err > SHARD_SCORE_TOL:
        raise AssertionError(f"a crop off by one slab moves the scores by "
                             f"{crop_fault_err}, within SHARD_SCORE_TOL: "
                             f"the check would not see it")
    return {"sharded_s": secs, "sharded_agreement": agree,
            "sharded_score_err": score_err,
            "sharded_crop_fault_err": crop_fault_err,
            "sharded_interior_flips": int(flips.sum())}


def _serving_export(device, workdir):
    """(g) export_model of phase 6's iter_6 on the card (dynamic batch,
    argmax), served at batch 1, 3 and 8 against the eager model; a softmax
    export; a CPU-traced artifact moved to the card; artifact vs eager ms
    at bs 8."""
    import numpy as np
    import torch
    import torch.export.passes
    from arco_torch.cli import export_model
    from arco_torch.export import (export_predictor, load_predictor,
                                   make_predict_fn, save_predictor)
    from arco_torch.models import net_factory
    from arco_torch.train import checkpoint as ckpt
    _log(f"torch {torch.__version__}: torch.export.passes has "
         f"move_to_device_pass: "
         f"{hasattr(torch.export.passes, 'move_to_device_pass')}")
    model_dir = str(workdir / "model")
    path = str(workdir / "unet_dyn.pt2")
    export_model.main(["--exp", "Synapse/smoke", "--labeled_num", "1",
                       "--snapshot_dir", model_dir, "--iteration", "6",
                       "--batch", "dynamic", "--output", "argmax",
                       "--device", "cuda", "--out", path])
    model = net_factory("unet", in_chns=1, class_num=4)
    model.load_state_dict(ckpt.load_model_params(
        str(Path(model_dir) / "Synapse/smoke_1_labeledfinal" / "unet"), 6))
    model = model.to(device)
    eager = make_predict_fn(model)
    predict = load_predictor(path)
    gen = torch.Generator().manual_seed(8)
    xs = {b: torch.rand((b, 1, 256, 256), generator=gen).to(device)
          for b in (1, 3, 8)}
    for b, x in xs.items():
        if not torch.equal(predict(x), eager(x)):
            raise AssertionError(f"export: artifact differs at batch {b}")
    soft_path = str(workdir / "unet_soft.pt2")
    save_predictor(soft_path, export_predictor(model, (2, 1, 256, 256),
                                               output="softmax",
                                               batch="dynamic",
                                               device=device))
    soft_err = (load_predictor(soft_path)(xs[3])
                - make_predict_fn(model, "softmax")(xs[3])).abs().max().item()
    cpu_path = str(workdir / "unet_cpu.pt2")
    save_predictor(cpu_path, export_predictor(model, (2, 1, 256, 256),
                                              batch="dynamic", device="cpu"))
    moved = load_predictor(cpu_path, device=device)
    moved_equal = all(torch.equal(moved(x), eager(x)) for x in xs.values())
    if soft_err > 1e-5 or not moved_equal:
        raise AssertionError(f"export: softmax err {soft_err}, moved "
                             f"artifact equal {moved_equal}")
    art_ms = _time_ms(lambda: predict(xs[8]), 20)
    eager_ms = _time_ms(lambda: eager(xs[8]), 20)
    size = os.path.getsize(path) / 1e6
    _log(f"export: dynamic argmax artifact ({size:.1f} MB) equal to the "
         f"eager model at batch 1, 3, 8; softmax within {soft_err:.2e}; the "
         f"CPU-traced artifact on the card equal; bs 8: artifact "
         f"{art_ms:.3f} ms, eager {eager_ms:.3f} ms")
    return {"artifact_ms_bs8": art_ms, "eager_ms_bs8": eager_ms,
            "softmax_err": soft_err, "artifact_mb": size}


def _serving_repro():
    """(h) repro --validate prints ok for every recipe."""
    import contextlib
    import io
    from arco_torch import repro
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        repro.main(["--validate"])
    lines = buf.getvalue().strip().splitlines()
    if len(lines) != len(repro.RECIPES) or not all(": ok (" in line
                                                    for line in lines):
        raise AssertionError(f"repro --validate: {lines}")
    _log(f"repro --validate: {len(lines)} recipes ok")
    return len(lines)


def phase_serving(device, workdir):
    """Phase 14, the serving surface: (a) the supervised step card vs CPU
    and at full width through step_timer; (b) the timers and trace();
    (c) Segmenter; (d) test_synapse; (e) Segmenter3D; (f) the sharded
    whole-volume forward on one NCCL rank; (g) export_model and the
    artifacts; (h) repro --validate. No kernel is on its path: every
    launch count stays 0."""
    import torch
    from arco_torch.kernels import launch_counts, reset_launch_counts
    t_start = time.perf_counter()
    reset_launch_counts()
    supervised, sup = _serving_supervised(device)
    out = {"supervised": supervised,
           "timers": _serving_timers(device, workdir, sup)}
    segs, seg3 = _serving_segmenters(device, workdir)
    out.update(segs)
    out.update(_serving_synapse(device, workdir))
    out.update(_serving_sharded(device, workdir, seg3))
    out["export"] = _serving_export(device, workdir)
    out["recipes_ok"] = _serving_repro()
    torch.cuda.synchronize()
    if any(launch_counts().values()):
        raise AssertionError(f"phase 14 launched kernels: {launch_counts()}")
    out["s"] = time.perf_counter() - t_start
    _log(f"phase 14 (serving) in {out['s']:.1f} s")
    return out


# phase 15: the data-parallel stage-2 step. (a) one NCCL rank at phase 5's
# configuration against the mesh-less step; (b) two gloo ranks on the one
# card at a global bs of 2 * (B_L + B_U) against one process. The bf16
# metric tolerance of (a) and (b) is phase 4's card-vs-CPU bound on each
# loss term: the mesh path's BatchNorm statistics (two passes in f32
# around an all-reduce) round to bf16 other than cuDNN's, which moves the
# next layer's inputs by an ulp of bf16 here and there. The state limits
# are of each part's largest |value| (a module's weights, "<module>_bn"
# its BatchNorm statistics); each stands about 5x above the most that
# 3 runs of (a) and 1 of (b) read on an H100, and below what the steps
# move the part by, which every check asserts: a run that skipped the
# update reads above its limit. A flipped pixel of the sampler's masks
# shifts the stratified draw to a neighbouring pixel, so the bank is held
# by each class's sum of the rows the steps wrote, which such a shift
# moves by 3% and a skipped enqueue by 100%.
DP_STEPS = 3
DP_F32_TOL = dict(rtol=5e-5, atol=1e-7)      # tests/test_parallel.py:184
DP_BF16_TOL = dict(rtol=5e-2, atol=2e-2)     # phase 4's
DP_STATE_BF16_TOL = {"model": 3e-3, "model_bn": 1.5e-2, "ema_model": 5e-5,
                     "ema_model_bn": 3e-3, "feature_extractor": 6e-5,
                     "k_feature_extractor": 1e-6, "q_representation": 1.5e-4,
                     "bank": 0.15, "pool": 8e-2}
# f32, one step with every term on (the kernels' f32 routes on the card):
# the feature extractor, the query head and the bank are held too, at
# limits ~10-50x the readings of the first such run (feature_extractor
# 5.96e-8, q_representation 8.3e-8, bank 2.09e-7 apart; moved 1.3e-4,
# 2.3e-4, 1). The pool is bf16: 2 ulps (0.00355 apart). The key feature
# extractor is not held: one f32 step moves its EMA by one f32 ulp of its
# largest value (5.96e-8), so no limit tells a wrong state from a right
# one; the two ranks' bit-equal sums still cover it.
DP_STATE_F32_TOL = {"model": 1e-5, "model_bn": 1e-6, "ema_model": 1e-6,
                    "ema_model_bn": 1e-6, "feature_extractor": 1e-6,
                    "q_representation": 1e-6, "bank": 1e-5,
                    "pool": 2.0 ** -7}
DP_MODULES = ("model", "ema_model", "feature_extractor",
              "k_feature_extractor", "q_representation")


def _dp_build(device, b_l, b_u, dtype, mesh=None):
    """Phase 5's configuration at b_l + b_u (the global batch): the step
    (over ``mesh``, or mesh-less) and its state with full banks of
    normalized rows, from seeds, the same in every process. Every term is
    on in both dtypes: in f32 the contrastive and revisiting terms run the
    kernels' f32 routes (f32 anchors and bank, f32 reps against the bf16
    pool), in bf16 their bf16 routes."""
    import torch
    from arco_torch.config import ArcoConfig, DataConfig
    from arco_torch.models import net_factory
    from arco_torch.train import arco2d
    data = DataConfig()
    cfg = ArcoConfig()
    hw = data.patch_size[0]
    torch.manual_seed(0)
    model = net_factory("unet", in_chns=data.in_channels,
                        class_num=data.num_classes)
    mods = arco2d.make_arco_modules(model, hw, hw, batch_size=b_l,
                                    total_batch=b_l + b_u)
    state = arco2d.init_arco_state(mods, cfg, (b_l, 1, hw, hw), seed=0,
                                   device=device, compute_dtype=dtype)
    gen = torch.Generator(device=device).manual_seed(0)
    bank = state.memobank
    for k in range(bank.num_classes):
        _l2n_rows(bank.data[k].normal_(generator=gen))
    bank.count = torch.tensor(bank.capacities, dtype=torch.int32,
                              device=device)
    step = arco2d.make_arco_step(mods, cfg, num_classes=data.num_classes,
                                 max_iterations=30000, device=device,
                                 mesh=mesh)
    return state, step, cfg


def _dp_batches(b_l, b_u, device, steps):
    import torch
    gen = torch.Generator(device=device).manual_seed(1)
    out = []
    for _ in range(steps):
        image_l, label_l = _synthetic_batch(b_l, HW, gen, device)
        image_u, _ = _synthetic_batch(b_u, HW, gen, device)
        out.append({"image_l": image_l, "label_l": label_l,
                    "image_u": image_u})
    return out


def _dp_run(state, step, batches, mesh=None):
    """The steps over ``batches`` (each rank's shard with a ``mesh``):
    (metrics of each step, ms of each step, the kernels' launches)."""
    import torch
    from arco_torch.kernels import launch_counts, reset_launch_counts
    from arco_torch.parallel import shard_batch
    if mesh is not None:
        batches = [shard_batch(b, mesh) for b in batches]
    torch.cuda.synchronize()
    reset_launch_counts()
    metrics, ms = [], []
    for batch in batches:
        t0 = time.perf_counter()
        m = step(state, batch)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        metrics.append({k: float(v) for k, v in m.items() if v.ndim == 0})
    return metrics, ms, launch_counts()


def _dp_state(state, cfg, steps, pool_rows):
    """A copy of what the steps change, on the CPU: every module's weights
    and, under "<module>_bn", its BatchNorm statistics, the bank's rows that ``steps`` steps can
    write (slots 1 .. steps * enqueue, the bank's pointers starting at 1)
    with its pointers and counts, and the pool's first ``pool_rows`` rows
    with its pointer."""
    import torch
    out = {}
    for name in DP_MODULES:
        module = getattr(state, name)
        out[name] = {k: v.detach().cpu().clone()
                     for k, v in module.named_parameters()}
        bn = {k: v.cpu().clone() for k, v in module.named_buffers()
              if v.is_floating_point()}
        if bn:
            out[name + "_bn"] = bn
    bank = state.memobank
    rows = 1 + steps * cfg.memobank_enqueue
    out["bank"] = {"rows": bank.data[:, :rows].cpu().clone(),
                   "ptr": bank.ptr.cpu().clone(),
                   "count": bank.count.cpu().clone()}
    out["pool"] = state.random_pool[:pool_rows].cpu().clone()
    out["pool_ptr"] = state.random_pool_ptr
    return out


def _dp_parts(st, ptr):
    """{part: [tensors]} of a ``_dp_state``, the bank as each class's f64
    sum of its rows in slots 1 .. ``ptr`` - 1."""
    import torch
    parts = {n: list(v.values()) for n, v in st.items()
             if isinstance(v, dict) and n != "bank"}
    rows = st["bank"]["rows"].double()
    parts["bank"] = [torch.stack([rows[k, 1:int(p)].sum(0)
                                  for k, p in enumerate(ptr)])]
    parts["pool"] = [st["pool"]]
    return parts


def _dp_compare(label, got, want, init, metric_tol, limits):
    """Every metric of every step within ``metric_tol``; each part of the
    state within ``limits[part]`` of the part's largest |value| in
    ``want``, and the ``init`` state (what the steps started from) beyond it; pointers and
    counts equal. Returns, for each part, how far ``got`` is ("<part>")
    and how far ``init`` is ("<part>_moved"), of its largest |value|."""
    import torch
    worst = {"metric_rel": 0.0}
    for i, (g, w) in enumerate(zip(got["metrics"], want["metrics"])):
        for k in w:
            d = abs(g[k] - w[k])
            worst["metric_rel"] = max(worst["metric_rel"],
                                      d / max(abs(w[k]), 1e-30))
            if not d <= metric_tol["atol"] + metric_tol["rtol"] * abs(w[k]):
                raise AssertionError(f"{label} step {i} {k}: {g[k]} vs "
                                     f"{w[k]}")
    gs, ws = got["state"], want["state"]
    for k in ("ptr", "count"):
        if not torch.equal(gs["bank"][k], ws["bank"][k]):
            raise AssertionError(f"{label} bank {k} differs")
    if gs["pool_ptr"] != ws["pool_ptr"]:
        raise AssertionError(f"{label} pool pointer differs")
    ptr = ws["bank"]["ptr"]
    g_parts, w_parts, i_parts = (_dp_parts(st, ptr) for st in
                                 (gs, ws, init))

    def apart(a, b):
        scale = max(max(t.double().abs().max().item() for t in b), 1e-30)
        return max((x.double() - y.double()).abs().max().item()
                   for x, y in zip(a, b)) / scale
    for name in w_parts:
        worst[name] = apart(g_parts[name], w_parts[name])
        worst[name + "_moved"] = apart(i_parts[name], w_parts[name])
    _log(f"  {label}: metrics within {worst['metric_rel']:.3g} (relative); "
         f"state apart by / moved by, of each part's largest |value|: "
         + ", ".join(f"{n} {worst[n]:.3g} / {worst[n + '_moved']:.3g}"
                     for n in w_parts))
    for name, tol in limits.items():
        if not worst[name] <= tol:
            raise AssertionError(f"{label} {name}: {worst[name]} of its "
                                 f"largest |value| apart, limit {tol}")
        if not worst[name + "_moved"] > tol:
            raise AssertionError(f"{label} {name}: the steps move it by "
                                 f"{worst[name + '_moved']}, within the "
                                 f"limit {tol}: the check is blind")
    return worst


def _trace_step(step, state, batch, log_dir):
    """One step under utils.profiling.trace: its CUDA kernels, their busy
    time, the span from the first kernel's start to the last one's end,
    and the kernels' count by name for the names that are most often
    launched."""
    import collections
    import torch
    from arco_torch.utils.profiling import trace
    with trace(str(log_dir)):
        step(state, batch)
        torch.cuda.synchronize()
    files = list(Path(log_dir).glob("*.pt.trace.json"))
    if len(files) != 1:
        raise AssertionError(f"trace: files {files}")
    events = json.loads(files[0].read_text())["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    if not kernels:
        raise AssertionError("trace: no CUDA kernel events")
    start = min(e["ts"] for e in kernels)
    end = max(e["ts"] + e.get("dur", 0) for e in kernels)
    busy = sum(e.get("dur", 0) for e in kernels)
    names = collections.Counter(e["name"][:60] for e in kernels)
    return {"kernels": len(kernels), "busy_us": busy, "span_us": end - start,
            "busy_share": busy / max(end - start, 1e-9),
            "nccl_kernels": sum(n for k, n in names.items()
                                if "nccl" in k.lower()),
            "by_name": dict(names.most_common(8))}


def _dp_one_nccl_rank(device, workdir):
    """(a) 3 steps of phase 5's configuration through make_arco_step over
    a one-rank NCCL mesh against the mesh-less step, from the same seeds
    (state, batches, draws from the generator); then one more step of
    each under the profiler."""
    import torch
    import torch.distributed as dist
    from arco_torch.parallel import create_mesh, shard_batch
    batches = _dp_batches(B_L, B_U, device, DP_STEPS + 1)
    state0, step0, cfg = _dp_build(device, B_L, B_U, torch.bfloat16)
    init = _dp_state(state0, cfg, DP_STEPS, DP_STEPS * B_U)
    metrics, ms, _ = _dp_run(state0, step0, batches[:DP_STEPS])
    want = {"metrics": metrics,
            "state": _dp_state(state0, cfg, DP_STEPS, DP_STEPS * B_U)}
    dist.init_process_group("nccl", init_method=f"file://{workdir}/nccl15",
                            rank=0, world_size=1)
    try:
        mesh = create_mesh()
        state, step, _ = _dp_build(device, B_L, B_U, torch.bfloat16, mesh)
        torch.cuda.reset_peak_memory_stats()
        metrics, dp_ms, counts = _dp_run(state, step, batches[:DP_STEPS],
                                         mesh)
        peak = torch.cuda.max_memory_allocated()
        got = {"metrics": metrics,
               "state": _dp_state(state, cfg, DP_STEPS, DP_STEPS * B_U)}
        traces = {"mesh": _trace_step(step, state,
                                      shard_batch(batches[-1], mesh),
                                      workdir / "trace15_mesh"),
                  "meshless": _trace_step(step0, state0, batches[-1],
                                          workdir / "trace15_meshless")}
    finally:
        dist.destroy_process_group()
    _log(f"  (a) one NCCL rank, bs {B_L}+{B_U}: step ms {ms} mesh-less, "
         f"{[round(t, 2) for t in dp_ms]} on the mesh; peak "
         f"{peak / 2**30:.2f} GiB; launches {counts}")
    for name, t in traces.items():
        _log(f"  (a) trace of one {name} step: {t['kernels']} kernels "
             f"({t['nccl_kernels']} NCCL), {t['busy_us'] / 1e3:.2f} ms busy "
             f"of a {t['span_us'] / 1e3:.2f} ms span "
             f"({t['busy_share']:.3f}); most launched: {t['by_name']}")
    worst = _dp_compare("(a) one NCCL rank vs mesh-less", got, want, init,
                        DP_BF16_TOL, DP_STATE_BF16_TOL)
    _check_launches(f"(a) {DP_STEPS} steps", counts, DP_STEPS)
    del state, step, state0, step0, want, got
    torch.cuda.empty_cache()
    return counts, {"step_ms": dp_ms, "meshless_step_ms": ms,
                    "peak_gib": peak / 2**30, "trace": traces, **worst}


def _dp_rank(rank, workdir):
    """One of (b)'s two gloo ranks on the one card: the f32 step and the
    bf16 steps over this rank's shard; writes its metrics, ms, peak,
    launches, per-tensor sums of its state (equal on both ranks when
    their states are equal bit for bit) and, rank 0, the state itself to
    ``workdir``."""
    sys.path.insert(0, str(ROOT))
    import torch
    import torch.distributed as dist
    from arco_torch.parallel import create_mesh
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.set_device(0)
    device = torch.device("cuda", 0)
    dist.init_process_group("gloo", init_method=f"file://{workdir}/gloo15",
                            rank=rank, world_size=2)
    try:
        out = {}
        mesh = create_mesh((2,), device_type="cuda")
        for label, dtype, steps in (("f32", torch.float32, 1),
                                    ("bf16", torch.bfloat16, DP_STEPS)):
            batches = _dp_batches(2 * B_L, 2 * B_U, device, steps)
            state, step, cfg = _dp_build(device, 2 * B_L, 2 * B_U, dtype,
                                         mesh)
            torch.cuda.reset_peak_memory_stats()
            metrics, ms, counts = _dp_run(state, step, batches, mesh)
            st = _dp_state(state, cfg, steps, steps * 2 * B_U)
            out[label] = {"metrics": metrics, "ms": ms, "launches": counts,
                          "peak_gib": torch.cuda.max_memory_allocated()
                          / 2**30, "sums": _dp_sums(st)}
            if rank == 0:
                out[label]["state"] = st
            del state, step, batches
            torch.cuda.empty_cache()
        torch.save(out, f"{workdir}/dp_rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def _dp_sums(st):
    """Per-tensor float64 sums of a ``_dp_state``: two states that are
    bit for bit equal have equal sums."""
    import torch
    return {k: ({kk: vv.double().sum().item() for kk, vv in v.items()}
                if isinstance(v, dict) else
                v.double().sum().item() if isinstance(v, torch.Tensor)
                else v)
            for k, v in st.items()}


def _dp_two_gloo_ranks(device, workdir):
    """(b) two gloo ranks on the one card at a global bs of 2 * (B_L +
    B_U), B_L + B_U a rank, against one process over that batch: one f32
    step (TF32 off) at DP_F32_TOL, then DP_STEPS bf16 steps at
    DP_BF16_TOL. Returns each rank's launches ({"f32": [...], "bf16":
    [...]}) and the numbers."""
    import torch
    import torch.multiprocessing as mp
    want = {}
    for label, dtype, steps in (("f32", torch.float32, 1),
                                ("bf16", torch.bfloat16, DP_STEPS)):
        batches = _dp_batches(2 * B_L, 2 * B_U, device, steps)
        state, step, cfg = _dp_build(device, 2 * B_L, 2 * B_U, dtype)
        init = _dp_state(state, cfg, steps, steps * 2 * B_U)
        metrics, ms, _ = _dp_run(state, step, batches)
        want[label] = {"metrics": metrics, "ms": ms, "init": init,
                       "state": _dp_state(state, cfg, steps,
                                          steps * 2 * B_U)}
        del state, step, batches
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    mp.spawn(_dp_rank, nprocs=2, args=(str(workdir),), join=True)
    spawn_s = time.perf_counter() - t0
    ranks = [torch.load(f"{workdir}/dp_rank{r}.pt", weights_only=False)
             for r in range(2)]
    out = {"spawn_s": spawn_s}
    launches = {}
    for label, tol, limits in (("f32", DP_F32_TOL, DP_STATE_F32_TOL),
                               ("bf16", DP_BF16_TOL, DP_STATE_BF16_TOL)):
        steps = len(want[label]["metrics"])
        worst = _dp_compare(f"(b) 2 gloo ranks {label}", ranks[0][label],
                            want[label], want[label]["init"], tol, limits)
        if ranks[0][label]["sums"] != ranks[1][label]["sums"]:
            raise AssertionError(f"(b) {label}: the ranks' states differ")
        for r, rec in enumerate(ranks):
            if rec[label]["metrics"] != ranks[0][label]["metrics"]:
                raise AssertionError(f"(b) {label}: rank {r}'s metrics "
                                     f"differ from rank 0's")
            _check_launches(f"(b) {label} rank {r}, {steps} steps",
                            rec[label]["launches"], steps,
                            BF16_ROUTES if label == "bf16" else F32_ROUTES)
            _log(f"  (b) {label} rank {r}: step ms "
                 f"{[round(t, 2) for t in rec[label]['ms']]}, peak "
                 f"{rec[label]['peak_gib']:.2f} GiB, launches "
                 f"{rec[label]['launches']} in {steps} steps")
        _log(f"  (b) {label} one process at bs {2 * B_L}+{2 * B_U}: step ms "
             f"{[round(t, 2) for t in want[label]['ms']]}")
        out[label] = {**worst, "meshless_step_ms": want[label]["ms"],
                      "ranks": [{k: rec[label][k] for k in
                                 ("ms", "peak_gib", "launches")}
                                for rec in ranks]}
        launches[label] = [rec[label]["launches"] for rec in ranks]
    del want, ranks
    torch.cuda.empty_cache()
    return launches, out


def _dp_dryrun():
    """(d) parallel.dryrun's entry point at its defaults, on the card:
    4 ranks (gloo on the one card's tensors), JAX's dry-run step on a 2x2
    ("data", "space") mesh and the depth-sharded forward with its halo
    exchange; it raises if a rank fails."""
    from arco_torch.parallel.dryrun import dryrun_multichip
    t0 = time.perf_counter()
    dryrun_multichip(4)
    return time.perf_counter() - t0


def phase_data_parallel(device, workdir):
    """Phase 15, the data-parallel stage-2 step on the one card: (a) one
    NCCL rank against the mesh-less step; (b) two gloo ranks against one
    process; (c) pool_sims at 2 query rows (a rank's share of a global bs
    2+2 over 2 ranks) against its plain version; (d) dryrun_multichip(4)
    on the card."""
    import torch
    t_start = time.perf_counter()
    counts, one = _dp_one_nccl_rank(device, workdir)
    launches_ranks, two = _dp_two_gloo_ranks(device, workdir)
    gen = torch.Generator(device=device).manual_seed(15)
    rows2 = _pool_sims_at(gen, device, 2, C * HW * HW)
    dryrun_s = _dp_dryrun()
    _log(f"  (d) dryrun_multichip(4) on the card in {dryrun_s:.1f} s")
    out = {"one_nccl_rank": one, "two_gloo_ranks": two,
           "dryrun_s": dryrun_s, "s": time.perf_counter() - t_start}
    _log(f"phase 15 (data parallel) in {out['s']:.1f} s")
    return counts, launches_ranks, rows2, out


F32_STEPS, F32_CLI_STEPS = 3, 4


def _f32_kernels(device):
    """(a) The f32 routes against their plain versions at the f32 steps'
    shapes (TF32 off): the InfoNCE pair at the 2D (K 4, C 496) and 3D (K 2,
    C 16) shapes over full f32 banks at 'smc' draws, pool_sims on 2 x 2 f32
    reps against the 36-row pool in bf16 (the CLIs' default) and in f32,
    at the 2D and 3D widths. {route: {"2d"/"3d": record}}, pool_sims_f32's
    records by pool under "bf16_pool" / "f32_pool"."""
    import torch
    gen = torch.Generator(device=device).manual_seed(16)
    f32 = torch.float32
    out = {}
    for shape, caps, c in (("2d", CAPS, C), ("3d", CAPS_3D, C_3D)):
        per_draw = _infonce_draws(gen, device, caps, c, (MAIN_DRAW,), f32)
        for name, rec in per_draw.items():
            out.setdefault(name, {})[shape] = {**rec[MAIN_DRAW],
                                               "library_ms": None}
    for shape, f in (("2d", C * HW * HW), ("3d", C_3D * math.prod(PATCH_3D))):
        for pool, dtype in (("bf16_pool", torch.bfloat16), ("f32_pool", f32)):
            out.setdefault("pool_sims_f32", {}).setdefault(shape, {})[pool] \
                = _pool_sims_at(gen, device, 2 * B_U, f, f32, dtype)
    return out


def _f32_main_path(device):
    """(c) 3 steps of phase 5's configuration (U-Net, 256², bs 2+2, the
    ArcoConfig defaults, full banks) at f32: every loss finite, each f32
    route launched once a step and no bf16 route, ms a step and peak
    memory; the revisiting loss hands pool_sims the state's bf16 pool
    itself (its storage, no f32 copy) with the f32 reps."""
    import torch
    from arco_torch.config import ArcoConfig, DataConfig
    from arco_torch.kernels import launch_counts, reset_launch_counts
    from arco_torch.losses import consistency
    from arco_torch.models import net_factory
    from arco_torch.train import arco2d
    data, cfg = DataConfig(), ArcoConfig()
    hw = data.patch_size[0]
    b_l, b_u = data.labeled_bs, data.batch_size - data.labeled_bs
    torch.manual_seed(0)
    model = net_factory("unet", in_chns=data.in_channels,
                        class_num=data.num_classes)
    mods = arco2d.make_arco_modules(model, hw, hw, batch_size=b_l,
                                    total_batch=b_l + b_u)
    state = arco2d.init_arco_state(mods, cfg, (b_l, 1, hw, hw), seed=0,
                                   device=device,
                                   compute_dtype=torch.float32)
    step = arco2d.make_arco_step(mods, cfg, num_classes=data.num_classes,
                                 max_iterations=30000, device=device)
    gen = torch.Generator(device=device).manual_seed(0)
    bank = state.memobank
    for k in range(bank.num_classes):
        _l2n_rows(bank.data[k].normal_(generator=gen))
    bank.count = torch.tensor(bank.capacities, dtype=torch.int32,
                              device=device)
    batches = []
    for _ in range(F32_STEPS):
        image_l, label_l = _synthetic_batch(b_l, hw, gen, device)
        image_u, _ = _synthetic_batch(b_u, hw, gen, device)
        batches.append({"image_l": image_l, "label_l": label_l,
                        "image_u": image_u})
    _log(f"f32 state: pool {tuple(state.random_pool.shape)} "
         f"{state.random_pool.dtype}, bank {tuple(bank.data.shape)} "
         f"{bank.data.dtype}")
    handed = []
    sims_fn = consistency.pool_similarities

    def spy(queries, pool):
        handed.append((queries.dtype, pool.dtype,
                       pool.data_ptr() == state.random_pool.data_ptr()))
        return sims_fn(queries, pool)
    consistency.pool_similarities = spy
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        step_ms, metrics = [], []
        for batch in batches:
            t0 = time.perf_counter()
            metrics.append(step(state, batch))
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
        counts = launch_counts()
        peak = torch.cuda.max_memory_allocated()
    finally:
        consistency.pool_similarities = sims_fn
    _check_steps("f32", metrics, step_ms, b_l, hw)
    _check_launches(f"f32, {F32_STEPS} steps", counts, F32_STEPS,
                    F32_ROUTES)
    if handed != [(torch.float32, torch.bfloat16, True)] * F32_STEPS:
        raise AssertionError(f"f32: pool_sims was handed {handed}")
    _log(f"f32 step ms {[round(t, 2) for t in step_ms]}, peak memory "
         f"{peak / 2**30:.2f} GiB; launches {counts}; the bf16 pool read in "
         f"place")
    del state, step, batches, metrics, bank, mods
    torch.cuda.empty_cache()
    return counts, {"step_ms": step_ms, "peak_gib": peak / 2**30}


def _f32_clis(device, workdir, root, vols):
    """(d) ``train_arco_2d --compute_dtype float32`` for 4 steps on phase
    6's npz tree and (e) ``train_arco_3d --compute_dtype float32`` for 4
    steps on in-memory volumes (phase 9's), each f32 route once a step and
    no bf16 route, every logged loss finite."""
    import pickle
    import torch
    from arco_torch.cli import train_arco_2d, train_arco_3d
    from arco_torch.data.datasets import InMemoryVolumes
    from arco_torch.kernels import launch_counts, reset_launch_counts
    model_dir = str(workdir / "model_f32")
    steps = str(F32_CLI_STEPS)
    out, counts = {}, {}
    for label in ("2d", "3d"):
        reset_launch_counts()
        t0 = time.perf_counter()
        if label == "2d":
            train_arco_2d.main([
                "--root_path", root, "--exp", "Synapse/f32", "--labeled_num",
                "1", "--snapshot_dir", model_dir, "--max_iterations", steps,
                "--log_every", "1", "--ckpt_every", steps,
                "--compute_dtype", "float32"])
            run = Path(model_dir) / "Synapse/f32_1_labeledfinal" / "unet"
        else:
            cfg, snap = train_arco_3d.parse([
                "--exp", "LA/f32", "--labeled_num", str(CLI3D_LABELED),
                "--snapshot_dir", model_dir, "--max_iterations", steps,
                "--log_every", "2", "--ckpt_every", steps,
                "--compute_dtype", "float32"])
            train_arco_3d.train(cfg, snap, dataset=(
                InMemoryVolumes(vols[:CLI3D_LABELED], PATCH_3D),
                InMemoryVolumes(vols[CLI3D_LABELED:], PATCH_3D)))
            run = Path(snap)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts[label] = launch_counts()
        with open(run / "record.pkl", "rb") as f:
            history = pickle.load(f)
        rows = [json.loads(line)
                for line in (run / "metrics.jsonl").read_text().splitlines()]
        if len(history) != F32_CLI_STEPS \
                or not all(math.isfinite(v) for v in history) \
                or not all(math.isfinite(r["loss"]) for r in rows):
            raise AssertionError(f"f32 {label} cli: record.pkl {history}, "
                                 f"metrics {rows}")
        _check_launches(f"f32 {label} cli, {steps} steps", counts[label],
                        F32_CLI_STEPS, F32_ROUTES)
        rate = "images_per_sec" if label == "2d" else "volumes_per_sec"
        out[label] = {"s": seconds, rate: [r[rate] for r in rows],
                      "loss": history}
        _log(f"f32 {label} cli: {steps} steps in {seconds:.1f} s (set-up "
             f"included), {rate} {[round(r[rate], 3) for r in rows]}, "
             f"losses {[round(v, 4) for v in history]}; launches "
             f"{counts[label]}")
    return counts, out


def phase_f32(device, workdir, root, vols):
    """Phase 16, stage 2 at --compute_dtype float32 through the kernels'
    f32 routes: (a) the routes against their plain versions at the 2D and
    3D shapes; (b) phase 4's small step at f32 on the card against the
    CPU's at F32_LOSS_TOL, strong aug off and at the defaults; (c) 3
    full-width steps of phase 5's configuration; (d) the 2D and (e) the 3D
    CLI at --compute_dtype float32, 4 steps each."""
    t_start = time.perf_counter()
    kernels = _f32_kernels(device)
    ref_counts = _step_reference(device, "float32", F32_LOSS_TOL)
    _check_launches("f32 reference, 2 steps", ref_counts, 2, F32_ROUTES)
    counts, main_path = _f32_main_path(device)
    cli_counts, clis = _f32_clis(device, workdir, root, vols)
    out = {"main_path": main_path, "cli": clis,
           "s": time.perf_counter() - t_start}
    _log(f"phase 16 (f32) in {out['s']:.1f} s")
    return counts, cli_counts, kernels, out


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
        two3d_counts, vols, two_stage_3d = phase_pretrain_3d(device,
                                                             workdir)
        unet3d = phase_unet3d(device, workdir, vols)
        zoo_counts, zoo = phase_zoo(device, workdir, root)
        rest = phase_rest(device, workdir, root, vols)
        natural_counts, natural = phase_natural(device, workdir)
        pretrained = phase_pretrained(device, workdir, root)
        serving = phase_serving(device, workdir)
        f32_counts, f32_cli_counts, f32_kernels, f32 = phase_f32(
            device, workdir, root, vols)
        dp_counts, dp_rank_counts, rows2, data_parallel = \
            phase_data_parallel(device, workdir)
    for k in kernels:
        name = k["name"]
        k["launches"] = counts[name]
        k["launches_cli"] = cli_counts[name]
        k["launches_two_stage"] = two_counts[name]
        k["launches_zoo"] = zoo_counts[name]
        k["launches_natural"] = natural_counts[name]
        k["launches_data_parallel"] = dp_counts[name]
        if name == "pool_sims":
            k["rows2"] = rows2
        k["launches_data_parallel_ranks"] = [c[name] for c in
                                             dp_rank_counts["bf16"]]
        k["natural"] = natural["kernels"][name]
        k["3d"] = {**kernels_3d[name], "launches": counts_3d[name],
                   "launches_cli": cli3d_counts[name],
                   "launches_two_stage": two3d_counts[name]}
    # the f32 routes: the top-level numbers at the 2D shape (pool_sims
    # against the bf16 pool), launches from phase 16c
    for name, source, replaces in (
            ("infonce_fwd_f32", "infonce.cu", "infonce.py:127"),
            ("infonce_bwd_f32", "infonce.cu", "infonce.py:147"),
            ("pool_sims_f32", "pool_sims.cu", "pool_sims.py:54")):
        rec = f32_kernels[name]
        main2d = rec["2d"]["bf16_pool"] if name == "pool_sims_f32" \
            else rec["2d"]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"arco_torch/kernels/csrc/{source}",
            "replaces": f"arco_tpu/ops/pallas/{replaces}",
            **{key: main2d[key] for key in (
                "max_abs_err", "ms", "device_ms", "plain_ms", "bound_ms",
                "bound_by", "library_ms")},
            "launches": f32_counts[name],
            "launches_cli": f32_cli_counts["2d"][name],
            "launches_data_parallel_ranks": [c[name] for c in
                                             dp_rank_counts["f32"]],
            "shapes": rec,
            "3d": {"launches_cli": f32_cli_counts["3d"][name]}})
    print(json.dumps({"main_path": main_path, "cli": cli,
                      "two_stage": two_stage, "main_path_3d": main_path_3d,
                      "cli_3d": cli_3d, "two_stage_3d": two_stage_3d,
                      "unet3d": unet3d, "zoo": zoo, "rest": rest,
                      "natural": {k: v for k, v in natural.items()
                                  if k != "kernels"},
                      "pretrained": pretrained, "serving": serving,
                      "data_parallel": data_parallel, "f32": f32}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
