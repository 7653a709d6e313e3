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
   next;
4. hold one small step on the card (bf16 autocast, kernels) against the
   same step on the CPU (f32, plain versions) from the same state, batch
   and draws;
5. drive the main path: ``init_arco_state`` + 3 ``make_arco_step`` steps of
   the stage-2 ARCO trainer at full width (U-Net 16..256, 496-channel reps,
   256x256 slices, 2 labeled + 2 unlabeled, K=36 pool, 50000/30000 banks
   filled with normalized rows, bf16), with every loss finite and every
   kernel's launch count equal to the number of steps.

It then prints one JSON line with the kernels' numbers and, last, the
device line. Without a CUDA GPU, or without the repository beside it, it
prints no result and exits non-zero.

Each kernel's "ms", "plain_ms" and "library_ms" time one call between two
CUDA events, the host's work before the launch included. Its "device_ms"
is the device's time per call alone: calls queued behind a GPU sleep,
between two CUDA events.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM data sheet: HBM3 bandwidth and dense bf16 tensor-core peak.
PEAK_BYTES_PER_S = 3.35e12
PEAK_BF16_OPS_PER_S = 989e12

# the main path's kernel shapes: 4 classes x 256 anchors x 512 negatives
# over 496-channel bank rows; 2 + 2 reps of 496 x 256 x 256 against 36
# pool rows
NUM_CLASSES, Q, N, C, TEMP = 4, 256, 512, 496, 0.5
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


def _neg_draws(gen, device):
    """neg_idx [K, Q, N] int32 drawn three ways over the full banks: uniform
    (the draw phase 3 first timed), and Q*N stratified ('smc', the main
    path's) or antithetic ('asmc') ranks per class, reshaped as
    losses/contrastive.py does, so that neg_idx[k, q, n] = rank[k, n*Q + q]."""
    import torch
    from arco_torch.ops import sampling
    caps = torch.tensor(CAPS, device=device)
    out = {"uniform": (torch.rand((NUM_CLASSES, Q, N), generator=gen,
                                  device=device)
                       * caps[:, None, None]).to(torch.int32)}
    for func in ("smc", "asmc"):
        ranks = sampling.draw_indices(caps, Q * N, func=func, generator=gen,
                                      device=device)
        out[func] = ranks.reshape(NUM_CLASSES, N, Q).transpose(1, 2) \
            .to(torch.int32).contiguous()
    return out


def _infonce_inputs(gen, device):
    """A full bank (steady state) of normalized rows, anchors, prototypes,
    and negatives drawn three ways from each class's capacity."""
    import torch
    bf = torch.bfloat16
    bank = torch.randn((NUM_CLASSES, max(CAPS), C), generator=gen,
                       device=device, dtype=bf)
    for k in range(NUM_CLASSES):
        _l2n_rows(bank[k])
    a_n = _l2n_rows(torch.randn((NUM_CLASSES * Q, C), generator=gen,
                                device=device, dtype=bf)).view(
        NUM_CLASSES, Q, C)
    p_n = _l2n_rows(torch.randn((NUM_CLASSES, C), generator=gen,
                                device=device, dtype=bf))
    return a_n, p_n, bank, _neg_draws(gen, device)


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
    distinct = sum(int(torch.unique(neg_idx[k]).numel())
                   for k in range(NUM_CLASSES))
    rows = {"rows_distinct": distinct, "rows_fetched": _staged_rows(neg_idx)}
    row_bytes = C * 2
    small = neg_idx.numel() * 4 + e.numel() * 4
    fwd_bytes = (distinct * row_bytes + a_n.numel() * 2 + small
                 + denom.numel() * 4)
    bwd_bytes = (distinct * row_bytes + small + invtot.numel() * 4
                 + ga.numel() * 4)
    ops = 2 * NUM_CLASSES * Q * N * C
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


def phase_kernels(device):
    """Each kernel against its plain version at the main path's shapes."""
    import torch
    from arco_torch.kernels import pool_sims
    gen = torch.Generator(device=device).manual_seed(0)
    bf = torch.bfloat16
    results = []

    # ---- K1 / K2
    a_n, p_n, bank, draws = _infonce_inputs(gen, device)
    per_draw = {"infonce_fwd": {}, "infonce_bwd": {}}
    for func, neg_idx in draws.items():
        for name, r in _infonce_at(a_n, p_n, bank, neg_idx).items():
            per_draw[name][func] = r
        _log(f"infonce at {func} draws: {r['rows_distinct']} distinct rows, "
             f"{r['rows_fetched']} staged of {neg_idx.numel()} draws")
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
    del bank, draws
    torch.cuda.empty_cache()

    # ---- K3: queries are the student + teacher reps of the 2 unlabeled
    # images, each near one pool row so the sims span [0, ~0.7]
    f = C * HW * HW
    pool = _l2n_rows(torch.randn((POOL_K, f), generator=gen, device=device,
                                 dtype=bf))
    queries = torch.randn((2 * B_U, f), generator=gen, device=device,
                          dtype=bf)
    for b in range(2 * B_U):
        queries[b] = (queries[b].float() * (1.0 / math.sqrt(f))
                      + 0.7 * (b + 1) / (2 * B_U) * pool[b].float()).to(bf)
    _l2n_rows(queries)
    sims = pool_sims.pool_similarities(queries, pool)
    sims_ref = pool_sims.pool_similarities_plain(queries, pool)
    torch.cuda.synchronize()
    err_s = (sims - sims_ref).abs().max().item()
    scale = sims_ref.abs().max().item()
    if not err_s <= 1e-3 * scale:
        raise AssertionError(f"pool_sims: max err {err_s} > 1e-3 * {scale}")
    bound, by = _bound_ms((2 * B_U + POOL_K) * f * 2 + sims.numel() * 4,
                          2 * 2 * B_U * POOL_K * f)

    def sims_fn():
        return pool_sims.pool_similarities(queries, pool)
    results.append({
        "name": "pool_sims", "route": "cuda",
        "source": "arco_torch/kernels/csrc/pool_sims.cu",
        "replaces": "arco_tpu/ops/pallas/pool_sims.py:54",
        "max_abs_err": err_s, "ms": _time_ms(sims_fn, 20),
        "device_ms": _device_ms(sims_fn, 20),
        "plain_ms": _time_ms(
            lambda: pool_sims.pool_similarities_plain(queries, pool), 3),
        "bound_ms": bound, "bound_by": by,
        "library_ms": _time_ms(lambda: torch.matmul(queries, pool.t()), 20)})
    _log(f"pool_sims: max err {err_s:.3g} of max |sims| {scale:.3g}")
    for r in results:
        _log(f"  {r['name']}: {r['ms']:.4f} ms (device "
             f"{r['device_ms']:.4f} ms, plain {r['plain_ms']:.3f} ms, bound "
             f"{r['bound_ms']:.4f} ms by {r['bound_by']}, library "
             f"{r['library_ms']})")
    del pool, queries
    torch.cuda.empty_cache()
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
    models): the cutmix boxes, the TPS draws and the sampler uniforms."""
    import torch
    from arco_torch.augment.mixing import draw_cutout_boxes
    from arco_torch.augment.tps import draw_tps
    q, n, e = cfg.num_queries, cfg.num_negatives, cfg.memobank_enqueue
    return {"mix_boxes": draw_cutout_boxes(b_u, (hw, hw), generator=gen),
            "tps": draw_tps(b_l + b_u, cfg.tps_sigma, generator=gen),
            "contra": {"enq": torch.rand((num_classes, e), generator=gen),
                       "anchor": torch.rand((num_classes, q), generator=gen),
                       "neg": torch.rand((num_classes, q * n),
                                         generator=gen)}}


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


def phase_reference(device):
    """One small step on ``device`` (bf16 autocast, the kernels) against the
    same step on the CPU in f32 with the plain versions: the same initial
    weights, pool, batch and draws. Tolerance rtol 5e-2 / atol 2e-2 per
    loss term: bf16 autocast (8-bit mantissa) against f32 leaves logit
    errors of ~1e-2, which move the O(0.1) KL of the eqv term by about as
    much and the O(1) terms by a few percent at most."""
    import torch
    from arco_torch.config import ArcoConfig
    from arco_torch.models import net_factory
    from arco_torch.train import arco2d
    hw, b, nc = 64, 2, 4
    cfg = ArcoConfig(K=4, num_queries=32, num_negatives=64,
                     memobank_size=256, memobank_size_bg=512,
                     memobank_enqueue=64, topk=2, use_photometric=False,
                     use_adv_morph=False)

    def build(dev, dtype):
        torch.manual_seed(1)
        mods = arco2d.make_arco_modules(
            net_factory("unet", in_chns=1, class_num=nc,
                        dropout=(0.0,) * 5), hw, hw, batch_size=b)
        state = arco2d.init_arco_state(mods, cfg, (b, 1, hw, hw), seed=1,
                                       device=dev, compute_dtype=dtype)
        step = arco2d.make_arco_step(mods, cfg, num_classes=nc,
                                     max_iterations=100, device=dev)
        return state, step

    ref_state, ref_step = build("cpu", torch.float32)
    state, step = build(device, torch.bfloat16)
    state.random_pool.copy_(ref_state.random_pool)
    gen = torch.Generator().manual_seed(2)
    image_l, label_l = _synthetic_batch(b, hw, gen, "cpu")
    image_u, _ = _synthetic_batch(b, hw, gen, "cpu")
    batch = {"image_l": image_l, "label_l": label_l, "image_u": image_u}
    draws = _draws(cfg, b, b, hw, nc, gen)
    want = ref_step(ref_state, batch, draws)
    got = step(state, _to(batch, device), _to(draws, device))
    for k in ("loss", "reco_loss", "loss_q", "unsup_loss", "loss_ce",
              "loss_dice", "loss_eqv"):
        g, w = float(got[k]), float(want[k])
        _log(f"  reference {k}: card {g:.6f} cpu {w:.6f}")
        if not abs(g - w) <= 2e-2 + 5e-2 * abs(w):
            raise AssertionError(f"{k}: card {g} vs cpu {w}")


def phase_main_path(device):
    """The stage-2 ARCO trainer at full width, through its entry points."""
    import torch
    from arco_torch.config import ArcoConfig, DataConfig
    from arco_torch.kernels import launch_counts, reset_launch_counts
    from arco_torch.models import net_factory
    from arco_torch.train import arco2d
    data = DataConfig()
    cfg = ArcoConfig(use_photometric=False, use_adv_morph=False)
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
    step = arco2d.make_arco_step(mods, cfg, num_classes=data.num_classes,
                                 max_iterations=30000, device=device)
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
    for _ in range(STEPS):
        image_l, label_l = _synthetic_batch(b_l, hw, gen, device)
        image_u, _ = _synthetic_batch(b_u, hw, gen, device)
        batches.append({"image_l": image_l, "label_l": label_l,
                        "image_u": image_u})
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    step_ms, metrics = [], []
    for batch in batches:
        t0 = time.perf_counter()
        m = step(state, batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        metrics.append(m)
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    for i, m in enumerate(metrics):
        terms = {k: float(v) for k, v in m.items() if v.ndim == 0}
        _log(f"step {i}: {step_ms[i]:.1f} ms " + json.dumps(terms))
        bad = [k for k, v in terms.items() if not math.isfinite(v)]
        if bad:
            raise AssertionError(f"step {i}: non-finite {bad}")
        if tuple(m["pred_l_label"].shape) != (b_l, hw, hw):
            raise AssertionError(f"pred_l_label {m['pred_l_label'].shape}")
    if state.step != STEPS \
            or state.random_pool_ptr != STEPS * b_u % cfg.K:
        raise AssertionError("the step counter or pool pointer is off")
    if bool((state.memobank.ptr == 1).all()):
        raise AssertionError("no keys reached the memory bank")
    _log(f"launches over {STEPS} steps: {counts}")
    for name, n in counts.items():
        if n != STEPS:
            raise AssertionError(f"{name} launched {n} times in {STEPS} "
                                 "steps")
    _log(f"step ms {[round(t, 2) for t in step_ms]}; peak memory "
         f"{peak / 2**30:.2f} GiB")
    return counts


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
    counts = phase_main_path(device)
    for k in kernels:
        k["launches"] = counts[k["name"]]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
