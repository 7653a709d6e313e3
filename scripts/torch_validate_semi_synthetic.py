#!/usr/bin/env python3
"""Method-quality gate of the PyTorch port: ARCO against supervised-only
on the synthetic tasks of ``scripts/validate_semi_synthetic.py`` (the JAX
package's gate), trained through ``arco_torch`` on one CUDA GPU.

The protocol is the JAX script's, field for field:

  warmup: ``--warm-steps`` supervised steps on the 2 labeled slices;
  arm (a): + ``--tune-steps`` more supervised-only steps;
  arm (b): + ``--tune-steps`` full-ARCO steps (pseudo-labels, cutmix,
      contrastive memory bank, revisiting, TPS-eqv) from the warm weights.

Both arms start from the warm weights with ``seed + 1``; the warmup runs
with ``seed``. Each run is the port's stage-2 step
(``train.arco2d.make_arco_step``) on a U-Net at 256x256, 3 classes, bs
4+4, bf16 autocast on the card (f32 on the CPU), SGD at base LR 0.01 with
the poly schedule over the arm's steps. The data is the JAX script's to the
bit: the same numpy generators on ``np.random.RandomState(seed)``, and the
same batch-index stream (``batch_indices``). ``--arms`` also takes the
per-term triage arms (``arco_nounsup``, ``arco_norevisit``,
``arco_noreco``, ``arco_unsuponly``, ``arco_confmask``): full ARCO with one
term changed, each scored on the whole validation set.

The 3D task runs the JAX script's 3D branch: a V-Net on 64x64x32 volumes
with the 3D trainer's heads (feature maps 128, 64, 32, 16, 16 fused to 16)
at bs 2+2, and the 3D trainer's method config (the eqv term neither in the
loss nor computed, no photometric aug or AdvMorph, a ``randn`` bank).

Tasks (see the JAX script for their design):
  shifted  intensity-coded classes under a per-image appearance shift
           (gain, offset, smooth bias field, noise); labeled images at
           the canonical appearance, validation stratified over the gain
           range. Artifact ``quality_gate.json``.
  striped  frequency-coded stripe textures at one random orientation an
           image; labeled images at 0 degrees, validation over [0, 90].
           Artifact ``quality_gate_striped.json``.
  noisy3d  intensity-coded 3-D classes under voxel noise of sigma 0.26,
           2 labeled volumes (the JAX artifact's protocol; the JAX
           script's defaults are 0.22 and 4). Its arms are ``sup``,
           ``arco`` (the reference formula) and ``arco_confmask`` (the
           unsup CE confidence-masked), the gated one. Artifact
           ``quality_gate_noisy3d_confmask.json``: the JAX script's
           confmask schema, ``arco_dice`` the confmask arm's and the
           reference formula's kept as ``ref_formula_arco_dice``.

The artifact has the JAX artifacts' schema (``tests/test_quality_gate.py``
reads theirs, ``tests/test_torch_quality_gate.py`` this one) with
``"backend"`` the torch device type, plus the card's name and power limit
as ``nvidia-smi`` prints them, the torch version, the commit, a hash of the
port's sources, and each arm's seconds, ms a step, peak memory, final loss,
non-finite losses and kernel launches. Each seed's run is written as soon
as it ends; a rerun with other ``--seeds`` into the same ``--out`` merges
the runs by seed and recomputes the summary, so the seeds can run in
separate processes. It refuses, before any seed runs, an artifact of
another protocol, card, torch or sources (a checkout whose ``arco_torch``
or this script differs from the one that wrote it: use another
``--out``):

    python3 scripts/torch_validate_semi_synthetic.py --task shifted \\
        --seeds 0 --warm-steps 150 --tune-steps 1500 \\
        --out docs/artifacts/quality_gate_torch
    (then --seeds 1, then --seeds 2, with the same --out)
    python3 scripts/torch_validate_semi_synthetic.py --task noisy3d \
        --seeds 0 --warm-steps 300 --tune-steps 1500 \
        --out docs/artifacts/quality_gate_torch
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import hashlib
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from arco_torch import resolve_device  # noqa: E402
from arco_torch.config import ArcoConfig, OptimConfig  # noqa: E402
from arco_torch.kernels import launch_counts  # noqa: E402
from arco_torch.models import net_factory, net_factory_3d  # noqa: E402
from arco_torch.train.arco2d import (init_arco_state,  # noqa: E402
                                     make_arco_modules, make_arco_step)

HW, B, K = 256, 4, 3
N_LABELED, N_UNLABELED, N_VAL = 2, 128, 32
N_WARM, N_TUNE = 150, 450
# the 3D task: volume, labeled and total batch, the 3D trainer's heads
VOL, B3_L, B3 = (64, 64, 32), 2, 4
FEATURES_3D, FUSED_3D = (128, 64, 32, 16, 16), 16
# noisy3d's noise sigma and labeled volumes: the gate's protocol, as the
# JAX artifact ran it (--noise3d 0.26 --labeled3d 2; that script's
# defaults are 0.22 and 4)
NOISE3D, LABELED3D = 0.26, 2
# the shifted task's appearance range: gains >= 1 only, offsets +-0.10
GAIN_LO, GAIN_HI, OFF_MAX = 1.0, 1.5, 0.10
TASKS = ("shifted", "striped", "noisy3d")
ARMS_3D = ("sup", "arco", "arco_confmask")
# SGD, nesterov momentum 0.9, weight decay 1e-4, poly 0.9 over the arm's
# steps from LR 0.01
OPTIM = OptimConfig(base_lr=0.01)
# the per-term triage arms: the full-ARCO config with one term changed
TERM_ARMS = {
    "arco_nounsup": dict(compute_unsup=False),
    "arco_norevisit": dict(compute_revisit=False),
    "arco_noreco": dict(compute_contrastive=False),
    "arco_unsuponly": dict(compute_revisit=False, compute_contrastive=False),
    "arco_confmask": dict(unsup_conf_mask=True),
}
# the artifact's fields that runs merged into one file must share
SHARED = ("task", "hw", "n_labeled", "n_unlabeled", "warm_steps",
          "tune_steps", "backend", "compute_dtype", "device", "torch",
          "source_sha256", "init", "vol", "batch", "noise_sigma",
          "labeled_volumes")


# ---- data: numpy on np.random.RandomState, bit-identical to the JAX
# script's

def _cubic_weights(m, n):
    """[m, n] f32 weights of an m -> n Keys-cubic upsampling (a = -0.5,
    half-pixel centres, each column normalized to sum 1), as
    jax.image.resize computes them in f32."""
    f32 = np.float32
    sample = (np.arange(n, dtype=f32) + f32(0.5)) * (f32(1.0) / f32(n / m)) \
        - f32(0.5)
    x = np.abs(sample[None, :] - np.arange(m, dtype=f32)[:, None])
    near = ((f32(1.5) * x - f32(2.5)) * x) * x + f32(1.0)
    far = ((f32(-0.5) * x + f32(2.5)) * x - f32(4.0)) * x + f32(2.0)
    w = np.where(x >= 2, f32(0.0), np.where(x >= 1, far, near)).astype(f32)
    total = w.sum(0, keepdims=True, dtype=f32)
    w = np.where(np.abs(total) > 1000 * np.finfo(f32).eps,
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample >= -0.5) & (sample <= m - 0.5)
    return np.where(inside[None, :], w, f32(0.0)).astype(f32)


def _contract(a, w):
    """a [..., m] @ w [m, n] in f32, each product added to the running sum
    with one rounding (a fused multiply-add; the f64 product of two f32s is
    exact), in the order of m."""
    acc = np.zeros(a.shape[:-1] + (w.shape[1],), np.float32)
    for k in range(w.shape[0]):
        acc = (acc.astype(np.float64) + a[..., k:k + 1].astype(np.float64)
               * w[k].astype(np.float64)).astype(np.float32)
    return acc


def resize_bicubic(x, hw):
    """jax.image.resize(x, (hw, hw), "bicubic") of an f32 [m, m] array, to
    the bit: the first axis contracted first, then the second."""
    w = _cubic_weights(x.shape[0], hw)
    return _contract(_contract(x.T, w).T, w)


def _bias_field(rng, hw, strength):
    """Smooth multiplicative field in [1-s, 1+s] from a coarse grid."""
    coarse = rng.uniform(-1.0, 1.0, (4, 4)).astype(np.float32)
    return 1.0 + strength * resize_bicubic(coarse, hw)


def _blob_labels(rng, xx, yy, s_lo, s_hi):
    """Three gaussian blobs a foreground class over a 0.55 background; the
    label is the argmax."""
    fields = []
    for _ in range(K - 1):
        f = np.zeros(xx.shape, np.float32)
        for _ in range(3):
            cx, cy = rng.uniform(-0.7, 0.7, 2)
            s = rng.uniform(s_lo, s_hi)
            f += np.exp(-((xx - cx) ** 2 + (yy - cy) ** 2) / (2 * s * s))
        fields.append(f)
    stack = np.stack([0.55 * np.ones_like(yy)] + fields)
    return stack.argmax(0).astype(np.int32)


def make_task_shifted(rng, n, gains=None, offsets=None, hw=HW):
    """Intensity-coded classes (0.35 / 0.62 / 0.88) under a per-image
    shift: clip(gain * bias_field * level + offset + noise), gain
    U[GAIN_LO, GAIN_HI], offset U[-OFF_MAX, OFF_MAX] unless pinned."""
    xs = np.linspace(-1, 1, hw)
    yy, xx = np.meshgrid(xs, xs, indexing="ij")
    levels = np.array([0.35, 0.62, 0.88], np.float32)
    images, labels = [], []
    for i in range(n):
        label = _blob_labels(rng, xx, yy, 0.10, 0.28)
        base = levels[label]
        gain = (gains[i] if gains is not None
                else rng.uniform(GAIN_LO, GAIN_HI))
        offset = (offsets[i] if offsets is not None
                  else rng.uniform(-OFF_MAX, OFF_MAX))
        field = _bias_field(rng, hw, 0.10)
        image = np.clip(gain * field * base + offset
                        + 0.13 * rng.randn(hw, hw), 0.0, 1.5)
        images.append(image.astype(np.float32)[..., None])
        labels.append(label)
    return np.stack(images), np.stack(labels)


def make_task_striped(rng, n, thetas=None, hw=HW):
    """Stripe textures of mean 0.5 (the background's level) with periods 16
    and 6 px for classes 1 and 2, at one orientation theta an image
    (U[0, 90] degrees unless pinned), plus noise."""
    xs = np.linspace(-1, 1, hw)
    yy, xx = np.meshgrid(xs, xs, indexing="ij")
    periods = {1: 16.0, 2: 6.0}
    images, labels = [], []
    for i in range(n):
        label = _blob_labels(rng, xx, yy, 0.12, 0.30)
        theta = (thetas[i] if thetas is not None
                 else rng.uniform(0.0, 90.0)) * np.pi / 180.0
        px = (xx * np.cos(theta) + yy * np.sin(theta)) * (hw / 2)
        image = np.full((hw, hw), 0.5, np.float32)
        for c, period in periods.items():
            tex = 0.5 + 0.3 * np.sin(2 * np.pi * px / period)
            image = np.where(label == c, tex, image)
        image = np.clip(image + 0.12 * rng.randn(hw, hw), 0.0, 1.5)
        images.append(image.astype(np.float32)[..., None])
        labels.append(label)
    return np.stack(images), np.stack(labels)


def make_task_noisy3d(rng, n, vol=VOL):
    """Intensity-coded classes (0.35 / 0.62 / 0.88) from three 3-D gaussian
    blobs a foreground class, plus voxel noise of sigma ``NOISE3D``:
    levels about one sigma apart, so one voxel alone is an unreliable
    guess."""
    X, Y, Z = vol
    xs = np.linspace(-1, 1, X)
    ys = np.linspace(-1, 1, Y)
    zz = np.linspace(-1, 1, Z)
    gx, gy, gz = np.meshgrid(xs, ys, zz, indexing="ij")
    levels = np.array([0.35, 0.62, 0.88], np.float32)
    images, labels = [], []
    for i in range(n):
        fields = []
        for c in range(K - 1):
            f = np.zeros(vol, np.float32)
            for _ in range(3):
                cx, cy, cz = rng.uniform(-0.6, 0.6, 3)
                s = rng.uniform(0.15, 0.35)
                f += np.exp(-((gx - cx) ** 2 + (gy - cy) ** 2
                              + (gz - cz) ** 2) / (2 * s * s))
            fields.append(f)
        stack = np.stack([0.55 * np.ones(vol, np.float32)] + fields)
        label = stack.argmax(0).astype(np.int32)
        image = np.clip(levels[label] + NOISE3D * rng.randn(*vol), 0.0,
                        1.5)
        images.append(image.astype(np.float32)[..., None])
        labels.append(label)
    return np.stack(images), np.stack(labels)


def make_data(task, seed, hw=HW, n_unlabeled=N_UNLABELED, n_val=N_VAL,
              vol=VOL):
    """(img_l, lab_l, img_u, img_v, lab_v), images NHWC (NXYZC in 3D) f32,
    labels int32: labeled images at the canonical appearance, validation
    stratified over the task's range (contiguous index ranges are its
    buckets); noisy3d draws all three sets alike."""
    if task not in TASKS:
        raise ValueError(f"task {task!r} is not one of {TASKS}")
    rng = np.random.RandomState(seed)
    if task == "noisy3d":
        img_l, lab_l = make_task_noisy3d(rng, LABELED3D, vol)
        img_u, _ = make_task_noisy3d(rng, n_unlabeled, vol)
        img_v, lab_v = make_task_noisy3d(rng, n_val, vol)
        return img_l, lab_l, img_u, img_v, lab_v
    if task == "striped":
        img_l, lab_l = make_task_striped(rng, N_LABELED,
                                         thetas=np.zeros(N_LABELED), hw=hw)
        img_u, _ = make_task_striped(rng, n_unlabeled, hw=hw)
        img_v, lab_v = make_task_striped(
            rng, n_val, thetas=np.linspace(0.0, 90.0, n_val), hw=hw)
        return img_l, lab_l, img_u, img_v, lab_v
    img_l, lab_l = make_task_shifted(rng, N_LABELED,
                                     gains=np.ones(N_LABELED),
                                     offsets=np.zeros(N_LABELED), hw=hw)
    img_u, _ = make_task_shifted(rng, n_unlabeled, hw=hw)
    val_gains = np.linspace(GAIN_LO, GAIN_HI, n_val)
    val_offsets = np.linspace(-OFF_MAX, OFF_MAX, n_val)
    rng.shuffle(val_offsets)
    img_v, lab_v = make_task_shifted(rng, n_val, gains=val_gains,
                                     offsets=val_offsets, hw=hw)
    return img_l, lab_l, img_u, img_v, lab_v


def dice(pred, label, num_classes):
    scores = []
    for c in range(1, num_classes):
        p, l = pred == c, label == c
        denom = p.sum() + l.sum()
        if denom == 0:
            continue
        scores.append(2.0 * (p & l).sum() / denom)
    return float(np.mean(scores)) if scores else 1.0


# ---- training and evaluation through arco_torch

def compute_dtype(device):
    """bf16 on the card, f32 on the CPU (the JAX script's rule)."""
    return torch.bfloat16 if device.type == "cuda" else torch.float32


def _autocast(device, dtype):
    if dtype == torch.bfloat16:
        return torch.autocast(device.type, dtype=dtype)
    return contextlib.nullcontext()


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def batch_indices(seed, n_l, n_u, b_l=B, b_u=B):
    """The run's batches: labeled then unlabeled indices each step from
    np.random.RandomState(seed), the JAX script's order."""
    rng = np.random.RandomState(seed)
    while True:
        li = rng.randint(0, n_l, b_l)
        ui = rng.randint(0, n_u, b_u)
        yield li, ui


def _nchw(images, device):
    """Channels-last numpy images (2-D or 3-D) as a channels-first tensor
    on ``device``."""
    return torch.from_numpy(
        np.ascontiguousarray(np.moveaxis(images, -1, 1))).to(device)


def run(cfg, tag, steps, data, device, warm=None, seed=0, hw=HW,
        dtype=None):
    """``steps`` stage-2 steps of ``cfg`` from a U-Net (a V-Net for 3-D
    data) seeded with ``seed`` (its weights and BatchNorm statistics
    replaced by ``warm``, a state dict, where given; the heads, bank and
    pool are fresh), in ``dtype`` (default: ``compute_dtype(device)``).
    ``data``: (img_l, lab_l, img_u) tensors on ``device``, NCHW (NCXYZ).
    Returns the student and a record of the run."""
    img_l, lab_l, img_u = data
    torch.manual_seed(seed)
    if img_l.ndim == 5:
        # the 3D trainer's modules (the JAX script's run)
        b_l, b_u, vol = B3_L, B3 - B3_L, tuple(img_l.shape[2:])
        model = net_factory_3d("vnet", in_chns=1, class_num=K)
        if warm is not None:
            model.load_state_dict(warm)
        modules = make_arco_modules(model, vol[1], vol[0], batch_size=b_l,
                                    total_batch=B3,
                                    feature_channels=FEATURES_3D,
                                    fused_dim=FUSED_3D)
        shape = (b_l, 1) + vol
    else:
        b_l = b_u = B
        model = net_factory("unet", in_chns=1, class_num=K)
        if warm is not None:
            model.load_state_dict(warm)
        modules = make_arco_modules(model, hw, hw, batch_size=B)
        shape = (B, 1, hw, hw)
    state = init_arco_state(modules, cfg, shape, OPTIM, seed=seed,
                            device=device,
                            compute_dtype=dtype or compute_dtype(device))
    step_fn = make_arco_step(modules, cfg, num_classes=K,
                             max_iterations=steps, optim=OPTIM, device=device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    # every step's indices in one copy: a copy a step would make the host
    # wait for the card each step
    index = batch_indices(seed, len(img_l), len(img_u), b_l, b_u)
    drawn = [next(index) for _ in range(steps)]
    li_all, ui_all = (torch.from_numpy(np.array([d[i] for d in drawn],
                                                np.int64).reshape(steps, b))
                      .to(device) for i, b in ((0, b_l), (1, b_u)))
    nonfinite = torch.zeros((), dtype=torch.int32, device=device)
    launches = launch_counts()
    _sync(device)
    t0 = time.perf_counter()
    for li, ui in zip(li_all, ui_all):
        metrics = step_fn(state, {"image_l": img_l[li], "label_l": lab_l[li],
                                  "image_u": img_u[ui]})
        nonfinite += (~torch.isfinite(metrics["loss"])).to(torch.int32)
    _sync(device)
    dt = time.perf_counter() - t0
    launches = {k: v - launches[k] for k, v in launch_counts().items()}
    record = {"steps": steps, "s": round(dt, 3),
              "ms_per_step": round(dt / max(steps, 1) * 1e3, 3),
              "final_loss": float(metrics["loss"]) if steps else None,
              "nonfinite_losses": int(nonfinite),
              "launches": launches}
    if device.type == "cuda":
        record["peak_gib"] = round(
            torch.cuda.max_memory_allocated(device) / 2 ** 30, 3)
    print(f"{tag}: {steps} steps in {dt:.0f}s ({record['ms_per_step']:.1f} "
          f"ms a step, final loss {record['final_loss']})", flush=True)
    return state.model, record


def logits(model, images, device, dtype=None):
    """Eval-mode logits [B, K, *spatial] of channels-last numpy ``images``
    in ``dtype`` (default: ``compute_dtype(device)``)."""
    with torch.no_grad(), _autocast(device, dtype or compute_dtype(device)):
        return model(_nchw(images, device))[0]


def predict(model, images, device, dtype=None):
    """Argmax labels [N, *spatial] int32 of an eval-mode forward, in chunks
    of B (of B3_L volumes in 3-D), the last one padded as the JAX script
    pads it."""
    was_training = model.training
    model.eval()
    out = []
    eb = B3_L if images.ndim == 5 else B
    for i in range(0, len(images), eb):
        chunk = images[i:i + eb]
        n = len(chunk)
        if n < eb:
            chunk = np.concatenate([chunk, chunk[:eb - n]])
        labels = logits(model, chunk, device, dtype).argmax(1).to(
            torch.int32)
        out.append(labels.cpu().numpy()[:n])
    model.train(was_training)
    return np.concatenate(out)


def evaluate(model, img_val, lab_val, device, dtype=None):
    preds = predict(model, img_val, device, dtype)
    return float(np.mean([dice(p, l, K) for p, l in zip(preds, lab_val)]))


def evaluate_buckets(model, img_v, lab_v, device, n_buckets=4, dtype=None):
    """Dice a bucket of contiguous validation images (the task's range in
    order: where does an arm fail?)."""
    per = len(img_v) // n_buckets
    return [round(evaluate(model, img_v[i * per:(i + 1) * per],
                           lab_v[i * per:(i + 1) * per], device, dtype), 4)
            for i in range(n_buckets)]


def load_jax_initial_unet(init_dir, seed):
    """The U-Net state dict that JAX's gate starts its warmup from under
    ``seed``, as ``tests/torch_gate_warmup_parity.py --save-init`` wrote
    it into ``init_dir``."""
    return torch.load(os.path.join(init_dir, f"unet_jax_init_s{seed}.pt"))


def configs(cfg_override=None, task=None):
    """(sup_cfg, arco_cfg): supervised-only is ArcoConfig with every
    method term and strong augmentation off; for noisy3d the ARCO config is
    the 3D trainer's (the eqv term neither in the loss nor computed, no
    photometric aug or AdvMorph, a randn bank). ``cfg_override`` (a dict of
    ArcoConfig fields, for small test sizes) applies to both."""
    sup_cfg = ArcoConfig(compute_contrastive=False, compute_unsup=False,
                         compute_revisit=False, compute_eqv=False,
                         use_eqv_loss=False, use_photometric=False,
                         use_adv_morph=False)
    arco_cfg = ArcoConfig()
    if task == "noisy3d":
        arco_cfg = dataclasses.replace(
            arco_cfg, use_eqv_loss=False, compute_eqv=False,
            use_photometric=False, use_adv_morph=False,
            memobank_init="randn")
    if cfg_override:
        sup_cfg = dataclasses.replace(sup_cfg, **cfg_override)
        arco_cfg = dataclasses.replace(arco_cfg, **cfg_override)
    return sup_cfg, arco_cfg


def run_seed(task, seed, device, arms=("sup", "arco"), n_tune=N_TUNE,
             n_warm=N_WARM, hw=HW, n_unlabeled=N_UNLABELED, n_val=N_VAL,
             cfg_override=None, init=None, vol=VOL):
    """One seed of the gate: the warmup (from the U-Net state dict
    ``init`` where given, else the one ``run`` draws), then each arm of
    ``arms`` from the warm weights. Returns the run's record."""
    device = torch.device(device)
    t_seed = time.perf_counter()
    img_l, lab_l, img_u, img_v, lab_v = make_data(
        task, seed, hw=hw, n_unlabeled=n_unlabeled, n_val=n_val, vol=vol)
    data = (_nchw(img_l, device), torch.from_numpy(lab_l).to(device),
            _nchw(img_u, device))
    sup_cfg, arco_cfg = configs(cfg_override, task)

    model, rec = run(sup_cfg, f"[s{seed}] warmup", n_warm, data, device,
                     warm=init, seed=seed, hw=hw)
    warm = {k: v.detach().clone() for k, v in model.state_dict().items()}
    out = {"seed": seed,
           "warmup_dice": evaluate(model, img_v, lab_v, device)}
    timing = {"warmup": rec}
    del model
    print(f"[s{seed}] warmup dice: {out['warmup_dice']:.4f}", flush=True)

    if "sup" in arms:
        m, timing["supervised"] = run(
            sup_cfg, f"[s{seed}] arm a: +supervised", n_tune, data, device,
            warm, seed=seed + 1, hw=hw)
        out["supervised_dice"] = evaluate(m, img_v, lab_v, device)
        out["supervised_buckets"] = evaluate_buckets(m, img_v, lab_v, device)
        print(f"[s{seed}] supervised-only dice: "
              f"{out['supervised_dice']:.4f} "
              f"buckets={out['supervised_buckets']}", flush=True)
        del m
    if "arco" in arms:
        m, timing["arco"] = run(arco_cfg, f"[s{seed}] arm b: +full ARCO",
                                n_tune, data, device, warm, seed=seed + 1,
                                hw=hw)
        out["arco_dice"] = evaluate(m, img_v, lab_v, device)
        out["arco_buckets"] = evaluate_buckets(m, img_v, lab_v, device)
        print(f"[s{seed}] ARCO dice: {out['arco_dice']:.4f} "
              f"buckets={out['arco_buckets']}", flush=True)
        del m
    for arm, delta in TERM_ARMS.items():
        if arm not in arms:
            continue
        m, timing[arm] = run(dataclasses.replace(arco_cfg, **delta),
                             f"[s{seed}] arm {arm}", n_tune, data, device,
                             warm, seed=seed + 1, hw=hw)
        out[f"{arm}_dice"] = evaluate(m, img_v, lab_v, device)
        print(f"[s{seed}] {arm} dice: {out[f'{arm}_dice']:.4f}", flush=True)
        del m

    if "sup" in arms and "arco" in arms:
        out["gain"] = round(out["arco_dice"] - out["supervised_dice"], 4)
    out["timing"] = timing
    out["seconds"] = round(time.perf_counter() - t_seed, 1)
    return out


# ---- the artifact

def summarize(runs):
    """The JAX artifacts' summary, or None unless every run has a gain."""
    if not runs or not all("gain" in r for r in runs):
        return None
    return {
        "mean_supervised": round(float(np.mean(
            [r["supervised_dice"] for r in runs])), 4),
        "mean_arco": round(float(np.mean([r["arco_dice"] for r in runs])),
                           4),
        "mean_gain": round(float(np.mean([r["gain"] for r in runs])), 4),
        "min_gain": round(float(np.min([r["gain"] for r in runs])), 4)}


def confmask_run(run):
    """A noisy3d run in the JAX script's confmask schema: the confmask arm
    plays ARCO's part, the reference formula's Dice is kept beside it, and
    the gain is the confmask arm's over supervised-only."""
    return {"seed": run["seed"], "warmup_dice": run["warmup_dice"],
            "supervised_dice": run["supervised_dice"],
            "ref_formula_arco_dice": run["arco_dice"],
            "arco_dice": run["arco_confmask_dice"],
            "gain": round(run["arco_confmask_dice"]
                          - run["supervised_dice"], 4),
            "timing": run["timing"], "seconds": run["seconds"]}


def artifact_name(task):
    if task == "shifted":
        return "quality_gate.json"
    if task == "noisy3d":
        return "quality_gate_noisy3d_confmask.json"
    return f"quality_gate_{task}.json"


def read_compatible(path, results, shared=SHARED):
    """The artifact at ``path``, or None where there is none. Refused
    unless its protocol, card, torch and sources (the ``shared`` keys) are
    those of ``results``."""
    if not os.path.exists(path):
        return None
    with open(path) as f:
        old = json.load(f)
    for key in shared:
        if old.get(key) != results.get(key):
            raise SystemExit(
                f"{path} holds runs with {key}={old.get(key)!r}, this "
                f"run has {results.get(key)!r}: use another --out")
    return old


def merge(path, results, shared=SHARED, summarize_runs=summarize):
    """``results`` with the runs of the artifact at ``path`` whose seeds it
    does not hold, sorted by seed, and the summary recomputed by
    ``summarize_runs``."""
    runs = {r["seed"]: r for r in results["runs"]}
    old = read_compatible(path, results, shared)
    for r in old["runs"] if old else ():
        runs.setdefault(r["seed"], r)
    merged = {**results, "runs": [runs[s] for s in sorted(runs)]}
    summary = summarize_runs(merged["runs"])
    merged.pop("summary", None)
    if summary is not None:
        merged["summary"] = summary
    return merged


def device_entry(device):
    """The card's name and power limit as ``nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader`` prints them; "cpu" on the CPU."""
    if device.type != "cuda":
        return "cpu"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return out[device.index or 0]


def source_sha256(script=__file__):
    """sha256 over the port's sources (arco_torch's .py, .cu and headers)
    and ``script`` (this one by default), by path: which code trained the
    runs."""
    h = hashlib.sha256()
    files = [p for p in sorted((REPO / "arco_torch").rglob("*"))
             if p.suffix in (".py", ".cu", ".h", ".cuh")]
    for p in files + [Path(script).resolve()]:
        h.update(str(p.relative_to(REPO)).encode() + b"\0")
        h.update(p.read_bytes())
    return h.hexdigest()


def git_commit():
    """The checkout's commit, with "-dirty" where the tracked files differ
    from it (``source_sha256`` then names the sources); None outside a
    checkout."""
    try:
        return subprocess.run(["git", "describe", "--always", "--dirty",
                               "--abbrev=40"], cwd=REPO,
                              capture_output=True, text=True, check=True,
                              timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return None


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--task", default="shifted", choices=TASKS)
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    ap.add_argument("--arms", nargs="+", default=None,
                    choices=["sup", "arco", *TERM_ARMS],
                    help="default: sup arco (noisy3d: sup arco "
                         "arco_confmask, which it needs)")
    ap.add_argument("--tune-steps", type=int, default=N_TUNE)
    ap.add_argument("--warm-steps", type=int, default=N_WARM)
    ap.add_argument("--out", default=None,
                    help="artifact dir; writes quality_gate.json (shifted) "
                         "or quality_gate_<task>.json")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--init-dir", default=None,
                    help="start each seed's warmup from DIR/unet_jax_init_"
                         "s<seed>.pt, the U-Net JAX's gate starts from "
                         "(tests/torch_gate_warmup_parity.py --save-init "
                         "DIR writes them), not from the port's own draw")
    ap.add_argument("--commit", default=None,
                    help="the commit recorded in the artifact (default: "
                         "git describe --always --dirty of the checkout)")
    args = ap.parse_args(argv)
    is3d = args.task == "noisy3d"
    arms = tuple(args.arms or (ARMS_3D if is3d else ("sup", "arco")))
    if is3d and not set(ARMS_3D) <= set(arms):
        raise SystemExit(f"noisy3d writes the confmask artifact: --arms "
                         f"must hold {' '.join(ARMS_3D)}")
    if is3d and args.init_dir:
        raise SystemExit("--init-dir holds U-Nets: noisy3d runs a V-Net")

    device = resolve_device(args.device)
    # f32 work outside autocast stays f32 (the port's CLIs' setting)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    results = {"task": args.task, "hw": HW, "n_labeled": N_LABELED,
               "n_unlabeled": N_UNLABELED, "warm_steps": args.warm_steps,
               "tune_steps": args.tune_steps, "backend": device.type,
               "compute_dtype": str(compute_dtype(device)).split(".")[-1],
               "device": device_entry(device), "torch": torch.__version__,
               "commit": args.commit or git_commit(),
               "source_sha256": source_sha256(), "runs": []}
    if args.init_dir:
        results["init"] = "jax"
    if is3d:
        # the JAX script's noisy3d fields
        results.update(task="noisy3d_confmask", n_labeled=LABELED3D,
                       vol=list(VOL), batch=[B3_L, B3 - B3_L],
                       noise_sigma=NOISE3D, labeled_volumes=LABELED3D)
    print(f"{results['device']}; torch {results['torch']}; "
          f"{results['compute_dtype']}", flush=True)
    path = os.path.join(args.out, artifact_name(args.task)) \
        if args.out else None
    if path:
        read_compatible(path, results)  # refuse before any seed runs
    for s in args.seeds:
        init = load_jax_initial_unet(args.init_dir, s) \
            if args.init_dir else None
        run = run_seed(args.task, s, device, arms=arms,
                       n_tune=args.tune_steps, n_warm=args.warm_steps,
                       init=init)
        results["runs"].append(confmask_run(run) if is3d else run)
        if path:
            os.makedirs(args.out, exist_ok=True)
            merged = merge(path, results)
            with open(path, "w") as f:
                json.dump(merged, f, indent=1)
            print(f"wrote {path} (seeds "
                  f"{[r['seed'] for r in merged['runs']]})", flush=True)
    summary = summarize(results["runs"])
    if summary is not None:
        print(json.dumps(summary))
    return results


if __name__ == "__main__":
    main()
