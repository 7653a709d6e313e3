#!/usr/bin/env python3
"""Natural-image method-quality gate of the PyTorch port: the counterpart
of ``scripts/validate_natural.py`` (the JAX package's), driving the port's
own ``arco_torch.cli.train_arco_natural`` and ``eval_natural`` in-process
over a synthetic Pascal-layout tree on one CUDA GPU.

The protocol is the JAX script's with ``--mechanism striped`` (its
committed artifact, ``quality_gate_natural.json``): a U-Net at 64x64, 4
classes, 40 train and 8 val images, ``--label_num 2``, bs 4, small banks
(``SMALL``). Each seed writes its fixture (JPEG q95 images, PNG labels,
with PIL), runs a shared supervised warmup of ``WARM_ITERS`` iterations,
then the two arms from it through ``--resume_snapshot``: ``sup`` (the
method's loss weights zeroed and eqv off, ``SUP_OFF``) and ``arco``, each
``ITERS`` iterations, each scored by ``eval_natural`` (mIoU over the val
set).

Classes are stripe textures of one mean intensity that differ in
frequency, one random orientation an image; the first ``LABEL_NUM`` train
images are drawn at 0 degrees, the val images over [0, 90].

The artifact has the JAX artifact's schema plus the card's name and power
limit as ``nvidia-smi`` prints them, the torch version, the commit, a hash
of the port's sources and this script, and per arm the seconds, ms a step,
peak memory, non-finite losses and kernel launches. Runs into one
``--out`` merge by seed, as ``torch_validate_semi_synthetic.py``'s do:

    python3 scripts/torch_validate_natural.py --seeds 0 1 2 \\
        --out docs/artifacts/quality_gate_torch
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
from PIL import Image

SCRIPTS = Path(__file__).resolve().parent
for p in (SCRIPTS.parent, SCRIPTS):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

from arco_torch import resolve_device  # noqa: E402
from arco_torch.cli import eval_natural, train_arco_natural  # noqa: E402
from arco_torch.kernels import launch_counts  # noqa: E402
from torch_validate_semi_synthetic import (device_entry,  # noqa: E402
                                           git_commit, merge,
                                           read_compatible, source_sha256)

HW = 64
K_CLS = 4
N_TRAIN, N_VAL = 40, 8
LABEL_NUM = 2
ITERS = 600
WARM_ITERS = 300
MECHANISM = "striped"
MODEL = "unet"
ARTIFACT = "quality_gate_natural.json"
# the artifact's fields that runs merged into one file must share
SHARED = ("task", "hw", "model", "n_train", "label_num", "iters",
          "warm_iters", "backend", "compute_dtype", "device", "torch",
          "source_sha256")


def _striped_rgb(rng, theta_deg):
    """One image / label pair: three disc classes whose stripe periods
    (14, 7, 3.5 px) code the class at the background's mean intensity, at
    one orientation ``theta_deg``, plus noise; RGB uint8."""
    label = np.zeros((HW, HW), np.uint8)
    yy, xx = np.mgrid[0:HW, 0:HW]
    for c in range(1, K_CLS):
        cy, cx = rng.randint(HW // 4, 3 * HW // 4, 2)
        r = rng.randint(HW // 8, HW // 4)
        label[(yy - cy) ** 2 + (xx - cx) ** 2 < r * r] = c
    th = theta_deg * np.pi / 180.0
    px = (xx * np.cos(th) + yy * np.sin(th))
    periods = {1: 14.0, 2: 7.0, 3: 3.5}
    img = np.full((HW, HW), 0.5, np.float32)
    for c, period in periods.items():
        tex = 0.5 + 0.3 * np.sin(2 * np.pi * px / period)
        img = np.where(label == c, tex, img)
    img = np.clip(img + 0.08 * rng.randn(HW, HW), 0.0, 1.0)
    rgb = np.stack([img] * 3, axis=-1)
    rgb = rgb + 0.02 * rng.randn(HW, HW, 3).astype(np.float32)
    return (np.clip(rgb, 0, 1) * 255).astype(np.uint8), label


def make_fixture(root, seed):
    """The Pascal layout (JPEGImages, SegmentationClassAug, ImageSets/
    Segmentation/{train,val}.txt) of the striped task under ``root``, drawn
    from np.random.RandomState(seed) in the JAX script's order."""
    rng = np.random.RandomState(seed)
    os.makedirs(os.path.join(root, "JPEGImages"))
    os.makedirs(os.path.join(root, "SegmentationClassAug"))
    sets = os.path.join(root, "ImageSets", "Segmentation")
    os.makedirs(sets)
    names = {"train": [f"tr_{i:03d}" for i in range(N_TRAIN)],
             "val": [f"va_{i:03d}" for i in range(N_VAL)]}
    for split, ns in names.items():
        with open(os.path.join(sets, f"{split}.txt"), "w") as f:
            f.write("\n".join(ns) + "\n")
        for i, n in enumerate(ns):
            if split == "train" and i < LABEL_NUM:
                theta = 0.0                 # canonical labeled picks
            elif split == "train":
                theta = rng.uniform(0.0, 90.0)
            else:
                theta = np.linspace(0.0, 90.0, N_VAL)[i]
            img, lab = _striped_rgb(rng, theta)
            Image.fromarray(img).save(
                os.path.join(root, "JPEGImages", f"{n}.jpg"), quality=95)
            Image.fromarray(lab).save(
                os.path.join(root, "SegmentationClassAug", f"{n}.png"))
    return root


SMALL = ["--set", "memobank_size=512", "--set", "memobank_size_bg=512",
         "--set", "num_queries=32", "--set", "num_negatives=64",
         "--set", "K=8", "--set", "memobank_enqueue=64"]
SUP_OFF = ["--set", "k1=0", "--set", "k3=0", "--set", "k4=0",
           "--set", "use_eqv_loss=false", "--set", "compute_eqv=false"]


def train_argv(root, snap, arm, seed, warm_snapshot=None, iters=ITERS,
               warm_iters=WARM_ITERS):
    """``train_arco_natural``'s argv for ``arm`` ("warm", "sup", "arco"):
    the JAX script's."""
    n = warm_iters if arm == "warm" else iters
    argv = ["--root_path", root, "--dataset", "pascal",
            "--label_num", str(LABEL_NUM), "--model", MODEL,
            "--crop_size", str(HW), "--num_classes", str(K_CLS),
            "--batch_size", "4", "--max_iterations", str(n),
            "--base_lr", "0.01", "--seed", str(seed),
            "--snapshot_dir", snap, "--exp", f"gate/{arm}_s{seed}",
            "--ckpt_every", str(n), "--log_every", "100"] + SMALL
    if arm in ("sup", "warm"):
        argv += SUP_OFF
    if warm_snapshot:
        argv += ["--resume_snapshot", warm_snapshot]
    return argv


def eval_argv(root, snap, arm, seed, iters=ITERS):
    """``eval_natural``'s argv for an arm's checkpoint at ``iters``."""
    return ["--root_path", root, "--dataset", "pascal",
            "--label_num", str(LABEL_NUM), "--model", MODEL,
            "--crop_size", str(HW), "--num_classes", str(K_CLS),
            "--snapshot_dir", snap, "--exp", f"gate/{arm}_s{seed}",
            "--iteration", str(iters)]


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def step_counter(device, total):
    """(record, wrapper) for ``train_arco_natural.main``'s ``wrap_step``:
    the wrapped step counts non-finite losses on the device, and the
    ``total`` steps are timed from the first one's start to the last one's
    end (the card synchronized at both)."""
    rec = {"steps": 0, "nonfinite": None, "t0": None, "t1": None}

    def wrap(step_fn):
        def step(state, batch):
            if rec["t0"] is None:
                _sync(device)
                rec["t0"] = time.perf_counter()
            metrics = step_fn(state, batch)
            bad = (~torch.isfinite(metrics["loss"])).to(torch.int32)
            rec["nonfinite"] = bad if rec["nonfinite"] is None \
                else rec["nonfinite"] + bad
            rec["steps"] += 1
            if rec["steps"] == total:
                _sync(device)
                rec["t1"] = time.perf_counter()
            return metrics
        return step
    return rec, wrap


def run_arm(root, snap, arm, seed, warm_snapshot=None, device="cuda",
            iters=ITERS, warm_iters=WARM_ITERS, extra=()):
    """One arm through the port's CLIs. "warm" returns (its snapshot
    directory, record); "sup" and "arco" continue from ``warm_snapshot``
    and return (``eval_natural``'s result at ``iters``, record). ``extra``
    is appended to both CLIs' argv (``--device cpu`` on the CPU)."""
    device = torch.device(device)
    argv = train_argv(root, snap, arm, seed, warm_snapshot, iters,
                      warm_iters) + list(extra)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    launches = launch_counts()
    steps, wrap = step_counter(device, warm_iters if arm == "warm" else iters)
    t0 = time.perf_counter()
    snapshot = train_arco_natural.main(argv, wrap_step=wrap)
    seconds = time.perf_counter() - t0
    n = steps["steps"]
    record = {"iters": n, "s": round(seconds, 3),
              "ms_per_step": round((steps["t1"] - steps["t0"]) / n * 1e3, 3)
              if n and steps["t1"] else None,
              "nonfinite_losses": int(steps["nonfinite"]) if n else 0,
              "launches": {k: v - launches[k]
                           for k, v in launch_counts().items()}}
    if device.type == "cuda":
        record["peak_gib"] = round(
            torch.cuda.max_memory_allocated(device) / 2 ** 30, 3)
    print(f"[s{seed}] {arm}: {n} iterations in {seconds:.0f}s "
          f"({record['ms_per_step']} ms a step)", flush=True)
    if arm == "warm":
        return snapshot, record
    return eval_natural.main(eval_argv(root, snap, arm, seed, iters)
                             + list(extra)), record


def run_seed(seed, work, device="cuda", iters=ITERS, warm_iters=WARM_ITERS,
             extra=()):
    """One seed: the fixture under ``work``, the warmup, both arms; the
    JAX artifact's run record plus each arm's timing."""
    t_seed = time.perf_counter()
    root = make_fixture(os.path.join(work, f"pascal_s{seed}"), seed)
    snap = os.path.join(work, f"snap_s{seed}")
    kw = dict(device=device, iters=iters, warm_iters=warm_iters,
              extra=extra)
    warm, t_warm = run_arm(root, snap, "warm", seed, **kw)
    sup, t_sup = run_arm(root, snap, "sup", seed, warm_snapshot=warm, **kw)
    arco, t_arco = run_arm(root, snap, "arco", seed, warm_snapshot=warm,
                           **kw)
    run = {"seed": seed, "supervised_miou": round(sup["miou"], 4),
           "arco_miou": round(arco["miou"], 4),
           "gain": round(arco["miou"] - sup["miou"], 4),
           "sup_per_class": [round(x, 4) for x in sup["per_class_iou"]],
           "arco_per_class": [round(x, 4) for x in arco["per_class_iou"]],
           "timing": {"warmup": t_warm, "supervised": t_sup,
                      "arco": t_arco},
           "seconds": round(time.perf_counter() - t_seed, 1)}
    print(json.dumps({k: v for k, v in run.items() if k != "timing"}),
          flush=True)
    return run


def summarize(runs):
    """The JAX artifact's summary, or None where there are no runs."""
    if not runs:
        return None
    gains = [r["gain"] for r in runs]
    return {
        "mean_supervised": round(float(np.mean(
            [r["supervised_miou"] for r in runs])), 4),
        "mean_arco": round(float(np.mean([r["arco_miou"] for r in runs])),
                           4),
        "mean_gain": round(float(np.mean(gains)), 4),
        "min_gain": round(float(np.min(gains)), 4)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    ap.add_argument("--iters", type=int, default=ITERS)
    ap.add_argument("--warm-iters", type=int, default=WARM_ITERS)
    ap.add_argument("--out", default=None,
                    help=f"artifact dir; writes {ARTIFACT}")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--commit", default=None,
                    help="the commit recorded in the artifact (default: "
                         "git describe --always --dirty of the checkout)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    results = {"task": f"natural_{MECHANISM}", "hw": HW, "model": MODEL,
               "n_train": N_TRAIN, "label_num": LABEL_NUM,
               "iters": args.iters, "warm_iters": args.warm_iters,
               "backend": device.type,
               # the natural CLI trains under bf16 autocast on any device
               "compute_dtype": "bfloat16",
               "device": device_entry(device), "torch": torch.__version__,
               "commit": args.commit or git_commit(),
               "source_sha256": source_sha256(__file__), "runs": []}
    print(f"{results['device']}; torch {results['torch']}", flush=True)
    path = os.path.join(args.out, ARTIFACT) if args.out else None
    if path:
        read_compatible(path, results, SHARED)  # refuse before any seed
    extra = ["--device", "cpu"] if device.type == "cpu" else []
    work = tempfile.mkdtemp(prefix="natural_gate_")
    try:
        for seed in args.seeds:
            results["runs"].append(run_seed(
                seed, work, device, args.iters, args.warm_iters, extra))
            if path:
                os.makedirs(args.out, exist_ok=True)
                merged = merge(path, results, SHARED, summarize)
                with open(path, "w") as f:
                    json.dump(merged, f, indent=1)
                print(f"wrote {path} (seeds "
                      f"{[r['seed'] for r in merged['runs']]})", flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    summary = summarize(results["runs"])
    if summary is not None:
        print(json.dumps(summary))
    return results


if __name__ == "__main__":
    main()
