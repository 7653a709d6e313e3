#!/usr/bin/env python3
"""Time the PyTorch port's stage-2 training CLI of several checkouts on one
CUDA GPU: ``arco_torch.cli.train_arco_2d`` at the config defaults (256x256,
bs 2+2, full width and banks, photometric and AdvMorph on, bf16) on a
synthetic Synapse-layout tree of 64 slices.

    python3 scripts/torch_cli_ab.py [--steps 30] [--log_every 5] ROOT [ROOT ...]

Each ROOT is a checkout that holds ``arco_torch/``. The roots run one after
another, each in a process of its own that builds its kernels under
``ROOT/build``, in the order given: give parent, change, change, parent to
see the drift between runs. The CLI checkpoints only after its last step.
Per root it prints one JSON line: the images/s of each log interval, as the
CLI writes them to metrics.jsonl (the host clock between two log lines,
each of which copies the losses to the host), and their median without the
first interval (cuDNN's and the allocator's warm-up).
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path


def run_one(root: Path, steps: int, log_every: int):
    sys.path.insert(0, str(root))
    import torch
    from arco_torch.cli import train_arco_2d
    from arco_torch.data.synthetic import make_synapse_like
    with tempfile.TemporaryDirectory() as tmp:
        data = make_synapse_like(str(Path(tmp) / "Synapse"))
        train_arco_2d.main([
            "--root_path", data, "--exp", "Synapse/ab", "--labeled_num", "1",
            "--snapshot_dir", str(Path(tmp) / "model"),
            "--max_iterations", str(steps), "--log_every", str(log_every),
            "--ckpt_every", str(steps)])
        jsonl = Path(tmp) / "model" / "Synapse/ab_1_labeledfinal" / "unet" \
            / "metrics.jsonl"
        ips = [json.loads(line)["images_per_sec"]
               for line in jsonl.read_text().splitlines()]
    print(json.dumps({"root": str(root), "gpu": torch.cuda.get_device_name(0),
                      "images_per_sec": ips,
                      "median_after_first": statistics.median(ips[1:])}),
          flush=True)


def main():
    p = argparse.ArgumentParser()
    p.add_argument("roots", nargs="+")
    p.add_argument("--steps", type=int, default=30)
    p.add_argument("--log_every", type=int, default=5)
    p.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    args = p.parse_args()
    if args.one:
        run_one(Path(args.roots[0]).resolve(), args.steps, args.log_every)
        return 0
    rows = []
    for root in args.roots:
        proc = subprocess.run(
            [sys.executable, __file__, "--one", "--steps", str(args.steps),
             "--log_every", str(args.log_every), root],
            capture_output=True, text=True)
        if proc.returncode:
            sys.stderr.write(proc.stderr[-4000:])
            raise SystemExit(f"{root}: exit {proc.returncode}")
        rows.append(json.loads(proc.stdout.strip().splitlines()[-1]))
        print(json.dumps(rows[-1]), flush=True)
    for r in rows:
        print(f"{r['root']}: median {r['median_after_first']:.2f} img/s, "
              f"intervals {[round(v, 2) for v in r['images_per_sec']]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
