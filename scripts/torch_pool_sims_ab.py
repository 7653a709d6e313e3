#!/usr/bin/env python3
"""Time the pool_sims kernel of several checkouts of the PyTorch port on one
CUDA GPU, at the shapes of ``chip_smoke.py``: 4 query rows of the 2D path's
F = 496 x 256 x 256 and of the 3D path's F = 16 x 112 x 112 x 80, 16 rows
of the 2D F (bs 8+8), and the natural path's 8 rows at DeepLab-v2's F = 41
x 41 x 256, DeepLab-v3+'s 21 x 21 x 256 and the U-Net's 320 x 320 x 496,
each against 36 pool rows, with ``torch.matmul(queries, pool.t())`` timed
beside it; and the f32 route's shapes: 4 f32 query rows of the 2D and 3D
F against a bf16 pool (the f32 step's) and an f32 pool, the matmul then
in f32 (TF32 off) on the pool widened to f32, the copy included.

    python3 scripts/torch_pool_sims_ab.py [--f32] ROOT [ROOT ...]

With ``--f32`` only the f32 route's shapes run.

Each ROOT is a checkout that holds ``arco_torch/``. The roots run one after
another, each in a process of its own that builds its kernels under
``ROOT/build``, in the order given: give parent, change, change, parent to
see the drift between runs. Each result is held against the plain version
(max error at most 1e-3 of the largest |sim|; on the f32 route rtol 1e-5
and atol 1e-5 of it). Per root and shape it prints
one JSON line: "ms" is one call between two CUDA events and "device_ms" the
device's time per call (calls queued behind a GPU sleep), as
``chip_smoke.py`` takes them, "matmul_ms" and "matmul_device_ms" the same
of the matmul; a shape a checkout's wrapper refuses (the
16-row one, where the kernel took at most 8 rows) is printed as refused. A
table of all roots follows.
"""

from __future__ import annotations

import importlib.util
import json
import math
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
F_2D, F_3D = 496 * 256 * 256, 16 * 112 * 112 * 80
# name: (query rows, F, f32 queries, f32 pool)
SHAPES = {"2d_4rows": (4, F_2D, False, False),
          "3d_4rows": (4, F_3D, False, False),
          "2d_16rows": (16, F_2D, False, False),
          "nat_8rows_v2": (8, 41 * 41 * 256, False, False),
          "nat_8rows_v3": (8, 21 * 21 * 256, False, False),
          "nat_8rows_unet": (8, 320 * 320 * 496, False, False),
          "2d_4rows_f32_bf16pool": (4, F_2D, True, False),
          "3d_4rows_f32_bf16pool": (4, F_3D, True, False),
          "2d_4rows_f32_f32pool": (4, F_2D, True, True),
          "3d_4rows_f32_f32pool": (4, F_3D, True, True)}


def run_one(root: Path, f32_only: bool):
    sys.path.insert(0, str(root))
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    from arco_torch.kernels import pool_sims
    # this checkout's chip_smoke.py (the timers), whose lazy imports of
    # arco_torch then resolve to root's
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    if not Path(pool_sims.__file__).resolve().is_relative_to(root):
        raise RuntimeError(f"imported {pool_sims.__file__}, not from {root}")
    device = torch.device("cuda")
    gen = torch.Generator(device=device).manual_seed(0)
    bf, f32 = torch.bfloat16, torch.float32
    for name, (b, f, f32_q, f32_p) in SHAPES.items():
        if f32_only and not f32_q:
            continue
        qd, pd = (f32 if f32_q else bf), (f32 if f32_p else bf)
        pool = cs._l2n_rows(torch.randn((cs.POOL_K, f), generator=gen,
                                        device=device, dtype=pd))
        queries = torch.randn((b, f), generator=gen, device=device, dtype=qd)
        for i in range(b):
            queries[i] = (queries[i].float() / math.sqrt(f) + 0.7 * (i + 1)
                          / b * pool[i % cs.POOL_K].float()).to(qd)
        cs._l2n_rows(queries)
        row = {"root": str(root), "shape": name}
        try:
            got = pool_sims.pool_similarities(queries, pool)
        except ValueError as e:
            print(json.dumps({**row, "refused": str(e)}), flush=True)
            continue
        want = pool_sims.pool_similarities_plain(queries, pool)
        err = (got - want).abs().max().item()
        scale = want.abs().max().item()
        if f32_q:
            torch.testing.assert_close(got, want, rtol=1e-5,
                                       atol=1e-5 * scale)
        elif not err <= 1e-3 * scale:
            raise AssertionError(f"{root} {name}: max err {err}")
        fn = lambda: pool_sims.pool_similarities(queries, pool)
        mm = lambda: torch.matmul(queries, pool.to(qd).t())
        print(json.dumps({**row, "max_abs_err": err,
                          "ms": cs._time_ms(fn, 20),
                          "device_ms": cs._device_ms(fn, 20),
                          "matmul_ms": cs._time_ms(mm, 20),
                          "matmul_device_ms": cs._device_ms(mm, 20)}),
              flush=True)
        del pool, queries
        torch.cuda.empty_cache()


def main(argv):
    if argv[:1] == ["--one"]:
        run_one(Path(argv[1]).resolve(), argv[2:] == ["--f32"])
        return 0
    f32_only = argv[:1] == ["--f32"]
    argv = argv[1:] if f32_only else argv
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip(), flush=True)
    rows = []
    for i, root in enumerate(argv):
        out = subprocess.run([sys.executable, __file__, "--one", root]
                             + (["--f32"] if f32_only else []),
                             stdout=subprocess.PIPE, text=True, check=True,
                             timeout=600).stdout
        for line in out.splitlines():
            if line.startswith("{"):
                print(line, flush=True)
                rows.append((i, json.loads(line)))
    print("run  root  shape  ms  device_ms  matmul_ms  matmul_device_ms")
    for i, r in sorted(rows, key=lambda x: (x[1]["shape"], x[0])):
        if "refused" in r:
            print(f"{i} {r['root']} {r['shape']} refused")
            continue
        print(f"{i} {r['root']} {r['shape']} {r['ms']:.4f} "
              f"{r['device_ms']:.4f} {r['matmul_ms']:.4f} "
              f"{r['matmul_device_ms']:.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
