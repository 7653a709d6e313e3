#!/usr/bin/env python3
"""Time the InfoNCE kernel pair of several checkouts of the PyTorch port on
one CUDA GPU, at the four shapes ``chip_smoke.py`` holds it at, over full
banks: the 2D path (K 4, C 496; uniform, 'smc' and 'asmc' draws, phase 3),
the 3D path (K 2, C 16, phase 8a) and the natural path (K 21, C 256 and
C 496, phase 12a), each at the main path's 'smc' draws.

    python3 scripts/torch_infonce_ab.py ROOT [ROOT ...]

Each ROOT is a checkout that holds ``arco_torch/``. The roots run one after
another, each in a process of its own that builds its kernels under
``ROOT/build``, in the order given: give parent, change, change, parent to
see the drift between runs. Both wrapper APIs are driven: the one whose
backward recomputes the similarities from the anchors
(``infonce_bwd(a_n, bank, neg_idx, invtot, inv_temp)``, ``infonce_fwd``
returning denom) and the one whose backward reads the forward's e
(``infonce_bwd(e, bank, neg_idx, invtot)``, ``infonce_fwd`` returning
(denom, e)). Each result is held against a plain gather + einsum computed
here (rtol 1e-3). With ``--f32`` it times the f32 route instead (f32
anchors and bank, TF32 off), at the 2D shape ('smc' and uniform draws) and
the 3D one ('smc'), each result held at rtol 1e-5:

    python3 scripts/torch_infonce_ab.py --f32 ROOT [ROOT ...]

Per root, shape, draw and kernel it prints one JSON line:
"ms" is one call between two CUDA events (the host's work before the
launch included) and "device_ms" the device's time per call (calls queued
behind a GPU sleep), both as ``chip_smoke.py`` takes them; "host_ms" is
the host's time per call, from entering the wrapper to its return, while
the device works behind; "bound_ms" and "bound_by" are
``chip_smoke.py:_infonce_bounds``'s, "share" is bound_ms / device_ms;
"grids" is the device time per call of each CUDA kernel the call runs,
from ``torch.profiler`` (``chip_smoke.py:_grid_ms``; null where it records
none). A table of all roots follows, under the card's name and power
limit.
"""

from __future__ import annotations

import importlib.util
import inspect
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def host_ms(fn, reps=100):
    """Host ms per call: ``reps`` calls queued without a wait (fewer
    launches than the device's queue holds), the median of five runs."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        times.append((time.perf_counter() - t0) * 1e3 / reps)
        torch.cuda.synchronize()
    return statistics.median(times)


def shapes(cs, f32=False):
    """name -> (bank capacities, C, draws, generator seed)"""
    if f32:
        return {"2d": (cs.CAPS, cs.C, ("uniform", cs.MAIN_DRAW), 0),
                "3d": (cs.CAPS_3D, cs.C_3D, (cs.MAIN_DRAW,), 4)}
    return {"2d": (cs.CAPS, cs.C, ("uniform", "smc", "asmc"), 0),
            "3d": (cs.CAPS_3D, cs.C_3D, (cs.MAIN_DRAW,), 4),
            "natural_c256": (cs.NAT_CAPS, cs.NAT_C, (cs.MAIN_DRAW,), 12),
            "natural_c496": (cs.NAT_CAPS, cs.C, (cs.MAIN_DRAW,), 12)}


def run_one(root: Path, check: bool = True, only_main_draw: bool = False,
            f32: bool = False, grids: bool = True):
    """Time root's pair at every shape; ``check=False`` skips the results'
    check against the plain einsums (for variants that compute wrong
    results on purpose), ``only_main_draw`` times the 'smc' draws alone,
    ``f32`` the f32 route (f32 inputs, rtol 1e-5); ``grids=False`` skips
    the per-grid times."""
    sys.path.insert(0, str(root))
    import torch
    from arco_torch.kernels import infonce
    # this checkout's chip_smoke.py (the inputs, timers and bounds), whose
    # lazy imports of arco_torch then resolve to root's
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    if not Path(infonce.__file__).resolve().is_relative_to(root):
        raise RuntimeError(f"imported {infonce.__file__}, not from {root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")
    dtype, tol, suffix = (torch.float32, 1e-5, "_f32") if f32 \
        else (None, 1e-3, "")
    it = 1.0 / cs.TEMP
    reads_e = next(iter(inspect.signature(infonce.infonce_bwd)
                        .parameters)) == "e"
    for shape, (caps, c, funcs, seed) in shapes(cs, f32).items():
        if only_main_draw:
            funcs = (cs.MAIN_DRAW,)
        gen = torch.Generator(device=device).manual_seed(seed)
        a_n, p_n, bank, draws = cs._infonce_inputs(gen, device, caps, c,
                                                   funcs, dtype)
        pos = (a_n.float() * p_n.float()[:, None]).sum(-1) * it
        k = torch.arange(len(caps), device=device)[:, None, None]
        for func, idx in draws.items():
            rows = bank[k, idx.long()].float()
            e = torch.exp(torch.einsum("kqc,kqnc->kqn", a_n.float(), rows)
                          * it - it)
            denom = e.sum(-1)
            invtot = 1.0 / (torch.exp(pos - it) + denom)
            ga = torch.einsum("kqn,kqnc->kqc", e * invtot[..., None], rows)
            del rows
            if reads_e:
                def fwd():
                    return infonce.infonce_fwd(a_n, bank, idx, it)[0]

                def bwd():
                    return infonce.infonce_bwd(e, bank, idx, invtot)
            else:
                def fwd():
                    return infonce.infonce_fwd(a_n, bank, idx, it)

                def bwd():
                    return infonce.infonce_bwd(a_n, bank, idx, invtot, it)
            if check:
                torch.testing.assert_close(fwd(), denom, rtol=tol, atol=0)
                torch.testing.assert_close(bwd(), ga, rtol=tol,
                                           atol=tol * ga.abs().max().item())
            _, bounds = cs._infonce_bounds(a_n, idx)
            for name, fn in (("infonce_fwd", fwd), ("infonce_bwd", bwd)):
                device_ms = cs._device_ms(fn, 50)
                bound, by = bounds[name]
                print(json.dumps({
                    "root": str(root), "shape": shape,
                    "kernel": name + suffix,
                    "draw": func, "ms": cs._time_ms(fn, 50),
                    "device_ms": device_ms, "host_ms": host_ms(fn),
                    "bound_ms": bound, "bound_by": by,
                    "share": bound / device_ms,
                    "grids": cs._grid_ms(fn) if grids else None}),
                    flush=True)
        del a_n, p_n, bank, draws, e, invtot, ga
        torch.cuda.empty_cache()


def main(argv):
    f32 = argv[:1] == ["--f32"]
    argv = argv[f32:]
    if argv[:1] == ["--one"]:
        run_one(Path(argv[1]).resolve(), f32=f32)
        return 0
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    print(card, flush=True)
    rows = []
    for i, root in enumerate(argv):
        out = subprocess.run([sys.executable, __file__,
                              *["--f32"] * f32, "--one", root],
                             stdout=subprocess.PIPE, text=True, check=True,
                             timeout=900).stdout
        for line in out.splitlines():
            if line.startswith("{"):
                print(line, flush=True)
                rows.append((i, json.loads(line)))
    print(card)
    print("run  root  shape  kernel  draw  ms  device_ms  host_ms  "
          "bound_ms  share")
    for i, r in sorted(rows, key=lambda x: (x[1]["shape"], x[1]["draw"],
                                            x[1]["kernel"], x[0])):
        print(f"{i} {r['root']} {r['shape']} {r['kernel']} {r['draw']} "
              f"{r['ms']:.4f} {r['device_ms']:.4f} {r['host_ms']:.4f} "
              f"{r['bound_ms']:.4f} {r['share']:.2f}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
