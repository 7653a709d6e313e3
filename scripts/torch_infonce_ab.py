#!/usr/bin/env python3
"""Time the InfoNCE kernel pair of several checkouts of the PyTorch port on
one CUDA GPU, at the main path's shapes and the three draws of
``chip_smoke.py`` phase 3 (uniform, 'smc', 'asmc'), over full banks.

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
here (rtol 1e-3). Per root, kernel and draw it prints one JSON line:
"ms" is one call between two CUDA events (the host's work before the
launch included) and "device_ms" the device's time per call (calls queued
behind a GPU sleep), both as ``chip_smoke.py`` takes them; "host_ms" is
the host's time per call, from entering the wrapper to its return, while
the device works behind. A table of all roots follows.
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


def run_one(root: Path):
    sys.path.insert(0, str(root))
    import torch
    from arco_torch.kernels import infonce
    # this checkout's chip_smoke.py (the inputs and timers), whose lazy
    # imports of arco_torch then resolve to root's
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    if not Path(infonce.__file__).resolve().is_relative_to(root):
        raise RuntimeError(f"imported {infonce.__file__}, not from {root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda")
    gen = torch.Generator(device=device).manual_seed(0)
    a_n, p_n, bank, draws = cs._infonce_inputs(
        gen, device, cs.CAPS, cs.C, ("uniform", "smc", "asmc"))
    it = 1.0 / cs.TEMP
    pos = (a_n.float() * p_n.float()[:, None]).sum(-1) * it
    reads_e = next(iter(inspect.signature(infonce.infonce_bwd)
                        .parameters)) == "e"
    k = torch.arange(len(cs.CAPS), device=device)[:, None, None]
    for func, idx in draws.items():
        rows = bank[k, idx.long()].float()
        e = torch.exp(torch.einsum("kqc,kqnc->kqn", a_n.float(), rows) * it
                      - it)
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
        torch.testing.assert_close(fwd(), denom, rtol=1e-3, atol=0)
        torch.testing.assert_close(bwd(), ga, rtol=1e-3,
                                   atol=1e-3 * ga.abs().max().item())
        for name, fn in (("infonce_fwd", fwd), ("infonce_bwd", bwd)):
            print(json.dumps({"root": str(root), "kernel": name,
                              "draw": func, "ms": cs._time_ms(fn, 50),
                              "device_ms": cs._device_ms(fn, 50),
                              "host_ms": host_ms(fn)}),
                  flush=True)


def main(argv):
    if argv[:1] == ["--one"]:
        run_one(Path(argv[1]).resolve())
        return 0
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip(), flush=True)
    rows = []
    for i, root in enumerate(argv):
        out = subprocess.run([sys.executable, __file__, "--one", root],
                             stdout=subprocess.PIPE, text=True, check=True,
                             timeout=600).stdout
        for line in out.splitlines():
            if line.startswith("{"):
                print(line, flush=True)
                rows.append((i, json.loads(line)))
    print("run  root  kernel  draw  ms  device_ms  host_ms")
    for i, r in sorted(rows, key=lambda x: (x[1]["kernel"], x[1]["draw"],
                                            x[0])):
        print(f"{i} {r['root']} {r['kernel']} {r['draw']} {r['ms']:.4f} "
              f"{r['device_ms']:.4f} {r['host_ms']:.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
