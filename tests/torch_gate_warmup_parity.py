#!/usr/bin/env python3
"""The quality gate's supervised warmup in JAX, seed by seed, on the CPU
in f32, and the U-Net each warmup starts from, for the port to start from.

For each seed, JAX's gate script (``scripts/validate_semi_synthetic.py``)
runs its warmup as the gate does: the U-Net drawn by flax from
``PRNGKey(seed)``, then its 150 supervised steps, scored on the
validation set. ``--save-init DIR`` writes that initial U-Net (weights and
BatchNorm statistics, carried across with ``compat/from_flax.py``) as the
port's state dict ``DIR/unet_jax_init_s<seed>.pt``. The port trains from
them on the card: ``scripts/torch_gate_init_probe.py --inits jax_init
--jax-init DIR`` (the warmup alone) and
``scripts/torch_validate_semi_synthetic.py --init-dir DIR`` (whole seeds
of the gate). The port's own U-Net draws the same distributions
(``arco_torch/models/init.py``) from torch's generator, so only these
files give it JAX's very weights. Prints one JSON line a seed: the
warmup's Dice and bucket Dice.

    python3 tests/torch_gate_warmup_parity.py --task striped \\
        --seeds 0 1 2 3 4 5 6 7 [--save-init build/gate_init]

It runs at the gate's full size (256x256, bs 4+4): about 8-13 minutes a
seed on an 8-core CPU, 6 GiB.
"""

import argparse
import dataclasses
import json
import os
import sys
from pathlib import Path

TESTS = Path(__file__).resolve().parent
sys.path[:0] = [str(TESTS), str(TESTS.parent)]

import conftest  # noqa: E402,F401  (JAX on the CPU, before any backend use)
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from arco_torch.compat.from_flax import unet_state_dict_from_flax  # noqa: E402
from test_torch_port_gate import GATE, JAX_GATE  # noqa: E402


def jax_sup_cfg():
    """The gate's supervised config as JAX's ``ArcoConfig``."""
    return JAX_GATE.ArcoConfig(**dataclasses.asdict(GATE.configs()[0]))


def jax_initial_unet(seed):
    """The port's state dict of the U-Net that JAX's gate ``run`` starts
    its warmup from under ``seed``."""
    model = JAX_GATE.net_factory("unet", in_chns=1, class_num=JAX_GATE.K,
                                 dtype=jnp.float32)
    modules = JAX_GATE.make_arco_modules(model, JAX_GATE.HW, JAX_GATE.HW,
                                         batch_size=JAX_GATE.B,
                                         dtype=jnp.float32)
    state = JAX_GATE.init_arco_state(
        jax.random.PRNGKey(seed), modules, jax_sup_cfg(),
        (JAX_GATE.B, JAX_GATE.HW, JAX_GATE.HW, 1),
        JAX_GATE.make_optimizer(0.01, 1))
    return unet_state_dict_from_flax(
        jax.device_get(state.params["model"]),
        jax.device_get(state.batch_stats["model"]))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--task", default="striped", choices=GATE.TASKS)
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    ap.add_argument("--save-init", default=None)
    args = ap.parse_args(argv)
    for seed in args.seeds:
        img_l, lab_l, img_u, img_v, lab_v = GATE.make_data(args.task, seed)
        out = {"task": args.task, "seed": seed, "steps": JAX_GATE.N_WARM}
        if args.save_init:
            os.makedirs(args.save_init, exist_ok=True)
            torch.save(jax_initial_unet(seed), os.path.join(
                args.save_init, f"unet_jax_init_s{seed}.pt"))

        params, stats, jmodel = JAX_GATE.run(
            jax_sup_cfg(), f"[jax s{seed}] warmup", JAX_GATE.N_WARM,
            img_l, lab_l, img_u, jnp.float32, seed=seed)
        out["jax"] = JAX_GATE.evaluate(jmodel, params, stats, img_v, lab_v)
        out["jax_buckets"] = JAX_GATE.evaluate_buckets(jmodel, params, stats,
                                                       img_v, lab_v)
        print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
