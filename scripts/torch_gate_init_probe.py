#!/usr/bin/env python3
"""The 150-step supervised warmup of
``scripts/torch_validate_semi_synthetic.py`` from three kinds of initial
U-Net, in bf16 and in f32, seed by seed, on one CUDA GPU:

  flax      the gate's own: the port's U-Net as ``net_factory`` draws it
            under ``seed``, with flax's default init as JAX's draws
            (``arco_torch/models/init.py:jax_init_``: lecun-normal, a
            unit normal truncated at +-2 scaled to variance 1 / fan_in;
            biases zero), from torch's generator;
  torch     the same U-Net redrawn with torch's default init, which the
            port's factories drew before they drew JAX's
            (kaiming-uniform(a = sqrt 5) kernels, variance 1 / (3 fan_in),
            U(+-1 / sqrt(fan_in)) biases);
  jax_init  the very weights and BatchNorm statistics that JAX's gate
            starts its warmup from under ``seed``, read from
            ``--jax-init DIR`` (``DIR/unet_jax_init_s<seed>.pt``, written
            on the CPU by ``tests/torch_gate_warmup_parity.py
            --save-init DIR``).

    python3 scripts/torch_gate_init_probe.py --task striped \\
        --seeds 0 1 2 [--inits torch flax jax_init] \\
        [--dtypes bfloat16 float32] [--jax-init build/gate_init]

f32 runs without autocast and with TF32 off. Prints one JSON line a (seed,
init, dtype): the warmup's Dice and bucket Dice and its ms a step.
"""

from __future__ import annotations

import argparse
import json

import torch

import torch_validate_semi_synthetic as gate

INITS = ("flax", "torch", "jax_init")
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def torch_default_init_(model):
    """Redraw every layer of ``model`` with torch's default init (its
    ``reset_parameters``), from torch's global generator."""
    for m in model.modules():
        if m is not model and hasattr(m, "reset_parameters"):
            m.reset_parameters()
    return model


def initial_weights(init, seed, jax_init_dir):
    """The U-Net's initial state dict under ``init``, or None for the
    gate's own ("flax": ``run`` seeds torch with ``seed`` and builds it
    through ``net_factory``, which draws it with ``jax_init_``)."""
    if init == "torch":
        torch.manual_seed(seed)
        return torch_default_init_(gate.net_factory(
            "unet", in_chns=1, class_num=gate.K)).state_dict()
    if init == "jax_init":
        return gate.load_jax_initial_unet(jax_init_dir, seed)
    return None


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--task", default="striped", choices=gate.TASKS)
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    ap.add_argument("--inits", nargs="+", default=["flax", "torch"],
                    choices=INITS)
    ap.add_argument("--dtypes", nargs="+", default=["bfloat16"],
                    choices=DTYPES)
    ap.add_argument("--jax-init", default=None)
    args = ap.parse_args(argv)
    if "jax_init" in args.inits and not args.jax_init:
        ap.error("--inits jax_init needs --jax-init DIR")
    device = gate.resolve_device("cuda")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    sup_cfg, _ = gate.configs()
    for seed in args.seeds:
        img_l, lab_l, img_u, img_v, lab_v = gate.make_data(args.task, seed)
        data = (gate._nchw(img_l, device), torch.from_numpy(lab_l).to(device),
                gate._nchw(img_u, device))
        for init in args.inits:
            for name in args.dtypes:
                dtype = DTYPES[name]
                model, rec = gate.run(
                    sup_cfg, f"[{init} {name} s{seed}] warmup",
                    gate.N_WARM, data, device,
                    warm=initial_weights(init, seed, args.jax_init),
                    seed=seed, dtype=dtype)
                print(json.dumps({
                    "task": args.task, "seed": seed, "init": init,
                    "dtype": name,
                    "warmup_dice": gate.evaluate(model, img_v, lab_v, device,
                                                 dtype),
                    "warmup_buckets": gate.evaluate_buckets(
                        model, img_v, lab_v, device, dtype=dtype),
                    "warmup_ms_per_step": rec["ms_per_step"]}), flush=True)


if __name__ == "__main__":
    main()
