#!/usr/bin/env python3
"""How far float32 rounding moves DeepLab-v2's gradients and one natural
ARCO step, in the JAX package and in the PyTorch port (CPU only).

    JAX_PLATFORMS=cpu python scripts/torch_deeplab_rounding.py

1. The gradient of a cross-entropy of DeepLab-v2's train-mode logits (one
   block a layer, 65x65, bs 2, 4 classes, seeded weights of flax's shapes
   carried to the port) in JAX float64, JAX float32, port float64 and port
   float32: the largest difference from JAX's float64 gradient, as a
   share of its largest entry, over four representative weights.
2. One natural ARCO step of the port against JAX's
   (tests/test_torch_port_natural_step.py's set-up) at the defaults and
   with the strong augmentation off: the loss terms' largest relative
   difference and the largest difference of any student weight.

The numbers back the tolerances of tests/test_torch_port_natural*.py.
About 2 minutes on one CPU core.
"""

import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

WEIGHTS = ("conv1.weight", "layer1.0.conv1.weight", "layer4.0.conv3.weight",
           "layer5.conv2d_list.0.weight")


def gradients():
    from arco_tpu.models import deeplab as jdl
    from arco_torch.compat import from_flax
    from arco_torch.models import deeplab as tdl
    from test_torch_port_zoo2d import nchw, random_variables
    x = np.random.RandomState(1).randn(2, 65, 65, 3).astype(np.float32)
    lab = np.random.RandomState(2).randint(0, 4, (2, 65, 65))
    out = {}
    with jax.enable_x64(True):
        for dt in (jnp.float64, jnp.float32):
            jm = jdl.DeepLabV2(num_classes=4, layers=(1, 1, 1, 1), dtype=dt)
            jx = jnp.asarray(x, dt)
            params, stats = random_variables(jm, jx)
            p = jax.tree_util.tree_map(lambda a: jnp.asarray(a, dt), params)

            def loss(p):
                logits = jm.apply({"params": p, "batch_stats": stats}, jx,
                                  train=True, mutable=["batch_stats"])[0][0]
                lp = jax.nn.log_softmax(logits, -1)
                return -jnp.mean(jnp.take_along_axis(
                    lp, jnp.asarray(lab)[..., None], -1))
            g = jax.grad(loss)(p)
            out[f"jax {jnp.dtype(dt).name}"] = \
                from_flax.model_state_dict_from_flax(jax.tree_util.tree_map(
                    lambda a: np.asarray(a, np.float64), g), stats)
    sd = from_flax.model_state_dict_from_flax(params, stats)
    for dt in (torch.float64, torch.float32):
        m = tdl.DeepLabV2(4, (1, 1, 1, 1)).to(dt)
        m.load_state_dict({k: v.to(dt) if v.is_floating_point() else v
                           for k, v in sd.items()})
        torch.nn.functional.cross_entropy(
            m(nchw(x).to(dt))[0], torch.from_numpy(lab)).backward()
        out[f"port {dt}"] = {k: p.grad.double()
                             for k, p in m.named_parameters()}
    ref = out["jax float64"]
    for name, g in out.items():
        worst = max((float((torch.as_tensor(g[k]).double()
                            - ref[k].double()).abs().max()
                           / ref[k].abs().max()), k) for k in WEIGHTS)
        print(f"gradient, {name}: largest difference from JAX float64 "
              f"{worst[0]:.3g} of the largest entry ({worst[1]})")


def one_step(overrides, label):
    import test_torch_port_natural_step as T
    from arco_torch.compat.from_flax import deeplab_state_dict_from_flax
    ja, jm, state, m, _, _ = T.run_one_step({**T.NATURAL, **overrides})
    want = deeplab_state_dict_from_flax(ja["params"]["model"],
                                        ja["batch_stats"]["model"])
    got = state.model.state_dict()
    weight = max((float((got[k] - w).abs().max()), k) for k, w in want.items()
                 if not k.endswith("num_batches_tracked"))
    terms = max(abs(float(m[t]) - float(jm[t])) / max(abs(float(jm[t])),
                                                      1e-12)
                for t in T.TERMS)
    print(f"one step, {label}: loss terms within {terms:.3g} relative; "
          f"student weights up to {weight[0]:.3g} apart ({weight[1]})")


def main():
    torch.set_num_threads(1)
    gradients()
    one_step({}, "defaults")
    one_step({"use_photometric": False, "use_adv_morph": False},
             "strong augmentation off")


if __name__ == "__main__":
    main()
