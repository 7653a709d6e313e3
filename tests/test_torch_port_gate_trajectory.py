"""The quality gate's supervised warmup, step after step, against JAX's.

The gate's supervised-only arms run ``make_arco_step`` at the supervised
config (every method term and the strong augmentation off) for hundreds
of steps; the other step tests hold one step, where the SGD momentum is
still the gradient itself. Here both packages take 12 steps from one
state (JAX's, carried across), on the gate script's own data and batch
stream at 32x32 (``striped``, seed 0), with JAX's cutmix boxes (they shape
the unlabeled forward, whose BatchNorm statistics the student keeps), so
the nesterov momentum, the weight decay, the poly schedule over the run
and the running statistics are held across steps. U-Net dropout is 0 in
both (its masks come from JAX's key chain), f32, TF32 off; the set-up is
test_torch_port_step.py's.

In f32 the two runs part as two machines' runs of one package would: the
student lies 2e-6 from JAX's after 3 steps, then near-ties in the max
pools (an argmax that rounding flips routes a gradient elsewhere) move it
by steps, to 3.6% of the distance the run moved it after 12 (the teacher
2.5%, the running statistics <= 0.4%), while the loss terms stay within
7.3e-4 (relative) of JAX's. So the runs are held at rtol 1e-2 on every
step's loss terms and at 8% of the distance moved on each module's
parameters and running statistics. A port without the nesterov term, with
the poly schedule one step longer or without weight decay ends tens of
percent of the distance moved away from JAX's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arco_tpu.config import ArcoConfig as JaxArcoConfig
from arco_tpu.models.unet2d import UNet as JaxUNet
from arco_tpu.train import arco2d as jax_arco2d
from arco_tpu.train.schedule import make_optimizer as jax_make_optimizer

from arco_torch.compat.from_flax import (load_flax_arco_state,
                                         unet_state_dict_from_flax)
from arco_torch.config import OptimConfig
from arco_torch.models.unet2d import UNet
from arco_torch.train import arco2d

from test_torch_port_gate import GATE
from test_torch_port_step import (B, CFG, HW, NC, _draws,
                                  _flax_state_numpy)

torch.set_num_threads(1)
torch.backends.cudnn.allow_tf32 = False

STEPS = 12
LOSS_TOL = dict(rtol=1e-2, atol=0)
MOVED_TOL = 8e-2
SMALL = {k: CFG[k] for k in ("K", "num_queries", "num_negatives",
                             "memobank_size", "memobank_size_bg",
                             "memobank_enqueue", "topk")}
TERMS = ("loss", "loss_ce", "loss_dice")


@pytest.fixture(scope="module")
def trajectories():
    img_l, lab_l, img_u, _, _ = GATE.make_data(
        "striped", 0, hw=HW, n_unlabeled=8, n_val=4)
    index = GATE.batch_indices(0, len(img_l), len(img_u), B, B)
    batches = [next(index) for _ in range(STEPS)]

    # the gate's supervised config at small banks, in both packages
    cfg, _ = GATE.configs(SMALL)
    jcfg = JaxArcoConfig(**dataclasses.asdict(cfg))
    jmodel = JaxUNet(in_chns=1, class_num=NC, dropout=(0.0,) * 5)
    jmods = jax_arco2d.make_arco_modules(jmodel, HW, HW, batch_size=B)
    tx = jax_make_optimizer(0.01, STEPS)
    jstate = jax_arco2d.init_arco_state(jax.random.PRNGKey(1), jmods, jcfg,
                                        (B, HW, HW, 1), tx,
                                        pool_dtype=jnp.float32)
    start = _flax_state_numpy(jstate)
    jstep = jax.jit(jax_arco2d.make_arco_step(jmods, jcfg, tx,
                                              num_classes=NC,
                                              max_iterations=STEPS))

    optim = OptimConfig(base_lr=0.01)
    mods = arco2d.make_arco_modules(
        UNet(in_chns=1, class_num=NC, dropout=(0.0,) * 5), HW, HW,
        batch_size=B)
    state = arco2d.init_arco_state(mods, cfg, (B, 1, HW, HW), optim,
                                   device="cpu", compute_dtype=torch.float32,
                                   pool_dtype=torch.float32)
    load_flax_arco_state(state, start)
    step = arco2d.make_arco_step(mods, cfg, num_classes=NC,
                                 max_iterations=STEPS, optim=optim,
                                 device="cpu")
    nchw = lambda x: torch.from_numpy(
        np.ascontiguousarray(x.transpose(0, 3, 1, 2)))
    metrics = []
    for li, ui in batches:
        draws = {"mix_boxes": _draws(jstate.rng, jcfg, 2 * B)["mix_boxes"]}
        jstate, jm = jstep(jstate, {"image_l": jnp.asarray(img_l[li]),
                                    "label_l": jnp.asarray(lab_l[li]),
                                    "image_u": jnp.asarray(img_u[ui])})
        m = step(state, {"image_l": nchw(img_l[li]),
                         "label_l": torch.from_numpy(lab_l[li]),
                         "image_u": nchw(img_u[ui])}, draws)
        metrics.append(({k: float(jm[k]) for k in TERMS},
                        {k: float(m[k]) for k in TERMS}))
    return start, _flax_state_numpy(jstate), state, metrics


def test_every_steps_loss_terms(trajectories):
    _, _, _, metrics = trajectories
    assert len(metrics) == STEPS
    for i, (want, got) in enumerate(metrics):
        for term in TERMS:
            np.testing.assert_allclose(got[term], want[term],
                                       err_msg=f"step {i} {term}",
                                       **LOSS_TOL)
    # the run trains: the supervised loss falls
    assert metrics[-1][0]["loss"] < 0.6 * metrics[0][0]["loss"]


def _flat(sd, running):
    return torch.cat([t.double().reshape(-1) for name, t in sorted(sd.items())
                      if ("running" in name) == running
                      and "num_batches" not in name])


@pytest.mark.parametrize("module", ["model", "ema_model"])
@pytest.mark.parametrize("part", ["params", "running_stats"])
def test_state_after_the_run(trajectories, module, part):
    """The port's distance from JAX's state after 12 steps, against the
    distance the run moved it from the start."""
    start, ja, state, _ = trajectories
    assert state.step == ja["step"] == STEPS
    params, stats = (("params", "batch_stats") if module == "model"
                     else ("ema_params", "ema_batch_stats"))
    sd = lambda s: unet_state_dict_from_flax(s[params]["model"],
                                             s[stats]["model"])
    running = part == "running_stats"
    want, first = _flat(sd(ja), running), _flat(sd(start), running)
    got = _flat(getattr(state, module).state_dict(), running)
    moved = (want - first).norm()
    assert moved > 0
    assert (got - want).norm() <= MOVED_TOL * moved, \
        float((got - want).norm() / moved)
