"""The port's data-parallel stage-2 ARCO step (``make_arco_step(...,
mesh=)``) on gloo ranks of the CPU, against one process over the whole
batch and against JAX's step under a batch sharding.

One ``torch.multiprocessing.spawn`` of 4 processes runs world size 4, then
ranks 0 and 1 a group of 2 while the other two run the single-process
steps (tests/torch_port_arco_ranks.py, which imports no JAX); meanwhile
this process runs JAX's sharded step (one compile).

- (i) One step at tests/test_parallel.py:144's configuration (U-Net with
  dropout, 3 classes, 32x32, 8 + 8, photometric and AdvMorph on, every
  draw from the state's generator) at 4 and 2 ranks against one process:
  every scalar metric at JAX's rtol 5e-5 / atol 1e-7; the student,
  teacher and heads with their BatchNorm statistics at STATE_TOL (one SGD
  step of gradients summed in another order: 1.8e-6 measured); the bank,
  the pool and their pointers; the predicted labels and every rank's
  generator exactly (the draws run in lockstep).
- (ii) tests/test_torch_port_step.py's configuration at 8 + 8 on 2 ranks
  against JAX's ``make_arco_step`` with the batch sharded over the
  conftest's 8 CPU devices, from JAX's state carried across by
  ``compat/from_flax.py`` and with JAX's draws, at that file's
  tolerances.
- (iii) 9 steps at 2 ranks (4 classes, so the banks fill: they wrap at
  steps 4 and 8, the pool every step; 4 + 4) against one process: the
  losses at JAX's trajectory rtol 3e-2 (tests/test_parallel.py:141), bank
  and pool pointers exactly, the generators in lockstep.
- (iv) ``parallel.dryrun``'s rank on a 2x2 ("data", "space") mesh: a
  finite loss, step 1, the spatial leg within 1e-5 of the unsharded
  forward away from the depth edges.
- (v) One 3D step (V-Net with dropout, 5-column mix boxes, 2 + 2 a rank)
  at 2 ranks against one process, as (i): at 32x32x16 in float64 and at
  64x64x16 in f32 (tests/torch_port_arco_ranks.py's CASES3D says why);
  and one 2D step with ClassMix, the 'asmc' sampler, the dead forward,
  histogram percentiles and remat.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from arco_tpu.config import ArcoConfig as JaxArcoConfig
from arco_tpu.models.unet2d import UNet as JaxUNet
from arco_tpu.parallel.mesh import create_mesh as jax_create_mesh
from arco_tpu.parallel.mesh import replicate_sharding
from arco_tpu.parallel.mesh import shard_batch as jax_shard_batch
from arco_tpu.train import arco2d as jax_arco2d
from arco_tpu.train.schedule import make_optimizer as jax_make_optimizer

import torch_port_arco_ranks as ranks
from arco_torch.augment.tps import RandTPS
from arco_torch.compat.from_flax import (
    feature_extractor_state_dict_from_flax, head_state_dict_from_flax,
    unet_state_dict_from_flax)

torch.set_num_threads(1)

METRIC_TOL = dict(rtol=5e-5, atol=1e-7)       # tests/test_parallel.py:184
STATE_TOL = dict(rtol=1e-4, atol=1e-5)
# tests/test_torch_port_step.py's tolerances against JAX
LOSS_TOL = dict(rtol=1e-4, atol=1e-6)
TRAJ_TOL = dict(rtol=3e-2)                    # tests/test_parallel.py:141
MODULES = ("model", "ema_model", "feature_extractor", "k_feature_extractor",
           "q_representation")
TERMS = ["loss", "reco_loss", "loss_q", "unsup_loss", "loss_ce",
         "loss_dice", "loss_eqv"]


# ---- JAX's draws and state, copied from tests/test_torch_port_step.py at
# the global batch JB

def _flax_state_numpy(s):
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)
    return {"params": to_np(s.params), "batch_stats": to_np(s.batch_stats),
            "ema_params": to_np(s.ema_params),
            "ema_batch_stats": to_np(s.ema_batch_stats),
            "k_feature_params": to_np(s.k_feature_params),
            "memobank": {"data": np.asarray(s.memobank.data),
                         "ptr": np.asarray(s.memobank.ptr),
                         "count": np.asarray(s.memobank.count)},
            "random_pool": np.asarray(s.random_pool, np.float32),
            "random_pool_ptr": int(s.random_pool_ptr),
            "step": int(s.step)}


def _uniforms(key, n_classes, num):
    """The uniforms sampling.stratified_indices draws for each class key
    of compute_contra_memobank_loss (one split, then uniform)."""
    out = []
    for k in jax.random.split(key, n_classes):
        k_u, _ = jax.random.split(k)
        out.append(np.asarray(jax.random.uniform(k_u, (num,))))
    return torch.from_numpy(np.stack(out))


def _draws(rng, cfg, b, hw, nc):
    """Reproduce the step's random draws from the JAX state's key."""
    keys = jax.random.split(rng, 12)
    k_mix, k_tps, k_contra = keys[2], keys[7], keys[8]

    boxes = []
    for key in jax.random.split(k_mix, b):
        k_w, k_x, k_y = jax.random.split(key, 3)
        rw = jax.random.randint(k_w, (), int(hw / 2.0) + 1, hw)
        rh = jnp.minimum(jnp.round(hw * hw / 2.0 / rw).astype(jnp.int32), hw)
        x0 = jax.random.randint(k_x, (), 0, jnp.maximum(hw - rw + 1, 1))
        y0 = jax.random.randint(k_y, (), 0, jnp.maximum(hw - rh + 1, 1))
        boxes.append([int(rw), int(x0), int(y0)])

    total = 2 * b
    k_pert, k_aff, k_mir = jax.random.split(k_tps, 3)
    k_a, k_s, k_tx, k_ty = jax.random.split(k_aff, 4)
    u = lambda k, shape, lo, hi: torch.from_numpy(np.asarray(
        jax.random.uniform(k, shape, minval=lo, maxval=hi)))
    tps = {"pert": u(k_pert, (total, 25, 2), -cfg.tps_sigma,
                     cfg.tps_sigma),
           "angle": u(k_a, (total,), -60.0, 60.0),
           "scale": u(k_s, (total,), 1.0 / 1.2, 1.0 / 0.8),
           "tx": u(k_tx, (total,), -0.1, 0.1),
           "ty": u(k_ty, (total,), -0.1, 0.1),
           "flip": torch.tensor(bool(jax.random.bernoulli(k_mir)))}

    k_anchor, k_neg, k_enq = jax.random.split(k_contra, 3)
    contra = {"enq": _uniforms(k_enq, nc, cfg.memobank_enqueue),
              "anchor": _uniforms(k_anchor, nc, cfg.num_queries),
              "neg": _uniforms(k_neg, nc,
                               cfg.num_queries * cfg.num_negatives)}
    return {"mix_boxes": torch.tensor(boxes), "tps": tps, "contra": contra}


class _FixedGridTPS:
    """The JAX RandTPS with its grid fixed to one the caller computed."""

    def __init__(self, inner, grid):
        self.inner, self.grid = inner, jnp.asarray(grid)

    def reset(self, rng):
        return self.grid

    def apply(self, *args, **kwargs):
        return self.inner.apply(*args, **kwargs)


def jax_inputs(path):
    """JAX's initial state and its step's draws at the global batch,
    written to ``path`` for the ranks; returns what ``jax_sharded_step``
    takes."""
    b, hw, nc = ranks.JB, ranks.JHW, ranks.JNC
    jcfg = JaxArcoConfig(**ranks.JCFG)
    jmods = jax_arco2d.make_arco_modules(
        JaxUNet(in_chns=1, class_num=nc, dropout=(0.0,) * 5), hw, hw,
        batch_size=b)
    tx = jax_make_optimizer(0.01, 100)
    jstate = jax_arco2d.init_arco_state(jax.random.PRNGKey(0), jmods, jcfg,
                                        (b, hw, hw, 1), tx,
                                        pool_dtype=jnp.float32)
    draws = _draws(jstate.rng, jcfg, b, hw, nc)
    torch.save((_flax_state_numpy(jstate), draws), path)
    grid = RandTPS(hw, hw, batch_size=2 * b).reset(draws["tps"]).numpy()
    return jstate, jmods._replace(tps=_FixedGridTPS(jmods.tps, grid)), \
        jcfg, tx


def jax_sharded_step(jstate, jmods, jcfg, tx):
    """JAX's step with the batch sharded over the conftest's 8 CPU
    devices and the state replicated: (state after, metrics), numpy."""
    batch = ranks.jax_batch()
    nhwc = lambda x: jnp.asarray(x.permute(0, 2, 3, 1).numpy())
    mesh = jax_create_mesh()
    assert mesh.devices.size == 8
    jbatch = jax_shard_batch({"image_l": nhwc(batch["image_l"]),
                              "label_l": jnp.asarray(
                                  batch["label_l"].numpy()),
                              "image_u": nhwc(batch["image_u"])}, mesh)
    jstep = jax_arco2d.make_arco_step(jmods, jcfg, tx, num_classes=ranks.JNC,
                                      max_iterations=100)
    jnew, jmetrics = jstep(jax.device_put(jstate, replicate_sharding(mesh)),
                           jbatch)
    return _flax_state_numpy(jnew), {k: np.asarray(v)
                                     for k, v in jmetrics.items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every rank's results at both world sizes, the single-process runs
    and JAX's sharded step. The processes start as soon as JAX's inputs
    are written; JAX's step runs meanwhile."""
    out = tmp_path_factory.mktemp("arco_ranks")
    inputs = str(out / "jax_inputs.pt")
    case = jax_inputs(inputs)
    ctx = mp.spawn(ranks.run, nprocs=max(ranks.WORLDS), join=False,
                   args=(str(out), str(out), inputs))
    try:
        jax_result = jax_sharded_step(*case)
        while not ctx.join():
            pass
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    load = lambda name: torch.load(os.path.join(out, name),
                                   weights_only=False)
    got = {n: [load(f"arco{n}_rank{r}.pt") for r in range(n)]
           for n in ranks.WORLDS}
    single = {kind: load(f"single_{kind}.pt")
              for jobs in ranks.SINGLE.values() for kind, _ in jobs}
    return {"ranks": got, "single": single, "jax": jax_result}


@pytest.fixture(scope="module", params=[4, 2], ids=["4ranks", "2ranks"])
def one_step(request, runs):
    """(every rank's one-step result, the single process's) at one world
    size."""
    return [r["one"] for r in runs["ranks"][request.param]], \
        runs["single"]["2d"]


def _assert_state(got, want, tol=STATE_TOL):
    for name in MODULES:
        for k, v in want[name].items():
            if v.is_floating_point():
                np.testing.assert_allclose(got[name][k].numpy(), v.numpy(),
                                           err_msg=f"{name}.{k}", **tol)
            else:
                assert torch.equal(got[name][k], v), f"{name}.{k}"
    for k in ("ptr", "count"):
        assert torch.equal(got["bank"][k], want["bank"][k]), k
    np.testing.assert_allclose(got["bank"]["data"].numpy(),
                               want["bank"]["data"].numpy(), **tol)
    np.testing.assert_allclose(got["pool"].numpy(), want["pool"].numpy(),
                               **tol)
    assert got["pool_ptr"] == want["pool_ptr"]
    assert got["step"] == want["step"]


def _assert_metrics(got, want, tol=METRIC_TOL):
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **tol)


def test_one_step_metrics(one_step):
    got, want = one_step
    for metrics, _, _ in got:
        _assert_metrics(metrics[0], want[0][0])


def test_one_step_predicted_labels_of_the_whole_batch(one_step):
    got, want = one_step
    for _, pred, _ in got:
        assert pred.shape == (ranks.B, ranks.HW, ranks.HW)
        assert torch.equal(pred, want[1])


def test_one_step_state(one_step):
    """Weights, BatchNorm statistics, bank and pool after the step."""
    got, want = one_step
    for _, _, state in got:
        _assert_state(state, want[2])


def test_generators_in_lockstep(one_step):
    """Every draw came from each rank's generator at the global shapes:
    every generator ends where the single process's does."""
    got, want = one_step
    for _, _, state in got:
        assert torch.equal(state["generator"], want[2]["generator"])


@pytest.fixture(scope="module")
def against_jax(runs):
    return runs["jax"], [r["jax"] for r in runs["ranks"][2]], \
        runs["single"]["jax"]


@pytest.mark.parametrize("term", TERMS)
def test_jax_sharded_loss_terms(against_jax, term):
    (_, jm), got, single = against_jax
    for metrics, _, _ in got:
        np.testing.assert_allclose(metrics[0][term], float(jm[term]),
                                   **LOSS_TOL)
    _assert_metrics(got[0][0][0], single[0][0])


def test_jax_sharded_prediction_map(against_jax):
    (_, jm), got, _ = against_jax
    for _, pred, _ in got:
        np.testing.assert_array_equal(pred.numpy(), jm["pred_l_label"])


def _assert_module(got_sd, expected_sd):
    for name, want in expected_sd.items():
        if name.endswith("num_batches_tracked"):
            continue
        np.testing.assert_allclose(got_sd[name].numpy(), want.numpy(),
                                   err_msg=name, **STATE_TOL)


def test_jax_sharded_weights_and_bn_stats(against_jax):
    (ja, _), got, _ = against_jax
    for _, _, state in got:
        _assert_module(state["model"], unet_state_dict_from_flax(
            ja["params"]["model"], ja["batch_stats"]["model"]))
        _assert_module(state["ema_model"], unet_state_dict_from_flax(
            ja["ema_params"]["model"], ja["ema_batch_stats"]["model"]))
        _assert_module(state["feature_extractor"],
                       feature_extractor_state_dict_from_flax(
                           ja["params"]["feature_extractor"]))
        _assert_module(state["q_representation"],
                       head_state_dict_from_flax(
                           ja["params"]["q_representation"]))
        _assert_module(state["k_feature_extractor"],
                       feature_extractor_state_dict_from_flax(
                           ja["k_feature_params"]))


def test_jax_sharded_bank_and_pool(against_jax):
    (ja, _), got, _ = against_jax
    for _, _, state in got:
        bank = state["bank"]
        np.testing.assert_array_equal(bank["ptr"].numpy(),
                                      ja["memobank"]["ptr"])
        np.testing.assert_array_equal(bank["count"].numpy(),
                                      ja["memobank"]["count"])
        np.testing.assert_array_equal((bank["data"] != 0).any(-1).numpy(),
                                      (ja["memobank"]["data"] != 0).any(-1))
        np.testing.assert_allclose(bank["data"].numpy(),
                                   ja["memobank"]["data"], **STATE_TOL)
        assert state["pool_ptr"] == ja["random_pool_ptr"] == 0
        np.testing.assert_allclose(state["pool"].numpy(), ja["random_pool"],
                                   **STATE_TOL)
        assert state["step"] == ja["step"] == 1
    assert float(got[0][0][0]["reco_loss"]) > 0
    assert (ja["memobank"]["ptr"] > 1).all()


def test_trajectory_losses(runs):
    want = runs["single"]["traj"]
    for got in (r["trajectory"] for r in runs["ranks"][2]):
        assert len(got[0]) == ranks.TRAJ_STEPS
        for g, w in zip(got[0], want[0]):
            for k in ("loss", "reco_loss", "loss_ce", "loss_dice"):
                np.testing.assert_allclose(g[k], w[k], err_msg=k,
                                           **TRAJ_TOL)


def test_trajectory_bank_wrapped_and_state(runs):
    """The banks wrapped twice (1 + 9 * 16 keys into 64 rows) and the
    pool every step, in the same places as one process's; the
    generators in lockstep after 9 steps."""
    want = runs["single"]["traj"][2]
    assert want["bank"]["ptr"].tolist() == [(1 + 16 * 9) % 64] * 4
    assert want["bank"]["count"].tolist() == [64] * 4
    for _, _, state in (r["trajectory"] for r in runs["ranks"][2]):
        for k in ("ptr", "count"):
            assert torch.equal(state["bank"][k], want["bank"][k])
        assert state["pool_ptr"] == want["pool_ptr"] == 0
        assert state["step"] == want["step"] == ranks.TRAJ_STEPS
        assert torch.equal(state["generator"], want["generator"])
        np.testing.assert_allclose(state["model"]["decoder.out_conv.weight"]
                                   .numpy(),
                                   want["model"]["decoder.out_conv.weight"].numpy(),
                                   rtol=3e-2, atol=3e-4)


def test_dryrun_on_a_2x2_mesh(runs):
    for rec in (r["dryrun"] for r in runs["ranks"][4]):
        assert rec["mesh"] == ((2, 2), ("data", "space"))
        assert np.isfinite(rec["loss"]) and rec["step"] == 1
        assert rec["spatial_err"] <= 1e-5
    losses = {r["dryrun"]["loss"] for r in runs["ranks"][4]}
    assert len(losses) == 1


@pytest.mark.parametrize("case", [*ranks.CASES3D, "flags"])
def test_step_matches_single_process(runs, case):
    want = runs["single"][case]
    assert want[0][0]["unsup_loss"] > 0 and want[0][0]["reco_loss"] > 0
    for metrics, pred, state in (r[case] for r in runs["ranks"][2]):
        _assert_metrics(metrics[0], want[0][0])
        assert torch.equal(pred, want[1])
        _assert_state(state, want[2])
        assert torch.equal(state["generator"], want[2]["generator"])
