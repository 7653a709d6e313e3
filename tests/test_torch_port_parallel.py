"""The port's torch.distributed layer (arco_torch/parallel/) on gloo ranks
of the CPU, started once with ``torch.multiprocessing.spawn`` and run at
world sizes 4 and 2 (tests/torch_port_ranks.py runs in each rank).

- the halo slabs reach the right neighbours and the global edges take
  zeros (tests/test_spatial_sharding.py:33-93);
- ``sharded_volume_forward`` equals the unsharded forward away from the
  global edges' receptive-field band and across every shard boundary
  (rtol/atol 1e-5, JAX's bound), and raises JAX's four ValueErrors;
- ``Segmenter3D.predict_volume_sharded`` on the 60x32x32 (4 ranks) and
  40x37x29 (2 ranks) volumes of tests/test_inference_sharded.py: the input's
  shape, int32, labels equal to JAX's predict_volume_sharded on the same
  seeded V-Net weights (8 virtual CPU devices) at >= 99.9%, and to the
  port's unsharded whole-volume forward exactly away from the global depth
  edges (>= 97% overall, JAX's bound);
- the data-parallel supervised step equals the single-process step on
  the whole batch (tests/test_parallel.py:47-73): loss terms and weights
  after two steps at rtol 1e-4, on every rank;
- ``replicate``, ``shard_batch`` and ``create_mesh((-1,))``.
"""

import os

import jax
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from arco_tpu import inference as jinf
from arco_tpu.models import net_factory_3d as jax_net_factory_3d
from arco_tpu.parallel import create_mesh as jax_create_mesh

import torch_port_ranks as ranks
from arco_torch.compat.from_flax import vnet_state_dict_from_flax
from arco_torch.inference import Segmenter3D
from arco_torch.models import net_factory_3d
from arco_torch.parallel.spatial import _crop
from test_torch_port_supervised import seeded_variables

torch.set_num_threads(1)



@pytest.fixture(scope="module")
def vnet(tmp_path_factory):
    jm = jax_net_factory_3d("vnet", in_chns=1, class_num=2)
    params, stats = seeded_variables(jm, (1, 32, 32, 32, 1), seed=11)
    path = str(tmp_path_factory.mktemp("vnet") / "vnet.pt")
    sd = vnet_state_dict_from_flax(params, stats)
    torch.save(sd, path)
    model = net_factory_3d("vnet", in_chns=1, class_num=2)
    model.load_state_dict(sd)
    return jm, params, stats, path, Segmenter3D(model, device="cpu")


@pytest.fixture(scope="module")
def spawned(vnet, tmp_path_factory):
    """Every rank's results at every world size, from one spawn of 4
    processes (ranks 0 and 1 go on to the 2-rank group)."""
    out = tmp_path_factory.mktemp("ranks")
    mp.spawn(ranks.run, nprocs=max(ranks.CASES), join=True,
             args=(str(out), str(out), vnet[3]))
    return {n: [torch.load(os.path.join(out, f"ranks{n}_rank{r}.pt"),
                           weights_only=False) for r in range(n)]
            for n in ranks.CASES}


@pytest.fixture(scope="module", params=[4, 2], ids=["4ranks", "2ranks"])
def world(request, spawned):
    """Every rank's results at one world size."""
    return request.param, spawned[request.param]


def test_mesh_resolves_minus_one(world):
    n, res = world
    for r, rec in enumerate(res):
        assert rec["mesh"] == ((n,), ("data",), r, n)


def test_halo_pass_slab_routing(world):
    """Each shard's extension holds the true neighbour slabs; the global
    edges extend with zeros."""
    n, res = world
    per, halo = 16 // n, 2
    for r, rec in enumerate(res):
        lo, hi = r * per, (r + 1) * per
        want = [v if 0 <= v < 16 else 0.0
                for v in range(lo - halo, hi + halo)]
        np.testing.assert_array_equal(rec["halo"].numpy(), want)


def test_crop_inverts_pad():
    x = torch.arange(10.0).reshape(1, 10, 1)
    np.testing.assert_array_equal(_crop(x, 2, 1)[0, :, 0].numpy(),
                                  [2, 3, 4, 5, 6, 7])


def test_halo_exchange_matches_unsharded(world):
    n, res = world
    with torch.no_grad():
        want = ranks.small_conv_net()(ranks.conv_volume()).numpy()
    rf = 3
    for rec in res:     # every rank gets the whole output
        got = rec["conv"].numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got[:, :, rf:-rf], want[:, :, rf:-rf],
                                   rtol=1e-5, atol=1e-5)
        for b in range(32 // n, 32, 32 // n):     # the shard boundaries
            np.testing.assert_allclose(got[:, :, b - 2:b + 2],
                                       want[:, :, b - 2:b + 2],
                                       rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("case", ["halo", "divide", "wide", "lattice"])
def test_sharded_forward_errors(world, case):
    """JAX's messages (arco_tpu/parallel/spatial.py:108-133), word for
    word; the halo case also keeps JAX's reason."""
    n, res = world
    local = 32 // n
    words = {
        "halo": "halo must be >= 1 (for halo=0 run the forward without "
                "sharded_volume_forward)",
        "divide": f"volume axis 2 (31) must divide evenly over mesh axis "
                  f"'data' ({n} shards)",
        "wide": f"halo ({local + 1}) exceeds the local shard extent "
                f"({local}); use fewer shards or a smaller halo",
        "lattice": f"extended slab {local}+2*3={local + 6} is not a "
                   f"multiple of the model's stride lattice (16); pick "
                   f"halo so that (D/shards + 2*halo) % 16 == 0"}[case]
    for rec in res:
        assert rec["errors"][case] == words


def test_predict_volume_sharded_matches_jax(world, vnet):
    n, res = world
    jm, params, stats, *_ = vnet
    vol, halo = ranks.volume(n)
    # device_eval=False jits JAX's local forward inside its shard_map (the
    # same arithmetic; eagerly a call takes ~27 s on the CPU)
    seg = jinf.Segmenter3D(jm, params, stats, num_classes=2,
                           device_eval=False)
    mesh = jax_create_mesh((n,), ("data",), devices=jax.devices()[:n])
    want = seg.predict_volume_sharded(vol, mesh=mesh, halo=halo, lattice=16)
    for rec in res:
        got = rec["sharded"]
        assert got.shape == vol.shape and got.dtype == np.int32
        agree = (got == want).mean()
        assert agree >= 0.999, agree


def test_predict_volume_sharded_matches_unsharded(world, vnet):
    """The port's unsharded whole-volume forward on the same padded
    volume: exact away from the global depth edges."""
    n, res = world
    seg = vnet[4]
    vol, _ = ranks.volume(n)
    d, h, w = vol.shape
    d_pad = -(-d // (16 * n)) * 16 * n
    x = np.pad(vol, ((0, d_pad - d), (0, -h % 16), (0, -w % 16)))
    want = seg._probs(torch.from_numpy(x)[None, None]).argmax(1)[0] \
        .numpy()[:d, :h, :w]
    got = res[0]["sharded"]
    assert (got == want).mean() > 0.97
    # tests/test_inference_sharded.py holds [24:40] of 60; the shard
    # boundaries (16, 32, 48 and 32) lie well inside [8, d - 8)
    np.testing.assert_array_equal(got[8:d - 8], want[8:d - 8])
    for rec in res[1:]:
        np.testing.assert_array_equal(rec["sharded"], got)


def test_data_parallel_step_matches_single_process(world):
    n, res = world
    want_metrics, want_sd = ranks.run_supervised(ranks.dp_model())
    for rec in res:
        metrics, sd = rec["dp"]
        for got, want in zip(metrics, want_metrics):
            for k in want:
                np.testing.assert_allclose(got[k], want[k], rtol=1e-4,
                                           err_msg=k)
        for k, v in want_sd.items():
            if v.is_floating_point():
                np.testing.assert_allclose(sd[k].numpy(), v.numpy(),
                                           rtol=1e-4, atol=1e-6,
                                           err_msg=k)


def test_replicate_and_shard_batch(world):
    n, res = world
    torch.manual_seed(100)
    want = torch.nn.Linear(3, 2).weight.detach()
    per = 8 // n
    for r, rec in enumerate(res):
        assert torch.equal(rec["replicated"], want)
        assert torch.equal(rec["shard"]["a"],
                           torch.arange(r * per, (r + 1) * per))
        assert isinstance(rec["shard"]["b"], list)
        assert torch.equal(rec["shard"]["b"][0],
                           torch.arange(16).reshape(8, 2)[r * per:
                                                          (r + 1) * per])
        assert rec["shard_error"] == (
            f"batch axis ({n + 1}) must divide evenly over mesh axis "
            f"'data' ({n} shards)")
