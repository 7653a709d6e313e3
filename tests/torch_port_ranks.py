"""What each gloo rank of tests/test_torch_port_parallel.py runs.

A separate module that imports no JAX: ``torch.multiprocessing.spawn``
starts each rank in a fresh interpreter, which imports the rank function's
module. The ranks of one spawn serve every world size in turn, each
rank writing what it computed to ``<out>/ranks<world>_rank<r>.pt``; the
test holds it against the single-process results. The rendezvous is a
FileStore under the test's tmp_path (no TCP port, which would collide
across xdist workers) with a timeout, so a hung rank fails the test.
"""

import datetime
import os

import numpy as np
import torch
import torch.distributed as dist

from arco_torch.inference import Segmenter3D
from arco_torch.models import net_factory, net_factory_3d
from arco_torch.parallel import create_mesh, replicate, shard_batch
from arco_torch.parallel.mesh import axis_rank
from arco_torch.parallel.spatial import (_halo_pass, shard_volume,
                                         sharded_volume_forward)
from arco_torch.train.supervised import (PolySGD, init_supervised_state,
                                         make_supervised_step)

TIMEOUT = datetime.timedelta(seconds=120)
DP_B, DP_HW, DP_NC, DP_STEPS = 8, 16, 2, 2
# world size -> (volume shape, seed, halo) of tests/test_inference_sharded.py
CASES = {4: ((60, 32, 32), 0, 16), 2: ((40, 37, 29), 1, 8)}


def volume(world):
    """(the seeded volume, halo) that ``world`` ranks segment. Each rank
    makes it itself: spawn's arguments go through a pipe that a large
    array would hold up, starting the ranks one after another."""
    shape, seed, halo = CASES[world]
    return np.random.RandomState(seed).randn(*shape).astype(np.float32), \
        halo


def small_conv_net():
    """3 SAME 3x3x3 convs with ReLUs and a 1x1x1 head: receptive-field
    half-width 3 (tests/test_spatial_sharding.py:SmallConvNet)."""
    torch.manual_seed(0)
    layers = []
    for i in range(3):
        layers += [torch.nn.Conv3d(1 if i == 0 else 8, 8, 3, padding=1),
                   torch.nn.ReLU()]
    return torch.nn.Sequential(*layers, torch.nn.Conv3d(8, 2, 1)).eval()


def conv_volume():
    return torch.from_numpy(np.random.RandomState(0).randn(1, 1, 32, 8, 8)
                            .astype(np.float32))


def dp_batch():
    rs = np.random.RandomState(0)
    label = rs.randint(0, DP_NC, size=(DP_B, DP_HW, DP_HW))
    image = label[:, None].astype(np.float32) \
        + 0.1 * rs.randn(DP_B, 1, DP_HW, DP_HW).astype(np.float32)
    return {"image": torch.from_numpy(image),
            "label": torch.from_numpy(label)}


def dp_masks(model):
    """The whole batch's dropout keep-masks, one draw per step."""
    gen = torch.Generator().manual_seed(5)
    model.train()
    return [model.draw_dropout_masks((DP_B, 1, DP_HW, DP_HW), gen)
            for _ in range(DP_STEPS)]


def dp_model():
    torch.manual_seed(0)
    return net_factory("unet", in_chns=1, class_num=DP_NC)


def run_supervised(model, mesh=None):
    """DP_STEPS supervised steps over dp_batch() (a rank's shard of it with
    a ``mesh``): (metrics per step, the model's state dict)."""
    masks = dp_masks(model)
    tx = PolySGD(0.01, 10)
    state = init_supervised_state(model, tx, device="cpu")
    step = make_supervised_step(model, tx, DP_NC, mesh=mesh)
    batch = dp_batch() if mesh is None else shard_batch(dp_batch(), mesh)
    metrics = []
    for m in masks:
        if mesh is not None:
            m = shard_batch(m, mesh)
        state, met = step(state, batch, m)
        metrics.append({k: float(v) for k, v in met.items()})
    return metrics, {k: v.clone() for k, v in model.state_dict().items()}


def error_cases(n):
    """The four ValueErrors of sharded_volume_forward (halo < 1, an axis
    that does not divide over the ranks, a halo wider than the local
    shard, a slab off the lattice) at ``n`` ranks: name -> (keywords,
    volume shape)."""
    local = 32 // n
    return {"halo": (dict(halo=0), (1, 1, 32, 8, 8)),
            "divide": (dict(halo=2), (1, 1, 31, 8, 8)),
            "wide": (dict(halo=local + 1), (1, 1, 32, 8, 8)),
            "lattice": (dict(halo=3, lattice=16), (1, 1, 32, 8, 8))}


def _errors(mesh, forward, n):
    out = {}
    for name, (kw, shape) in error_cases(n).items():
        try:
            sharded_volume_forward(forward, mesh, **kw)(torch.zeros(shape))
        except ValueError as e:
            out[name] = str(e)
    return out


def run(rank, store_dir, out_dir, vnet_path):
    """One spawned process: for each world size of ``CASES``, in order,
    join a process group of that size if this rank lies in it, run
    ``run_world`` and leave the group. One spawn serves every world size,
    so the ranks start and import once."""
    torch.set_num_threads(1)
    for world in CASES:
        if rank >= world:
            continue
        dist.init_process_group(
            "gloo", store=dist.FileStore(
                os.path.join(store_dir, f"store{world}"), world),
            rank=rank, world_size=world, timeout=TIMEOUT)
        try:
            res = run_world(rank, world, vnet_path)
            torch.save(res, os.path.join(out_dir,
                                         f"ranks{world}_rank{rank}.pt"))
        finally:
            dist.destroy_process_group()


def run_world(rank, world, vnet_path):
    """What every rank of a ``world``-rank group computes."""
    mesh = create_mesh((-1,))
    idx, n, group = axis_rank(mesh)
    res = {"mesh": (tuple(mesh.shape), mesh.mesh_dim_names, idx, n)}

    x = torch.arange(16, dtype=torch.float32).reshape(1, 16, 1)
    res["halo"] = _halo_pass(shard_volume(x, mesh, spatial_axis=1),
                             group, 2, 1)[0, :, 0]

    net = small_conv_net()
    with torch.no_grad():
        res["conv"] = sharded_volume_forward(
            net, mesh, halo=4, spatial_axis=2)(conv_volume())
        res["errors"] = _errors(mesh, net, n)

    vnet = net_factory_3d("vnet", in_chns=1, class_num=2)
    vnet.load_state_dict(torch.load(vnet_path, weights_only=True))
    seg = Segmenter3D(vnet, num_classes=2, device="cpu")
    vol, halo = volume(world)
    res["sharded"] = seg.predict_volume_sharded(vol, mesh=mesh,
                                                halo=halo, lattice=16)

    res["dp"] = run_supervised(dp_model(), mesh)

    torch.manual_seed(100 + rank)
    mine = torch.nn.Linear(3, 2)
    res["replicated"] = replicate(mine, mesh).weight.detach().clone()
    res["shard"] = shard_batch({"a": torch.arange(8), "b": [
        np.arange(16).reshape(8, 2)]}, mesh)
    try:
        shard_batch({"a": torch.arange(world + 1)}, mesh)
    except ValueError as e:
        res["shard_error"] = str(e)
    return res
