"""A multi-rank dry run of the data-parallel stage-2 ARCO step
(counterpart of ``__graft_entry__.dryrun_multichip``).

    python -m arco_torch.parallel.dryrun 4                # 4 ranks, the card
    python -m arco_torch.parallel.dryrun 4 --device cpu   # 4 gloo CPU ranks

``dryrun_multichip(n)`` starts ``n`` ranks; each runs ``dryrun_rank``: one
ARCO step at JAX's dry-run configuration (U-Net, 4 classes, 32x32, a
batch of n labeled + n unlabeled, small banks and queries) with the batch
sharded over both axes of an (n // 2, 2) ("data", "space") mesh for even
n >= 4, over a "data" mesh otherwise; then, on the 2-axis mesh, a small
3D conv forward sharded in depth over "space" with a halo exchange, which
must equal the unsharded forward away from the volume's depth edges.

On the card the ranks take NCCL, one card a rank, where there are ``n``
cards, and gloo over CUDA tensors of the cards otherwise (several ranks to
a card); with ``device="cpu"`` they are gloo ranks on the CPU.
"""

from __future__ import annotations

import argparse
import datetime
import math
import os
import tempfile

import numpy as np
import torch
import torch.distributed as dist

from arco_torch import resolve_device
from arco_torch.config import ArcoConfig, OptimConfig
from arco_torch.models import net_factory
from arco_torch.parallel.mesh import create_mesh, replicate, shard_batch
from arco_torch.parallel.spatial import sharded_volume_forward
from arco_torch.train.arco2d import (init_arco_state, make_arco_modules,
                                     make_arco_step)

TIMEOUT = datetime.timedelta(seconds=300)


def dryrun_rank(n_devices: int, device="cuda"):
    """One rank's dry run, inside an initialised process group of
    ``n_devices`` ranks, on ``device`` (this rank's card by default).
    Returns {"mesh", "loss", "step"} and, on the 2-axis mesh,
    "spatial_err" (the largest difference from the unsharded forward away
    from the depth edges); raises if the loss is not finite, the step
    counter is not 1 or the spatial leg disagrees."""
    device = resolve_device(device)
    two_axis = n_devices >= 4 and n_devices % 2 == 0
    mesh = create_mesh((n_devices // 2, 2) if two_axis else (n_devices,),
                       ("data", "space") if two_axis else ("data",),
                       device_type=device.type)
    axes = tuple(mesh.mesh_dim_names)
    b, hw, k = n_devices, 32, 4
    cfg = ArcoConfig(K=b, num_queries=16, num_negatives=8, memobank_size=64,
                     memobank_size_bg=128, memobank_enqueue=16, topk=2)
    optim = OptimConfig(base_lr=0.01)
    torch.manual_seed(0)
    modules = make_arco_modules(net_factory("unet", in_chns=1, class_num=k),
                                hw, hw, batch_size=b)
    state = init_arco_state(modules, cfg, (b, 1, hw, hw), optim, seed=0,
                            device=device)
    for m in (state.model, state.ema_model, state.feature_extractor,
              state.k_feature_extractor, state.q_representation):
        replicate(m, mesh, axes)

    rng = np.random.RandomState(0)
    label = rng.randint(0, k, size=(b, hw, hw)).astype(np.int64)
    image = label[:, None].astype(np.float32) / (k - 1)
    batch = shard_batch({"image_l": image, "label_l": label,
                         "image_u": image}, mesh, axes)
    step = make_arco_step(modules, cfg, num_classes=k, max_iterations=100,
                          optim=optim, device=device, mesh=mesh)
    loss = float(step(state, batch)["loss"])
    if not math.isfinite(loss) or state.step != 1:
        raise AssertionError(f"dry run: loss {loss}, step {state.step}")
    out = {"mesh": (tuple(mesh.shape), axes), "loss": loss,
           "step": state.step}
    if two_axis:
        out["spatial_err"] = _dryrun_spatial(mesh, device)
    return out


def _dryrun_spatial(mesh, device) -> float:
    """A depth-sharded 3D conv forward with the halo exchange over the
    mesh's "space" axis against the unsharded forward, away from the
    global depth edges (the halo contract, parallel/spatial.py)."""
    torch.manual_seed(0)
    probe = torch.nn.Sequential(
        torch.nn.Conv3d(1, 8, 3, padding=1), torch.nn.ReLU(),
        torch.nn.Conv3d(8, 8, 3, padding=1), torch.nn.ReLU(),
        torch.nn.Conv3d(8, 2, 1)).to(device)
    n_space = mesh.shape[mesh.mesh_dim_names.index("space")]
    depth, halo, rf = 8 * n_space, 2, 2   # 2 stacked 3x3x3: half-width 2
    vol = torch.randn((1, 1, depth, 8, 8),
                      generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        want = probe(vol.to(device))
        got = sharded_volume_forward(probe, mesh, halo=halo, spatial_axis=2,
                                     mesh_axis="space")(vol)
    if got.shape != want.shape:
        raise AssertionError(f"spatial leg: shape {tuple(got.shape)}, "
                             f"want {tuple(want.shape)}")
    inner = (slice(None), slice(None), slice(rf, depth - rf))
    err = (got[inner] - want[inner]).abs().max().item()
    if not err <= 1e-5 + 1e-5 * want[inner].abs().max().item():
        raise AssertionError(f"spatial leg: {err} from the unsharded")
    return err


def _rank(rank, n_devices, device_type, store_dir):
    if device_type == "cuda":
        cards = torch.cuda.device_count()
        backend = "nccl" if cards >= n_devices else "gloo"
        torch.cuda.set_device(rank % cards)
        device = torch.device("cuda", rank % cards)
    else:
        backend = "gloo"
        torch.set_num_threads(1)
        device = torch.device("cpu")
    dist.init_process_group(
        backend, store=dist.FileStore(os.path.join(store_dir, "store"),
                                      n_devices),
        rank=rank, world_size=n_devices, timeout=TIMEOUT)
    try:
        out = dryrun_rank(n_devices, device)
        if rank == 0:
            print(f"dryrun_multichip({n_devices}, {backend} on "
                  f"{device_type}): {out}", flush=True)
    finally:
        dist.destroy_process_group()


def dryrun_multichip(n_devices: int, device="cuda") -> None:
    """Run ``dryrun_rank`` on ``n_devices`` ranks on ``device``'s type
    (the cards by default, "cpu" for gloo CPU ranks); raises if a rank
    fails."""
    import torch.multiprocessing as mp
    device = resolve_device(device)
    with tempfile.TemporaryDirectory() as store_dir:
        mp.spawn(_rank, nprocs=n_devices, join=True,
                 args=(n_devices, device.type, store_dir))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("n_devices", type=int, nargs="?", default=4)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = p.parse_args(argv)
    dryrun_multichip(args.n_devices, args.device)


if __name__ == "__main__":
    main()
