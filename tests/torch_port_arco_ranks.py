"""What each gloo rank of tests/test_torch_port_arco_parallel.py runs, and
the single-process runs that the test holds them against.

A separate module that imports no JAX: ``torch.multiprocessing.spawn``
starts each rank in a fresh interpreter, which imports the rank function's
module. One spawn of 4 processes serves every world size: the 4 ranks run
world size 4, then ranks 0 and 1 a fresh group of 2 while ranks 2 and 3
run the single-process steps, outside any group. Each rank writes what it
computed to ``<out>/arco<world>_rank<r>.pt``, the single-process runs to
``<out>/single_<case>.pt``. The rendezvous is a
FileStore under the test's tmp_path with a timeout, so a hung rank fails
the test. Every rank builds its inputs itself from seeds (spawn's
arguments go through a pipe that a large array would hold up).
"""

import contextlib
import datetime
import os

import numpy as np
import torch
import torch.distributed as dist

from arco_torch.compat.from_flax import load_flax_arco_state
from arco_torch.config import ArcoConfig, OptimConfig
from arco_torch.models import net_factory, net_factory_3d
from arco_torch.models.unet2d import UNet
from arco_torch.parallel import create_mesh, shard_batch
from arco_torch.parallel.dryrun import dryrun_rank
from arco_torch.train import arco2d

TIMEOUT = datetime.timedelta(seconds=120)
WORLDS = (4, 2)
OPTIM = OptimConfig(base_lr=0.01)

# tests/test_parallel.py:144's configuration: U-Net (dropout on), 3
# classes, 32x32, 8 labeled + 8 unlabeled, the ArcoConfig defaults but
# for small banks and queries (photometric and AdvMorph on)
B, HW, NC = 8, 32, 3
CFG = dict(K=8, num_queries=16, num_negatives=8, memobank_size=64,
           memobank_size_bg=64, memobank_enqueue=16, topk=2)
# the trajectory: that configuration at 4 classes (at 3 the sampler's
# rank window [3, 20) holds no class, so no key reaches the banks), 4 + 4
# and a 4-row pool, with the pseudo-label thresholds at 0.3 (so that the
# unsup and eqv masks are live at random init); the banks (64 rows, 16
# keys a step) wrap at steps 4 and 8, the pool every step
TRAJ_B, TRAJ_NC, TRAJ_STEPS, TRAJ_BATCHES = 4, 4, 9, 5
TRAJ_CFG = dict(CFG, K=4, strong_threshold=0.3, weak_threshold=0.3)
# the options whose draws or forwards the defaults leave out: ClassMix
# scores, antithetic sampler uniforms, the dead forward's dropout, the
# histogram percentiles, and remat's recomputed forwards (which take the
# global BatchNorm statistics again), at the trajectory's size
FLAGS_CFG = dict(TRAJ_CFG, apply_aug="classmix", func="asmc",
                 dead_forward=True, fast_percentile=True, remat=True)

# the JAX comparison: tests/test_torch_port_step.py's configuration (no
# dropout, no photometric or AdvMorph draws) at a global batch of 8 + 8,
# one sample a device of JAX's 8-device mesh (an 8-row pool: its capacity
# takes whole global batches)
JB, JHW, JNC = 8, 32, 4
JCFG = dict(K=8, num_queries=16, num_negatives=8, memobank_size=128,
            memobank_size_bg=256, memobank_enqueue=32, topk=2,
            strong_threshold=0.3, weak_threshold=0.3,
            use_photometric=False, use_adv_morph=False)

# the 3D cases: tests/test_torch_port_3d_step.py's flags at 2 + 2 a rank
# (a pool of 4 rows: its capacity takes whole global batches), as (volume,
# dtype). At 32x32x16 the V-Net's bottleneck BatchNorm normalizes 16 values
# a channel; in f32 the mesh's sums, taken in another order, then moved the
# state by up to 3.7e-5 after the step, and one predicted label of 65536
# flipped. In float64 the same step agrees to 1.3e-8 (the softmaxes stay
# f32, as JAX's do) with no flip, so that case runs in float64, and the f32
# route is held at 64x64x16 (64 values a channel).
CASES3D = {"3d": ((32, 32, 16), torch.float64),
           "3d_f32": ((64, 64, 16), torch.float32)}
B3, NC3 = 4, 2
FEA3, FUSED3 = (128, 64, 32, 16, 16), 16
CFG3 = dict(K=4, num_queries=16, num_negatives=8, memobank_size=128,
            memobank_size_bg=128, memobank_enqueue=32, topk=2,
            strong_threshold=0.55, weak_threshold=0.55,
            use_eqv_loss=False, compute_eqv=True, use_photometric=False,
            use_adv_morph=False, memobank_init="randn")


def batch2d(seed, b=B, hw=HW, nc=NC):
    """tests/test_parallel.py's batch: labels, image = label / (nc - 1) +
    noise, the same images labeled and unlabeled."""
    rs = np.random.RandomState(seed)
    label = rs.randint(0, nc, size=(b, hw, hw)).astype(np.int64)
    image = (label[:, None].astype(np.float32) / (nc - 1)
             + 0.05 * rs.randn(b, 1, hw, hw).astype(np.float32))
    image = torch.from_numpy(image)
    return {"image_l": image, "label_l": torch.from_numpy(label),
            "image_u": image.clone()}


def batch3d(seed, s3, dtype):
    rs = np.random.RandomState(seed)
    label = rs.randint(0, NC3, size=(2 * B3,) + s3).astype(np.int64)
    image = torch.from_numpy(label[:, None].astype(np.float32)
                             + 0.2 * rs.randn(2 * B3, 1, *s3)
                             .astype(np.float32)).to(dtype)
    return {"image_l": image[:B3], "label_l": torch.from_numpy(label[:B3]),
            "image_u": image[B3:].contiguous()}


def build(kind):
    """(modules, state, cfg, num classes) of one case, from seeds: the
    same on every rank and in the single process."""
    torch.manual_seed(0)
    dtype = torch.float32
    if kind in CASES3D:
        s3, dtype = CASES3D[kind]
        cfg = ArcoConfig(**CFG3)
        model = net_factory_3d("vnet", in_chns=1, class_num=NC3)
        mods = arco2d.make_arco_modules(model, s3[1], s3[0], batch_size=B3,
                                        feature_channels=FEA3,
                                        fused_dim=FUSED3)
        shape, nc = (B3, 1) + s3, NC3
    elif kind == "jax":
        cfg = ArcoConfig(**JCFG)
        model = UNet(in_chns=1, class_num=JNC, dropout=(0.0,) * 5)
        mods = arco2d.make_arco_modules(model, JHW, JHW, batch_size=JB)
        shape, nc = (JB, 1, JHW, JHW), JNC
    else:
        cfg, nc, b = (ArcoConfig(**CFG), NC, B) if kind == "2d" \
            else (ArcoConfig(**(FLAGS_CFG if kind == "flags"
                                else TRAJ_CFG)), TRAJ_NC, TRAJ_B)
        model = net_factory("unet", in_chns=1, class_num=nc)
        mods = arco2d.make_arco_modules(model, HW, HW, batch_size=b)
        shape = (b, 1, HW, HW)
    state = arco2d.init_arco_state(mods, cfg, shape, OPTIM, seed=0,
                                   device="cpu", compute_dtype=dtype,
                                   pool_dtype=dtype)
    return mods, state, cfg, nc


@contextlib.contextmanager
def default_dtype(dtype):
    old = torch.get_default_dtype()
    torch.set_default_dtype(dtype)
    try:
        yield
    finally:
        torch.set_default_dtype(old)


def snapshot(state):
    """What the step leaves in the state, cloned."""
    sd = lambda m: {k: v.detach().clone() for k, v in m.state_dict().items()}
    return {"model": sd(state.model), "ema_model": sd(state.ema_model),
            "feature_extractor": sd(state.feature_extractor),
            "k_feature_extractor": sd(state.k_feature_extractor),
            "q_representation": sd(state.q_representation),
            "bank": {"data": state.memobank.data.clone(),
                     "ptr": state.memobank.ptr.clone(),
                     "count": state.memobank.count.clone()},
            "pool": state.random_pool.clone(),
            "pool_ptr": state.random_pool_ptr, "step": state.step,
            "generator": state.generator.get_state()}


def scalars(metrics):
    return {k: float(v) for k, v in metrics.items() if v.ndim == 0}


def run_case(kind, mesh=None, steps=1, start=None, draws=None):
    """``steps`` steps of one case, over the whole batch or, with a
    ``mesh``, over this rank's shard of it: (the metrics of each step, the
    last step's predicted labels, the state after). ``start``: a JAX
    state (tests/test_torch_port_step.py's ``_flax_state_numpy``) to load
    first; ``draws``: the draws of the first step. A float64 case builds
    and steps under that default dtype."""
    dtype = CASES3D.get(kind, (None, torch.float32))[1]
    with default_dtype(dtype):
        return _run_case(kind, mesh, steps, start, draws)


def _run_case(kind, mesh, steps, start, draws):
    mods, state, cfg, nc = build(kind)
    if start is not None:
        load_flax_arco_state(state, start)
    step = arco2d.make_arco_step(mods, cfg, num_classes=nc,
                                 max_iterations=100, optim=OPTIM,
                                 device="cpu", mesh=mesh)
    if kind in CASES3D:
        batches = [batch3d(0, *CASES3D[kind])]
    elif kind == "jax":
        batches = [jax_batch()]
    elif kind == "2d":
        batches = [batch2d(0)]
    else:
        batches = [batch2d(i, b=TRAJ_B, nc=TRAJ_NC)
                   for i in range(TRAJ_BATCHES)]
    out = []
    for i in range(steps):
        batch = batches[i % len(batches)]
        if mesh is not None:
            batch = shard_batch(batch, mesh, mesh.mesh_dim_names)
        m = step(state, batch, draws if i == 0 else None)
        out.append(scalars(m))
    return out, m["pred_l_label"].clone(), snapshot(state)


def jax_batch():
    """tests/test_torch_port_step.py's batches (seeds 0 and 7) at JB."""
    def one(seed):
        rs = np.random.RandomState(seed)
        label = rs.randint(0, JNC, size=(JB, JHW, JHW)).astype(np.int32)
        image = label[..., None].astype(np.float32) / (JNC - 1) \
            + 0.1 * rs.randn(JB, JHW, JHW, 1).astype(np.float32)
        return image, label
    image_l, label_l = one(0)
    image_u, _ = one(7)
    nchw = lambda x: torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()
    return {"image_l": nchw(image_l), "label_l": torch.from_numpy(label_l),
            "image_u": nchw(image_u)}


# the single-process runs: which process of the spawn runs them, once it
# is outside the 2-rank group
SINGLE = {2: (("traj", TRAJ_STEPS), ("3d", 1), ("3d_f32", 1)),
          3: (("2d", 1), ("jax", 1), ("flags", 1))}


def run(rank, store_dir, out_dir, jax_inputs):
    """One spawned process: for each world size of ``WORLDS``, in order,
    join a process group of that size if this rank lies in it, run
    ``run_world`` and leave the group; outside the last group, run its
    share of the single-process steps."""
    torch.set_num_threads(1)
    for world in WORLDS:
        if rank >= world:
            for kind, steps in SINGLE.get(rank, ()) if world == 2 else ():
                kw = {}
                if kind == "jax":
                    start, draws = torch.load(jax_inputs, weights_only=False)
                    kw = {"start": start, "draws": draws}
                torch.save(run_case(kind, steps=steps, **kw),
                           os.path.join(out_dir, f"single_{kind}.pt"))
            continue
        dist.init_process_group(
            "gloo", store=dist.FileStore(
                os.path.join(store_dir, f"arco_store{world}"), world),
            rank=rank, world_size=world, timeout=TIMEOUT)
        try:
            res = run_world(world, jax_inputs)
            torch.save(res, os.path.join(out_dir,
                                         f"arco{world}_rank{rank}.pt"))
        finally:
            dist.destroy_process_group()


def run_world(world, jax_inputs):
    """What every rank of a ``world``-rank group computes."""
    mesh = create_mesh((world,))
    res = {"one": run_case("2d", mesh)}
    if world == 4:
        res["dryrun"] = dryrun_rank(4, device="cpu")
        return res
    start, draws = torch.load(jax_inputs, weights_only=False)
    res["jax"] = run_case("jax", mesh, start=start, draws=draws)
    res["trajectory"] = run_case("traj", mesh, steps=TRAJ_STEPS)
    for kind in CASES3D:
        res[kind] = run_case(kind, mesh)
    res["flags"] = run_case("flags", mesh)
    return res
