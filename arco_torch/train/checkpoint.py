"""Checkpoints of the port's stage-1 and stage-2 states (counterpart of
arco_tpu/train/checkpoint.py), with ``torch.save`` of state dicts.

The directory layout is the JAX package's. Stage 1 writes its whole state
to ``iter_<N>`` (``save_state``), so a rerun resumes it exactly; its
``model`` entry is the student U-Net, which stage 2 starts from
(``load_model_params``). In stage 2 ``iter_<N>`` holds the reference-style
weight checkpoint (student with its heads, BatchNorm statistics, the EMA
teacher, the teacher feature extractor) and ``full_iter_<N>`` the rolling
resume state, which adds the optimizer, the step and the generator's
state. The memory bank and the random pool (the
pool alone is GB-scale) are left out of the resume state by default
(``RESUME_EXCLUDE``): both refill from live teacher keys within ~200 steps.
Pass ``exclude=()`` for a complete-state save. Each directory holds one
``state.pt``; the port reads its own checkpoints only (a JAX state comes
across through compat/from_flax.py).
"""

from __future__ import annotations

import os
import shutil
from typing import Optional

import torch

from arco_torch.train.schedule import make_optimizer

_FILE = "state.pt"
_MODULES = ("model", "ema_model", "feature_extractor", "k_feature_extractor",
            "q_representation")

RESUME_EXCLUDE = ("memobank", "random_pool", "random_pool_ptr")


def _path(snapshot_dir: str, step: int) -> str:
    return os.path.join(os.path.abspath(snapshot_dir), f"iter_{step}")


def _full_path(snapshot_dir: str, step: int) -> str:
    return os.path.join(os.path.abspath(snapshot_dir), f"full_iter_{step}")


def _save(directory: str, tree: dict):
    os.makedirs(directory, exist_ok=True)
    tmp = os.path.join(directory, _FILE + ".tmp")
    torch.save(tree, tmp)
    os.replace(tmp, os.path.join(directory, _FILE))


def _load(directory: str) -> dict:
    return torch.load(os.path.join(directory, _FILE), map_location="cpu",
                      weights_only=True)


def _modules_tree(state) -> dict:
    return {name: getattr(state, name).state_dict() for name in _MODULES}


def _load_modules(state, tree: dict):
    for name in _MODULES:
        if name in tree:
            getattr(state, name).load_state_dict(tree[name])


def save_model_state(snapshot_dir: str, step: int, state):
    """The iter_<N> weight checkpoint: no optimizer, no banks."""
    _save(_path(snapshot_dir, step), {"step": step, **_modules_tree(state)})


def load_model_params(snapshot_dir: str, step: int) -> dict:
    """The student model's state dict of iter_<N> (eval, and the stage-1
    -> stage-2 handoff)."""
    return _load(_path(snapshot_dir, step))["model"]


def restore_model_fallback(snapshot_dir: str, step: int, state, optim):
    """Degraded resume from an iter_<N> weight checkpoint when no
    full_iter resume state exists: weights, EMA copies and BatchNorm
    statistics restored, the step set, and a fresh optimizer (``optim``:
    config.OptimConfig). The poly LR is read from the step, so it
    continues; momentum, banks and the generator start fresh."""
    _load_modules(state, _load(_path(snapshot_dir, step)))
    params = [p for name in ("model", "feature_extractor", "q_representation")
              for p in getattr(state, name).parameters()]
    state.optimizer = make_optimizer(params, optim.base_lr,
                                     optim.weight_decay, optim.momentum,
                                     optim.nesterov)
    state.step = step
    return state


# the modules of the pretrain's PretrainState (train/pretrain.py)
_PRETRAIN_MODULES = ("model", "latent_head", "latent_predictor",
                     "outputs_head", "outputs_predictor", "ema_model",
                     "ema_latent_head", "ema_outputs_head")


def save_state(snapshot_dir: str, step: int, state):
    """The pretrain's iter_<N>: the whole PretrainState (student and
    teacher modules with BatchNorm statistics, both queues and pointers,
    optimizer, generator, step)."""
    _save(_path(snapshot_dir, step), {
        "step": state.step,
        **{name: getattr(state, name).state_dict()
           for name in _PRETRAIN_MODULES},
        "queue": state.queue, "queue_ptr": state.queue_ptr,
        "queue_mask": state.queue_mask,
        "mask_queue_ptr": state.mask_queue_ptr,
        "optimizer": state.optimizer.state_dict(),
        "generator": state.generator.get_state()})


def restore_state(snapshot_dir: str, step: int, state):
    """Inverse of save_state, in place."""
    tree = _load(_path(snapshot_dir, step))
    for name in _PRETRAIN_MODULES:
        getattr(state, name).load_state_dict(tree[name])
    state.optimizer.load_state_dict(tree["optimizer"])
    state.generator.set_state(tree["generator"])
    with torch.no_grad():
        state.queue.copy_(tree["queue"])
        state.queue_mask.copy_(tree["queue_mask"])
    state.queue_ptr = int(tree["queue_ptr"])
    state.mask_queue_ptr = int(tree["mask_queue_ptr"])
    state.step = int(tree["step"])
    return state


def save_full_state(snapshot_dir: str, step: int, state, keep: int = 2,
                    exclude=RESUME_EXCLUDE):
    """Rolling resume checkpoint under full_iter_<N> (weights, EMA copies,
    optimizer, step, generator; the banks unless excluded); prunes all but
    the newest ``keep``."""
    tree = {"step": state.step, **_modules_tree(state),
            "optimizer": state.optimizer.state_dict(),
            "generator": state.generator.get_state()}
    if "memobank" not in exclude:
        bank = state.memobank
        tree["memobank"] = {"data": bank.data, "ptr": bank.ptr,
                            "count": bank.count}
    if "random_pool" not in exclude:
        tree["random_pool"] = state.random_pool
    if "random_pool_ptr" not in exclude:
        tree["random_pool_ptr"] = state.random_pool_ptr
    _save(_full_path(snapshot_dir, step), tree)
    for old in sorted(_scan_steps(snapshot_dir, "full_iter_"))[:-keep]:
        shutil.rmtree(_full_path(snapshot_dir, old), ignore_errors=True)


def restore_full_state(snapshot_dir: str, step: int, state,
                       exclude=RESUME_EXCLUDE):
    """Inverse of save_full_state, in place: the excluded fields keep the
    target's freshly initialized values."""
    tree = _load(_full_path(snapshot_dir, step))
    _load_modules(state, tree)
    state.optimizer.load_state_dict(tree["optimizer"])
    state.generator.set_state(tree["generator"])
    state.step = int(tree["step"])
    with torch.no_grad():
        if "memobank" not in exclude:
            bank = state.memobank
            bank.data.copy_(tree["memobank"]["data"])
            bank.ptr = tree["memobank"]["ptr"].to(bank.ptr.device)
            bank.count = tree["memobank"]["count"].to(bank.count.device)
        if "random_pool" not in exclude:
            state.random_pool.copy_(tree["random_pool"])
    if "random_pool_ptr" not in exclude:
        state.random_pool_ptr = int(tree["random_pool_ptr"])
    return state


def _scan_steps(snapshot_dir: str, prefix: str) -> list:
    if not os.path.isdir(snapshot_dir):
        return []
    steps = []
    for name in os.listdir(snapshot_dir):
        if name.startswith(prefix):
            try:
                steps.append(int(name[len(prefix):]))
            except ValueError:
                continue
    return steps


def latest_full_step(snapshot_dir: str) -> Optional[int]:
    steps = _scan_steps(snapshot_dir, "full_iter_")
    return max(steps) if steps else None


def latest_step(snapshot_dir: str) -> Optional[int]:
    steps = _scan_steps(snapshot_dir, "iter_")
    return max(steps) if steps else None


def resolve_steps(snapshot_dir: str, iteration: Optional[int],
                  start: Optional[int], end: Optional[int],
                  stride: int) -> list:
    """Checkpoint selection shared by the eval CLIs: either one iteration
    (default latest) or a reference-style sweep over saved iter_<N> dirs
    (test_2D.py:140-157)."""
    if iteration is not None and start is not None:
        raise SystemExit(
            "--iteration and --startEpoch are mutually exclusive: pass one "
            "checkpoint or a sweep range, not both")
    if start is not None:
        last = end if end is not None else (latest_step(snapshot_dir)
                                            or start)
        steps = [s for s in range(start, last + 1, stride)
                 if os.path.isdir(_path(snapshot_dir, s))]
        if not steps:
            raise SystemExit(
                f"no checkpoints in [{start}, {last}] under {snapshot_dir}")
        return steps
    step = iteration or latest_step(snapshot_dir)
    if step is None:
        raise SystemExit(f"no checkpoint found under {snapshot_dir}")
    return [step]
