"""ARCO stage-2 3D training entry point of the port (counterpart of
arco_tpu/cli/train_arco_3d.py; reference: train_arco_3d.py).

    python -m arco_torch.cli.train_arco_3d --root_path ../data/LA \
        --exp LA/arco --labeled_num 8 --max_iterations 6000

The LA path at ``default_3d_config``: V-Net, patch [112, 112, 80], 2
classes, fused feature dim 16, no photometric or AdvMorph augmentation, the
eqv term computed but left out of the loss (train_arco_3d.py:390-391), a
``randn`` memory-bank init row. With ``--arco.eqv_on_log_only`` (on by
default here) the eqv leg runs only on logging iterations: a second step
function without it serves the others, and both update the same state. It
runs on the card unless given ``--device cpu``; the training volumes are
staged on the device (data/device_bank.py:DeviceVolumeBank) unless they do
not share one square-plane shape. A rerun resumes from the newest
full_iter_<N> of its snapshot directory; ``--resume <exp>`` starts from
that experiment's newest V-Net iter_<N> weights.
"""

from __future__ import annotations

import dataclasses
import logging
import os

import torch

from arco_torch.cli.train_arco_2d import (host_batches, load_stage1,
                                          resume_own, run_loop, start_run)
from arco_torch.config import TrainConfig, parse_args
from arco_torch.data.datasets import LAHeartDataset
from arco_torch.models import net_factory_3d
from arco_torch.train.arco2d import (init_arco_state, make_arco_modules,
                                     make_arco_step)

FEATURE_CHANNELS, FUSED_DIM = (128, 64, 32, 16, 16), 16


def default_3d_config() -> TrainConfig:
    """The JAX CLI's 3D defaults (train_arco_3d.py:148-216)."""
    cfg = TrainConfig()
    cfg.data.patch_size = (112, 112, 80)
    cfg.data.num_classes = 2
    cfg.data.labeled_num = 8   # index into train.list (LAHeartWithIndex)
    cfg.optim.max_iterations = 6000
    cfg.model = "vnet"
    cfg.arco.use_eqv_loss = False
    cfg.arco.compute_eqv = True
    # the eqv term is out of the 3D loss, so its leg runs on logging
    # iterations only (--arco.eqv_on_log_only false: every step)
    cfg.arco.eqv_on_log_only = True
    cfg.arco.use_photometric = False
    cfg.arco.use_adv_morph = False
    cfg.arco.remat = False
    # the 3D reference seeds each class bank with a randn row
    # (train_arco_3d.py:149)
    cfg.arco.memobank_init = "randn"
    return cfg


def _batches(cfg: TrainConfig, ds_l, ds_u, device):
    """(batch iterator, host pipeline to close or None)."""
    if cfg.data.device_data:
        from arco_torch.data.device_bank import (DeviceVolumeBank,
                                                 two_stream_device_batches)
        patch = tuple(cfg.data.patch_size)
        try:
            banks = (DeviceVolumeBank.from_dataset(ds_l, patch, device),
                     DeviceVolumeBank.from_dataset(ds_u, patch, device))
        except ValueError as e:
            logging.info("device data path unavailable (%s); using the "
                         "host pipeline", e)
        else:
            logging.info("device data path: %d + %d volumes staged on %s",
                         len(ds_l), len(ds_u), device)
            b_l = cfg.data.labeled_bs
            return two_stream_device_batches(
                banks[0], banks[1], b_l, cfg.data.batch_size - b_l,
                cfg.seed), None
    return host_batches(cfg, ds_l, ds_u, device)


def train(cfg: TrainConfig, snapshot_path: str, dataset=None):
    """``dataset``: the (labeled, unlabeled) training volumes (default: the
    LAHeartDataset pair of ``cfg.data.root_path``, as in JAX); each exposes
    ``__len__``, ``load(i)`` and ``get(i, rng)``."""
    device = start_run(cfg, snapshot_path)
    num_classes = cfg.data.num_classes
    patch = tuple(cfg.data.patch_size)
    bs, b_l = cfg.data.batch_size, cfg.data.labeled_bs
    dtype = torch.bfloat16 if cfg.compute_dtype == "bfloat16" \
        else torch.float32

    torch.manual_seed(cfg.seed)       # the module weights
    model = net_factory_3d(cfg.model, in_chns=cfg.data.in_channels,
                           class_num=num_classes)
    # the 3D stage 1 is not ported: --resume loads a V-Net iter_<N>
    load_stage1(cfg, model)
    modules = make_arco_modules(
        model, patch[1], patch[0], batch_size=b_l, total_batch=bs,
        feature_channels=FEATURE_CHANNELS, fused_dim=FUSED_DIM,
        tps_sigma=cfg.arco.tps_sigma)
    state = init_arco_state(modules, cfg.arco,
                            (b_l, cfg.data.in_channels) + patch, cfg.optim,
                            seed=cfg.seed, device=device,
                            compute_dtype=dtype)
    resume_own(cfg, snapshot_path, state)

    make = lambda arco: make_arco_step(modules, arco, num_classes,
                                       cfg.optim.max_iterations, cfg.optim,
                                       device=device)
    step_fn = make(cfg.arco)
    # eqv_on_log_only: the eqv term is logging-only on this path, so the
    # other iterations run a step without the eqv leg (its TPS warp and
    # sixth forward); loss_eqv is a real value exactly where it is logged
    step_noeqv = None
    if (cfg.arco.eqv_on_log_only and cfg.arco.compute_eqv
            and not cfg.arco.use_eqv_loss):
        step_noeqv = make(dataclasses.replace(cfg.arco, compute_eqv=False))

    def step_for(it):
        if step_noeqv is None or it % cfg.log_every == 0:
            return step_fn
        return step_noeqv

    if dataset is None:
        dataset = tuple(LAHeartDataset(cfg.data.root_path, "train",
                                       index=cfg.data.labeled_num,
                                       label_type=t, patch_size=patch)
                        for t in (1, 0))
    batches, pipeline = _batches(cfg, *dataset, device)
    try:
        run_loop(cfg, snapshot_path, state, batches, step_for, unit="vol")
    finally:
        if pipeline is not None:
            pipeline.close()
    return "Training Finished!"


def parse(argv=None):
    """(config, snapshot path) of a command line."""
    cfg = parse_args(argv, base=default_3d_config())
    snapshot_path = os.path.join(
        cfg.snapshot_dir, f"{cfg.exp}_{cfg.data.labeled_num}_labeledfinal",
        cfg.model)
    return cfg, snapshot_path


def main(argv=None):
    return train(*parse(argv))


if __name__ == "__main__":
    main()
