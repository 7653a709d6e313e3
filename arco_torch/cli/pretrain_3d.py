"""Stage-1 ISD pretraining entry point of the port, 3D LA volumes
(counterpart of arco_tpu/cli/pretrain_3d.py; reference: pretrain_3D.py).

    python -m arco_torch.cli.pretrain_3d --root_path ../data/LA \
        --exp LA/pretrain --labeled_num 8 --max_iterations 6000

Stage 2 then starts from its newest checkpoint:

    python -m arco_torch.cli.train_arco_3d --root_path ../data/LA \
        --exp LA/arco --labeled_num 8 --resume LA/pretrain

The pretrain step is the 2D one (train/pretrain.py is rank-generic) on the
V-Net (or ``--model unet_3D`` / ``attention_unet`` / ``voxresnet`` /
``nnUNet``, the latter at ``--patch_size 128 128 80``: models/factory.py:
check_model_3d) at [112, 112, 80] patches: a contrastive patch grid of
20^3 windows at step 10 (700 patches, model_3D.py:355-373), each pooled
to 8^3, so the descriptors hold num_classes * 8^3 features. It runs on
the card unless given ``--device cpu``. The training volumes are staged
on the device (data/device_bank.py:DeviceVolumeBank) unless they do not
share one square-plane shape; the log says which data path feeds the run.
Every ``ckpt_every`` steps it writes the whole pretrain state to
``iter_<N>``, and a rerun resumes from the newest one.
"""

from __future__ import annotations

import logging
import os

import numpy as np
import torch

from arco_torch.cli.pretrain_2d import run_pretrain_loop
from arco_torch.cli.train_arco_2d import start_run
from arco_torch.config import TrainConfig, parse_args
from arco_torch.data.datasets import LAHeartDataset
from arco_torch.data.samplers import TwoStreamBatchSampler
from arco_torch.models import net_factory_3d
from arco_torch.models.factory import check_model_3d
from arco_torch.train import checkpoint as ckpt
from arco_torch.train import freeze
from arco_torch.train.pretrain import (init_pretrain_state, make_isd_modules,
                                       make_pretrain_step)


def default_3d_config() -> TrainConfig:
    """The JAX CLI's 3D pretrain defaults (pretrain_3d.py:35-46)."""
    cfg = TrainConfig()
    cfg.data.patch_size = (112, 112, 80)
    cfg.data.num_classes = 2
    cfg.data.labeled_num = 8
    cfg.optim.max_iterations = 6000
    cfg.model = "vnet"
    cfg.isd.patch_size = 20          # pretrain_3D.py:165
    # plain SGD momentum=0.9 without nesterov (pretrain_3D.py:166-167),
    # unlike the ARCO stage
    cfg.optim.nesterov = False
    return cfg


def pretrain_batches(cfg: TrainConfig, dataset, device):
    """Endless (images [B, 1, X, Y, Z] f32, labels [B, X, Y, Z] int32) on
    ``device``, drawn as arco_tpu/cli/pretrain_3d.py draws them: a
    TwoStreamBatchSampler over volumes 0..labeled_num-1 and the rest, epoch
    after epoch, and one RandomState(seed) for the rot90, flip and crop,
    gathered from the device volume bank (else on the host)."""
    bs = cfg.data.batch_size
    patch = tuple(cfg.data.patch_size)
    n_l = cfg.data.labeled_num
    sampler = TwoStreamBatchSampler(list(range(n_l)),
                                    list(range(n_l, len(dataset))), bs,
                                    bs - cfg.data.labeled_bs, seed=cfg.seed)
    host_rng = np.random.RandomState(cfg.seed)
    bank = None
    if cfg.data.device_data:
        from arco_torch.data.device_bank import DeviceVolumeBank
        try:
            bank = DeviceVolumeBank.from_dataset(dataset, patch, device)
        except ValueError as e:
            logging.warning("device data path unavailable (%s): the host "
                            "pipeline feeds %s", e, device)
        else:
            logging.info("device data path: %d volumes staged on %s",
                         len(dataset), device)
    else:
        logging.info("host data path (--data.device_data false) feeds %s",
                     device)
    while True:
        for idxs in sampler:
            if bank is not None:
                yield bank.gather(bank.draw_params(host_rng, idxs))
                continue
            samples = [dataset.get(i, host_rng) for i in idxs]
            images = np.stack([s["image"] for s in samples])
            labels = np.stack([s["label"] for s in samples])
            yield (torch.from_numpy(images).movedim(-1, 1).to(device),
                   torch.from_numpy(labels).to(device))


def train(cfg: TrainConfig, snapshot_path: str, dataset=None):
    """``dataset``: the training volumes (default: the LAHeartDataset of
    ``cfg.data.root_path``'s train.list, as in JAX); it exposes
    ``__len__``, ``load(i)`` and ``get(i, rng)`` (``data.datasets.
    InMemoryVolumes`` on a machine without h5py)."""
    check_model_3d(cfg.model, "pretrain_3d")
    device = start_run(cfg, snapshot_path)
    num_classes = cfg.data.num_classes
    patch = tuple(cfg.data.patch_size)
    bs = cfg.data.batch_size
    dtype = torch.bfloat16 if cfg.compute_dtype == "bfloat16" \
        else torch.float32

    torch.manual_seed(cfg.seed)       # the module weights
    model = net_factory_3d(cfg.model, in_chns=cfg.data.in_channels,
                           class_num=num_classes)
    # the latent head's hidden width is 256 whatever the latent's own
    # (arco_tpu/cli/pretrain_3d.py:72)
    modules = make_isd_modules(
        model, num_classes=num_classes,
        latent_feature_size=cfg.isd.latent_feature_size,
        latent_pooling_size=cfg.isd.latent_pooling_size,
        output_pooling_size=cfg.isd.output_pooling_size,
        latent_channels=256)
    # --train_encoder/--train_decoder freeze a half (train/freeze.py)
    state = init_pretrain_state(modules, cfg.isd,
                                (bs, cfg.data.in_channels) + patch,
                                cfg.optim, seed=cfg.seed, device=device,
                                compute_dtype=dtype)
    # crash resume: iter_<N> holds the whole pretrain state
    own = ckpt.latest_step(snapshot_path)
    if own:
        logging.info("resuming pretrain state from iter_%d", own)
        ckpt.restore_state(snapshot_path, own, state)
    step_fn = make_pretrain_step(cfg.isd, cfg.data.labeled_bs, num_classes,
                                 cfg.optim.max_iterations, cfg.optim,
                                 device=device)

    if dataset is None:
        dataset = LAHeartDataset(cfg.data.root_path, "train",
                                 patch_size=patch)
    # one view: the teacher sees the student's batch (pretrain_3d.py:131)
    batches = ({"student_image": images, "teacher_image": images,
                "label": labels}
               for images, labels in pretrain_batches(cfg, dataset, device))
    run_pretrain_loop(cfg, snapshot_path, state, step_fn, batches,
                      unit="vol")
    return "Training Finished!"


def parse(argv=None):
    """(TrainConfig, snapshot path) of the command line ``argv``."""
    cfg = parse_args(argv, base=default_3d_config())
    # the snapshot suffix encodes the freeze config (pretrain_3D.py:294-301)
    suffix = freeze.snapshot_suffix(cfg.isd.train_encoder,
                                    cfg.isd.train_decoder)
    return cfg, os.path.join(
        cfg.snapshot_dir, f"{cfg.exp}_{cfg.data.labeled_num}_labeled{suffix}",
        cfg.model)


def main(argv=None):
    return train(*parse(argv))


if __name__ == "__main__":
    main()
