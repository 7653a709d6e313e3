"""Stage-1 ISD pretraining entry point of the port (counterpart of
arco_tpu/cli/pretrain_2d.py; reference: pretrain_2D.py).

    python -m arco_torch.cli.pretrain_2d --root_path ../data/ACDC \
        --exp ACDC/pretrain --labeled_num 7 --max_iterations 30000

Stage 2 then starts from its newest checkpoint:

    python -m arco_torch.cli.train_arco_2d --root_path ../data/ACDC \
        --exp ACDC/arco --labeled_num 7 --resume ACDC/pretrain

It runs on the card unless given ``--device cpu``. ``--model`` takes the
keys whose forward is (logits, latent, feature maps), as JAX's stage 1:
unet, unet_stego, enet, pnet, efficient_unet, ViT_Seg, swin_unet and
nnUNet (sizes divisible by 32)
(models/factory.py:check_model); ``--train_encoder`` / ``--train_decoder``
only the U-Net's. The slices are staged on
the device (data/device_bank.py) and drawn as the JAX CLI draws them. Every
``ckpt_every`` steps it writes the whole pretrain state to
``iter_<N>``, and a rerun resumes from the newest one.
"""

from __future__ import annotations

import logging
import os
import sys
import time

import numpy as np
import torch

from arco_torch import resolve_device
from arco_torch.augment.photometric import batch_photometric
from arco_torch.config import TrainConfig, parse_args, patients_to_slices
from arco_torch.data.datasets import SliceDataset
from arco_torch.data.samplers import TwoStreamBatchSampler
from arco_torch.models import net_factory
from arco_torch.models.factory import check_model
from arco_torch.train import checkpoint as ckpt
from arco_torch.train import freeze
from arco_torch.train.pretrain import (init_pretrain_state, make_isd_modules,
                                       make_pretrain_step)
from arco_torch.utils.logging import MetricLogger, log_provenance


def pretrain_batches(cfg: TrainConfig, dataset, device):
    """Endless (images [B, C, H, W] f32, labels [B, H, W] int32) on
    ``device``, drawn as arco_tpu/cli/pretrain_2d.py draws them: a
    TwoStreamBatchSampler over the labeled and unlabeled slices of one
    dataset, epoch after epoch, and one RandomState(seed) for the
    transforms, gathered from the device slice bank (else on the host)."""
    bs = cfg.data.batch_size
    labeled_slice = patients_to_slices(cfg.exp, cfg.data.labeled_num)
    sampler = TwoStreamBatchSampler(
        list(range(labeled_slice)),
        list(range(labeled_slice, len(dataset))), bs,
        bs - cfg.data.labeled_bs, seed=cfg.seed)
    host_rng = np.random.RandomState(cfg.seed)
    bank = None
    if cfg.data.device_data:
        from arco_torch.data.device_bank import DeviceSliceBank
        try:
            bank = DeviceSliceBank.from_dataset(dataset, device)
        except ValueError as e:
            logging.info("device data path unavailable (%s); using the "
                         "host pipeline", e)
        else:
            logging.info("device data path: %d slices staged on %s",
                         len(dataset), device)
    while True:
        for idxs in sampler:
            if bank is not None:
                yield bank.gather(bank.draw_params(host_rng, idxs))
                continue
            samples = [dataset.get(i, host_rng) for i in idxs]
            images = np.stack([s["image"] for s in samples])
            labels = np.stack([s["label"] for s in samples])
            yield (torch.from_numpy(images).permute(0, 3, 1, 2).to(device),
                   torch.from_numpy(labels).to(device))


def make_views(images, combinations: int, generator):
    """The weak/strong view pair (pretrain_2D.py:210-225): 0 = identity,
    1 = strong student, 2 = strong teacher, 3 = both; 'strong' is the
    photometric jitter and blur, drawn from ``generator``."""
    stu = tea = images
    if combinations in (1, 3):
        stu = batch_photometric(images, generator=generator)
    if combinations in (2, 3):
        tea = batch_photometric(images, generator=generator)
    return stu, tea


def train(cfg: TrainConfig, snapshot_path: str, dataset=None):
    """``dataset``: the training slices (default: the SliceDataset of
    ``cfg.data.root_path``, as in JAX)."""
    check_model(cfg.model, "pretrain_2d")
    device = resolve_device(cfg.device)
    os.makedirs(snapshot_path, exist_ok=True)
    logging.basicConfig(
        force=True,
        filename=os.path.join(snapshot_path, "log.txt"), level=logging.INFO,
        format="[%(asctime)s.%(msecs)03d] %(message)s", datefmt="%H:%M:%S")
    logging.getLogger().addHandler(logging.StreamHandler(sys.stdout))
    log_provenance()
    logging.info(str(cfg))
    if cfg.pretrained_path:
        raise NotImplementedError(
            "--pretrained_path needs compat/pretrained.py, which is not "
            "ported")
    # f32 convs and matmuls outside autocast stay f32: no TF32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    num_classes = cfg.data.num_classes
    h, w = cfg.data.patch_size
    bs = cfg.data.batch_size
    dtype = torch.bfloat16 if cfg.compute_dtype == "bfloat16" \
        else torch.float32

    torch.manual_seed(cfg.seed)       # the module weights
    model = net_factory(cfg.model, in_chns=cfg.data.in_channels,
                        class_num=num_classes, img_size=(h, w))
    modules = make_isd_modules(
        model, num_classes=num_classes,
        latent_feature_size=cfg.isd.latent_feature_size,
        latent_pooling_size=cfg.isd.latent_pooling_size,
        output_pooling_size=cfg.isd.output_pooling_size)
    # --train_encoder/--train_decoder freeze a half (train/freeze.py)
    state = init_pretrain_state(modules, cfg.isd,
                                (bs, cfg.data.in_channels, h, w), cfg.optim,
                                seed=cfg.seed, device=device,
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
        dataset = SliceDataset(cfg.data.root_path, "train",
                               output_size=cfg.data.patch_size)
    view_gen = torch.Generator(device=device)
    view_gen.manual_seed(cfg.seed + 1)
    batches = (dict(zip(("student_image", "teacher_image"),
                        make_views(images, cfg.isd.combinations, view_gen)),
                    label=labels)
               for images, labels in pretrain_batches(cfg, dataset, device))
    run_pretrain_loop(cfg, snapshot_path, state, step_fn, batches)
    return "Training Finished!"


def run_pretrain_loop(cfg: TrainConfig, snapshot_path: str, state, step_fn,
                      batches, unit: str = "img"):
    """Train ``state`` from its step to ``cfg.optim.max_iterations`` on the
    ``batches`` (dicts of student_image, teacher_image, label): log every
    ``log_every`` ("images_per_sec" or, for ``unit`` "vol",
    "volumes_per_sec"), save the whole state every ``ckpt_every`` and at
    the end."""
    rate = "images_per_sec" if unit == "img" else "volumes_per_sec"
    bs = cfg.data.batch_size
    logger = MetricLogger(snapshot_path)
    t0 = time.time()
    try:
        while state.step < cfg.optim.max_iterations:
            metrics = step_fn(state, next(batches))
            it = state.step
            if it % cfg.log_every == 0:
                # all the terms in one copy to the host
                m = dict(zip(metrics, torch.stack(
                    list(metrics.values())).tolist()))
                per_s = cfg.log_every * bs / (time.time() - t0)
                t0 = time.time()
                logger.log(it, {**m, rate: per_s})
                logging.info(
                    "iteration %d : loss : %f, loss_ce: %f, loss_dice: %f, "
                    "loss_latent: %f, loss_output: %f (%.1f %s/s)", it,
                    m["loss"], m["loss_ce"], m["loss_dice"],
                    m["loss_latent"], m["loss_output"], per_s, unit)
            if it % cfg.ckpt_every == 0:
                ckpt.save_state(snapshot_path, it, state)
        ckpt.save_state(snapshot_path, state.step, state)
    finally:
        logger.close()


def parse(argv=None):
    """(TrainConfig, snapshot path) of the command line ``argv``."""
    base = TrainConfig()
    # the reference pretrain optimizer is plain SGD momentum=0.9 WITHOUT
    # nesterov (pretrain_2D.py:196-197), unlike the ARCO stage
    # (train_arco_2d.py:248); --optim.nesterov still overrides
    base.optim.nesterov = False
    cfg = parse_args(argv, base=base)
    # the snapshot suffix encodes the freeze config (pretrain_2D.py:313-320)
    suffix = freeze.snapshot_suffix(cfg.isd.train_encoder,
                                    cfg.isd.train_decoder)
    return cfg, os.path.join(
        cfg.snapshot_dir,
        f"{cfg.exp}_{cfg.data.labeled_num}_labeled{suffix}", cfg.model)


def main(argv=None):
    return train(*parse(argv))


if __name__ == "__main__":
    main()
