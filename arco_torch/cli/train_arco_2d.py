"""ARCO stage-2 2D training entry point of the port (counterpart of
arco_tpu/cli/train_arco_2d.py).

CLI-compatible with the reference (train_arco_2d.py:26-89): the reference
flags work directly, e.g.

    python -m arco_torch.cli.train_arco_2d --root_path ../data/ACDC \
        --exp ACDC/arco --labeled_num 7 --max_iterations 30000

plus dotted overrides for every config field (--arco.num_queries 256). It
runs on the card unless given ``--device cpu``. ``--model`` takes the keys
whose feature maps the ARCO FeatureExtractor fuses, as in JAX: ``unet``
and ``unet_stego`` (models/factory.py:check_model). The training slices are
staged on the device (data/device_bank.py) unless they do not fit its
square-slice rule; the step's losses stay on the device and are read only
every ``log_every`` and ``ckpt_every`` steps. A rerun resumes from the
newest full_iter_<N> of its snapshot directory (else from the newest
iter_<N> weights).
"""

from __future__ import annotations

import logging
import os
import sys
import time

import numpy as np
import torch

from arco_torch import resolve_device
from arco_torch.config import TrainConfig, parse_args, patients_to_slices
from arco_torch.data.datasets import SliceDataset, SynapseDataset
from arco_torch.data.pipeline import Prefetcher, TwoStreamPipeline
from arco_torch.models import net_factory
from arco_torch.models.factory import check_model
from arco_torch.train import checkpoint as ckpt
from arco_torch.train.arco2d import (init_arco_state, make_arco_modules,
                                     make_arco_step)
from arco_torch.utils.logging import MetricLogger, log_provenance


def build_datasets(cfg: TrainConfig):
    exp = cfg.exp
    labeled_slice = patients_to_slices(exp, cfg.data.labeled_num)
    common = dict(output_size=cfg.data.patch_size)
    if "Syn" in exp or "syn" in exp or "Lits" in exp or "LiTS" in exp \
            or "jhu" in exp or "JHU" in exp:
        lits = "Lits" in exp or "LiTS" in exp
        list_dir = cfg.data.list_dir or cfg.data.root_path
        ds_l = SynapseDataset(cfg.data.root_path, list_dir, "train",
                              index=labeled_slice, label_type=1, lits=lits,
                              **common)
        ds_u = SynapseDataset(cfg.data.root_path, list_dir, "train",
                              index=labeled_slice, label_type=0, lits=lits,
                              **common)
    else:
        ds_l = SliceDataset(cfg.data.root_path, "train", index=labeled_slice,
                            label_type=1, **common)
        ds_u = SliceDataset(cfg.data.root_path, "train", index=labeled_slice,
                            label_type=0, **common)
    return ds_l, ds_u


def _nchw_host_batches(pipeline):
    """The host pipeline's batches with channels-first images (NCHW or
    NCDHW), for the Prefetcher."""
    for b in pipeline:
        yield {"image_l": np.moveaxis(b["image_l"], -1, 1),
               "label_l": b["label_l"],
               "image_u": np.moveaxis(b["image_u"], -1, 1)}


def _batches(cfg: TrainConfig, ds_l, ds_u, device):
    """(batch iterator, host pipeline to close or None)."""
    bs, b_l = cfg.data.batch_size, cfg.data.labeled_bs
    if cfg.data.device_data:
        from arco_torch.data.device_bank import (DeviceSliceBank,
                                                 two_stream_device_batches)
        try:
            banks = (DeviceSliceBank.from_dataset(ds_l, device),
                     DeviceSliceBank.from_dataset(ds_u, device))
        except ValueError as e:
            logging.info("device data path unavailable (%s); using the "
                         "host pipeline", e)
        else:
            logging.info("device data path: %d + %d slices staged on %s",
                         len(ds_l), len(ds_u), device)
            return two_stream_device_batches(
                banks[0], banks[1], b_l, bs - b_l, cfg.seed), None
    return host_batches(cfg, ds_l, ds_u, device)


def host_batches(cfg: TrainConfig, ds_l, ds_u, device):
    """(batches of the host pipeline on ``device``, the pipeline)."""
    pipeline = TwoStreamPipeline(ds_l, ds_u, cfg.data.batch_size,
                                 seed=cfg.seed, labeled_bs=cfg.data.labeled_bs)
    return iter(Prefetcher(_nchw_host_batches(pipeline), device)), pipeline


def start_run(cfg: TrainConfig, snapshot_path: str) -> torch.device:
    """The run's device, its log.txt, and TF32 off."""
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
    logging.info("device %s; cudnn.allow_tf32=%s, matmul.allow_tf32=%s",
                 device, torch.backends.cudnn.allow_tf32,
                 torch.backends.cuda.matmul.allow_tf32)
    return device


def load_stage1(cfg: TrainConfig, model):
    """Stage-1 handoff (train_arco_2d.py:223-226): student and teacher
    start from the resumed experiment's newest iter_<N> weights."""
    if not cfg.resume:
        return
    resume_dir = os.path.join(
        cfg.snapshot_dir, f"{cfg.resume}_{cfg.data.labeled_num}_labeledfinal",
        cfg.model)
    step = ckpt.latest_step(resume_dir)
    if step is not None:
        logging.info("loading stage-1 checkpoint iter_%d from %s", step,
                     resume_dir)
        model.load_state_dict(ckpt.load_model_params(resume_dir, step))


def resume_own(cfg: TrainConfig, snapshot_path: str, state):
    """Crash recovery: the full state (weights, EMA, optimizer, step,
    generator) from this experiment's newest full_iter_<N>; else a degraded
    resume from its newest iter_<N> weights."""
    own_step = ckpt.latest_full_step(snapshot_path)
    if own_step:
        logging.info("resuming full train state from full_iter_%d", own_step)
        ckpt.restore_full_state(snapshot_path, own_step, state)
    elif ckpt.latest_step(snapshot_path):
        mstep = ckpt.latest_step(snapshot_path)
        logging.info("degraded resume from model checkpoint iter_%d", mstep)
        ckpt.restore_model_fallback(snapshot_path, mstep, state, cfg.optim)


def run_loop(cfg: TrainConfig, snapshot_path: str, state, batches,
             step_for, unit: str = "img"):
    """Train from ``state.step`` to ``cfg.optim.max_iterations``, with
    ``step_for(it)`` the step function of iteration ``it``: log every
    ``log_every`` ("images_per_sec" or, for ``unit`` "vol",
    "volumes_per_sec"), checkpoint every ``ckpt_every``, and save the final
    state."""
    rate = "images_per_sec" if unit == "img" else "volumes_per_sec"
    bs, b_l = cfg.data.batch_size, cfg.data.labeled_bs
    logger = MetricLogger(snapshot_path)
    t0 = time.time()
    start_it = state.step
    # record.pkl parity incl. resume (train_arco_2d.py:437,477-478): the
    # history written so far, trimmed to the resume step
    loss_history = logger.load_history_pickle(snapshot_path)[:start_it]
    pending = []  # the losses since the last flush, still on the device
    if start_it >= cfg.optim.max_iterations:
        batches = iter(())
    try:
        for it, batch in enumerate(batches, start=start_it + 1):
            metrics = step_for(it)(state, batch)
            pred_l_label = metrics.pop("pred_l_label")
            pending.append(metrics["loss"])
            if it % cfg.log_every == 0:
                # all the terms in one copy to the host
                metrics = dict(zip(metrics, torch.stack(
                    [v.float() for v in metrics.values()]).tolist()))
                per_s = cfg.log_every * bs / (time.time() - t0)
                t0 = time.time()
                logger.log(it, {**metrics, rate: per_s})
                logging.info(
                    "iteration %d : loss : %f, loss_ce: %f, loss_dice: %f, "
                    "reco_loss: %f, unsup_loss: %f, loss_eqv: %f "
                    "(%.2f %s/s)", it, metrics["loss"], metrics["loss_ce"],
                    metrics["loss_dice"], metrics["reco_loss"],
                    metrics["unsup_loss"], metrics["loss_eqv"], per_s, unit)
            if logger.tb is not None and it % (cfg.log_every * 10) == 0 \
                    and pred_l_label.ndim == 3:
                # TB image grids of 2D runs, sample index 1 as in the
                # reference (train_arco_2d.py:441-459)
                idx = min(1, b_l - 1)
                logger.log_images(it, {
                    "train/Image": batch["image_l"][idx, 0].cpu().numpy(),
                    "train/Prediction": pred_l_label[idx].cpu().numpy(),
                    "train/GroundTruth":
                        batch["label_l"][idx].cpu().numpy().astype("int32")})
            if it % cfg.ckpt_every == 0:
                # the history first, so that record.pkl keeps the interval
                # if a save below fails
                loss_history.extend(_flush(pending))
                logger.log_history_pickle(snapshot_path, loss_history)
                ckpt.save_model_state(snapshot_path, it, state)
                if it % (cfg.full_ckpt_every or cfg.ckpt_every) == 0:
                    ckpt.save_full_state(snapshot_path, it, state)
                logging.info("saved checkpoint iter_%d", it)
            if it >= cfg.optim.max_iterations:
                break
        final_it = state.step
        if final_it % cfg.ckpt_every:
            ckpt.save_model_state(snapshot_path, final_it, state)
        ckpt.save_full_state(snapshot_path, final_it, state)
        loss_history.extend(_flush(pending))
        logger.log_history_pickle(snapshot_path, loss_history)
    finally:
        logger.close()


def train(cfg: TrainConfig, snapshot_path: str):
    # the ARCO FeatureExtractor fuses the U-Net's five maps: the keys JAX's
    # stage 2 runs (unet, unet_stego)
    check_model(cfg.model, "train_arco_2d")
    device = start_run(cfg, snapshot_path)
    num_classes = cfg.data.num_classes
    h, w = cfg.data.patch_size
    # reference batch semantics: batch_size is the TOTAL per-step batch,
    # labeled_bs of it labeled (train_arco_2d.py:35-36)
    bs = cfg.data.batch_size
    b_l = cfg.data.labeled_bs
    dtype = torch.bfloat16 if cfg.compute_dtype == "bfloat16" \
        else torch.float32

    torch.manual_seed(cfg.seed)       # the module weights
    model = net_factory(cfg.model, in_chns=cfg.data.in_channels,
                        class_num=num_classes)
    load_stage1(cfg, model)
    modules = make_arco_modules(model, w, h, batch_size=b_l, total_batch=bs,
                                tps_sigma=cfg.arco.tps_sigma)
    state = init_arco_state(modules, cfg.arco,
                            (b_l, cfg.data.in_channels, h, w), cfg.optim,
                            seed=cfg.seed, device=device,
                            compute_dtype=dtype)
    resume_own(cfg, snapshot_path, state)
    step_fn = make_arco_step(modules, cfg.arco, num_classes,
                             cfg.optim.max_iterations, cfg.optim,
                             output_size=cfg.data.patch_size, device=device)

    ds_l, ds_u = build_datasets(cfg)
    batches, pipeline = _batches(cfg, ds_l, ds_u, device)
    try:
        run_loop(cfg, snapshot_path, state, batches, lambda it: step_fn)
    finally:
        if pipeline is not None:
            pipeline.close()
    return "Training Finished!"


def _flush(pending: list) -> list:
    """The pending device losses as floats (one copy to the host)."""
    out = torch.stack(pending).tolist() if pending else []
    pending.clear()
    return out


def main(argv=None):
    cfg = parse_args(argv)
    # reference ablation flag (train_arco_2d.py:76):
    # 0 all terms, 1 no reco (contrastive), 2 no unsup
    if cfg.isd.combinations == 1:
        cfg.arco.compute_contrastive = False
    elif cfg.isd.combinations == 2:
        cfg.arco.compute_unsup = False
    snapshot_path = os.path.join(
        cfg.snapshot_dir, f"{cfg.exp}_{cfg.data.labeled_num}_labeledfinal",
        cfg.model)
    return train(cfg, snapshot_path)


if __name__ == "__main__":
    main()
