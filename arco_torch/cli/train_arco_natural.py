"""ARCO training on natural images (Cityscapes / Pascal VOC) in the port
(counterpart of arco_tpu/cli/train_arco_natural.py, flag for flag, plus
``--device``).

The same stage-2 ARCO step as the medical path (train/arco2d.py, with the
three CUDA kernels) over the natural-image pipeline, with a 3-channel U-Net
or the reference's DeepLab models:

    python -m arco_torch.cli.train_arco_natural --root_path ../data/pascal \
        --dataset pascal --label_num 5 \
        --model deeplabv2 --backbone resnet101 \
        [--restore_from /path/to/resnet101-caffe.pth]

It runs on the card unless given ``--device cpu``, in bf16 autocast as JAX
computes in bf16. ``--model`` takes unet, deeplabv2 and deeplabv3; the
U-Net needs a crop divisible by 16 (``--crop_size 320`` on Pascal;
models/factory.py:check_natural_model). ``--restore_from`` takes a LOCAL
torch checkpoint (the reference downloads its caffe-pretrained trunks,
model_factory.py:13-16) and copies what matches by name and shape
(compat/torch_import.py). ``--resume_snapshot`` seeds the student and the
teacher from another run's newest iter_<N>; the two cannot be combined.
DeepLab-v2's BatchNorm scales and biases are frozen as in the reference
(train/freeze.py:apply_deeplab_bn_freeze). The host TwoStreamPipeline feeds
both streams ``--batch_size`` images a step. Checkpoints: iter_<N> and
full_iter_<N> every ``--ckpt_every`` and at the end, as JAX writes them;
a rerun does not resume (JAX's does not).
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
import time

import torch

from arco_torch import resolve_device
from arco_torch.config import ArcoConfig, OptimConfig
from arco_torch.data.natural import NaturalImageDataset, class_balanced_idx
from arco_torch.data.pipeline import (Prefetcher, TwoStreamPipeline,
                                      nchw_batches)
from arco_torch.models.deeplab import deeplab_feature_channels
from arco_torch.models.factory import (NATURAL_BACKBONES, NATURAL_TRAIN,
                                       check_natural_model, natural_model)
from arco_torch.train import checkpoint as ckpt
from arco_torch.train.arco2d import (init_arco_state, make_arco_modules,
                                     make_arco_step)
from arco_torch.train.freeze import apply_deeplab_bn_freeze
from arco_torch.train.schedule import make_optimizer
from arco_torch.utils.logging import MetricLogger, log_provenance


def build_parser():
    p = argparse.ArgumentParser()
    p.add_argument("--root_path", type=str, required=True)
    p.add_argument("--dataset", type=str, default="pascal",
                   choices=["pascal", "cityscapes"])
    p.add_argument("--label_num", type=int, default=5)
    p.add_argument("--model", type=str, default="unet",
                   choices=list(NATURAL_TRAIN))
    p.add_argument("--backbone", type=str, default="resnet101",
                   choices=list(NATURAL_BACKBONES))
    p.add_argument("--resume_snapshot", type=str, default=None,
                   help="snapshot dir whose latest iter_<N> model "
                        "checkpoint seeds the model (warmup handoff)")
    p.add_argument("--restore_from", type=str, default=None,
                   help="local torch checkpoint for the DeepLab trunk "
                        "(partial copy, model_factory.py:55-60 semantics)")
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--max_iterations", type=int, default=40000)
    p.add_argument("--base_lr", type=float, default=0.01)
    p.add_argument("--seed", type=int, default=1337)
    p.add_argument("--snapshot_dir", type=str, default="../model")
    p.add_argument("--exp", type=str, default="natural/arco")
    p.add_argument("--apply_aug", type=str, default="cutmix")
    p.add_argument("--crop_size", type=int, default=None,
                   help="override the dataset's default crop")
    p.add_argument("--num_classes", type=int, default=None,
                   help="override the dataset's class count")
    p.add_argument("--ckpt_every", type=int, default=1000)
    p.add_argument("--log_every", type=int, default=20)
    p.add_argument("--set", action="append", default=[], metavar="K=V",
                   help="ArcoConfig field override, e.g. --set "
                        "memobank_size=64")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu")
    return p


def arco_config(apply_aug: str, overrides) -> ArcoConfig:
    """ArcoConfig with ``--set K=V`` overrides, each parsed as its field's
    type (booleans from 1/true/yes)."""
    fields = {}
    for kv in overrides:
        k, v = kv.split("=", 1)
        cur = getattr(ArcoConfig(), k)
        fields[k] = (v.lower() in ("1", "true", "yes")
                     if isinstance(cur, bool) else type(cur)(v))
    return ArcoConfig(apply_aug=apply_aug, **fields)


def _start_logging(snapshot_path: str):
    os.makedirs(snapshot_path, exist_ok=True)
    logging.basicConfig(
        force=True, filename=os.path.join(snapshot_path, "log.txt"),
        level=logging.INFO, format="[%(asctime)s.%(msecs)03d] %(message)s",
        datefmt="%H:%M:%S")
    logging.getLogger().addHandler(logging.StreamHandler(sys.stdout))
    log_provenance()


def main(argv=None, wrap_step=None):
    """Train; returns the run's snapshot directory. ``wrap_step``, where
    given, takes the step function and returns the one the loop calls (a
    caller's timing or checks around each step)."""
    args = build_parser().parse_args(argv)
    defaults = NaturalImageDataset.DEFAULTS[args.dataset]
    num_classes = args.num_classes or defaults["num_classes"]
    crop = ((args.crop_size, args.crop_size) if args.crop_size
            else defaults["crop_size"])
    check_natural_model(args.model, crop, "train_arco_natural")
    if args.resume_snapshot and args.restore_from:
        raise SystemExit(
            "--resume_snapshot and --restore_from both set: the torch "
            "trunk restore would silently overwrite the warmup handoff; "
            "pass exactly one initializer")
    device = resolve_device(args.device)

    snapshot_path = os.path.join(args.snapshot_dir,
                                 f"{args.exp}_{args.label_num}_labeled",
                                 args.model)
    _start_logging(snapshot_path)
    # f32 convs and matmuls outside autocast stay f32: no TF32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    base = NaturalImageDataset(args.root_path, args.dataset, "train",
                               crop_size=crop)
    labeled_idx, unlabeled_idx = class_balanced_idx(
        lambda i: base.load(i)[1], range(len(base)), num_classes,
        args.label_num, seed=args.seed)
    ds_l, ds_u = base.subset(labeled_idx), base.subset(unlabeled_idx)
    logging.info("%s: %d labeled + %d unlabeled images, crop %s, %d "
                 "classes, device %s", args.dataset, len(ds_l), len(ds_u),
                 crop, num_classes, device)

    cfg = arco_config(args.apply_aug, args.set)
    optim = OptimConfig(base_lr=args.base_lr,
                        max_iterations=args.max_iterations)
    torch.manual_seed(args.seed)      # the module weights
    model = natural_model(args.model, args.backbone, num_classes)
    if args.model == "unet":
        fea_channels, fused_dim = (256, 128, 64, 32, 16), None
    else:
        # the four ResNet stage maps fused to a 256-channel representation
        # (DeepLabv3Plus's own representation width, deeplabv3.py:46-51)
        fea_channels = deeplab_feature_channels(args.model, args.backbone)
        fused_dim = 256
    if args.resume_snapshot:
        # the warmup handoff: student AND teacher start from another
        # run's newest iter_<N> model (init_arco_state copies the teacher)
        step = ckpt.latest_step(args.resume_snapshot)
        if step is None:
            raise SystemExit(f"--resume_snapshot: no iter_<N> checkpoint "
                             f"under {args.resume_snapshot}")
        model.load_state_dict(ckpt.load_model_params(args.resume_snapshot,
                                                     step))
        logging.info("initialized model from %s iter_%d",
                     args.resume_snapshot, step)
    if args.restore_from:
        from arco_torch.compat.torch_import import load_torch_checkpoint
        copied = load_torch_checkpoint(model, args.restore_from)
        logging.info("restored DeepLab trunk from %s (%d tensors)",
                     args.restore_from, len(copied))

    modules = make_arco_modules(model, crop[1], crop[0],
                                batch_size=args.batch_size,
                                feature_channels=fea_channels,
                                fused_dim=fused_dim)
    state = init_arco_state(modules, cfg, (args.batch_size, 3) + crop, optim,
                            seed=args.seed, device=device,
                            compute_dtype=torch.bfloat16)
    if args.model == "deeplabv2":
        # the reference freezes every trunk BatchNorm (deeplab.py:90-103)
        params = apply_deeplab_bn_freeze(state.model) \
            + list(state.feature_extractor.parameters()) \
            + list(state.q_representation.parameters())
        state.optimizer = make_optimizer(params, optim.base_lr,
                                         optim.weight_decay, optim.momentum,
                                         optim.nesterov)
    step_fn = make_arco_step(modules, cfg, num_classes, args.max_iterations,
                             optim, device=device)
    if wrap_step is not None:
        step_fn = wrap_step(step_fn)

    pipeline = TwoStreamPipeline(ds_l, ds_u, args.batch_size, seed=args.seed)
    logger = MetricLogger(snapshot_path)
    t0 = time.time()
    try:
        batches = Prefetcher(nchw_batches(pipeline), device)
        for it, batch in enumerate(batches, start=1):
            metrics = step_fn(state, batch)
            metrics.pop("pred_l_label")
            if it % args.log_every == 0:
                # all the terms in one copy to the host
                m = dict(zip(metrics, torch.stack(
                    [v.float() for v in metrics.values()]).tolist()))
                ips = args.log_every * args.batch_size * 2 \
                    / (time.time() - t0)
                t0 = time.time()
                logger.log(it, {**m, "images_per_sec": ips})
                logging.info("iter %d loss %.4f (%.1f img/s)", it, m["loss"],
                             ips)
            if it % args.ckpt_every == 0:
                ckpt.save_model_state(snapshot_path, it, state)
                ckpt.save_full_state(snapshot_path, it, state)
            if it >= args.max_iterations:
                break
    finally:
        pipeline.close()
        logger.close()
    final_it = state.step
    if final_it % args.ckpt_every:
        ckpt.save_model_state(snapshot_path, final_it, state)
    ckpt.save_full_state(snapshot_path, final_it, state)
    return snapshot_path


if __name__ == "__main__":
    main()
