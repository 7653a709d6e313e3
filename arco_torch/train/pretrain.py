"""Stage-1 ISD pretraining step, 2D and 3D (counterpart of
arco_tpu/train/pretrain.py).

Momentum-teacher self-distillation with two MoCo-style queues: a latent
queue [K, latent_feature_size] and a patch-descriptor queue [K, P, F]
(pretrain_2D.py:146-300, model_2D.py:115-311; pretrain_3D.py, model_3D.py
ISD_3d). One step, in the JAX order:
  teacher EMA (model, latent head, outputs head) from the pre-update student
  -> student forward, teacher forward (train mode: both update their own
     BatchNorm statistics and draw their own dropout masks)
  -> patch descriptors [B, P, F] from the pooled cells of the half-overlap
     patch grid of the logits (2D: 49 patches of 64x64 pooled to 8x8; 3D at
     112x112x80: 700 patches of 20^3 pooled to 8^3, F = 2 * 8^3), each
     flattened in (h, w, c) / (x, y, z, c) order, so a JAX queue_mask
     carries across unchanged
  -> cosine logits of student and teacher against the queues
  -> CE + Dice on the labeled sub-batch + k1 * KLD(latent) + k2 * KLD(output)
     (k1 * KLD(latent) alone when only the encoder trains)
  -> SGD + poly LR -> enqueue the raw teacher latents and descriptors.

PyTorch idiom as in train/arco2d.py: the state holds nn.Modules and is
updated in place, the models and heads run under autocast in the compute
dtype, and the logits against the f32 queues and the KLs run outside it in
f32 (in JAX the bf16 head outputs meet the f32 queue, so that product is
f32 there too). ShuffleBN and the reference's unused pre-update teacher
forward are dropped, as in JAX. Stage 1 reaches no TPU kernel.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Any, NamedTuple

import torch

from arco_torch import resolve_device
from arco_torch.config import OptimConfig
from arco_torch.losses.supervised import (cross_entropy, dice_loss,
                                          kld_batchmean)
from arco_torch.models.heads import (LatentMLP, LatentPredictor,
                                     OutputsPredictor, ProjectionHead)
from arco_torch.models.init import jax_init_
from arco_torch.ops.patches import patch_grid_positions, pooled_patch_grid
from arco_torch.ops.ring_buffer import enqueue_fixed
from arco_torch.train import freeze
from arco_torch.train.arco2d import _autocast, _nhwc
from arco_torch.train.schedule import make_optimizer, poly_lr, set_lr
from arco_torch.utils.tree import ema_update


class ISDModules(NamedTuple):
    """The student's modules; the teacher copies them at init."""
    model: Any
    latent_head: Any
    latent_predictor: Any
    outputs_head: Any
    outputs_predictor: Any


def make_isd_modules(model, num_classes: int, latent_feature_size: int = 512,
                     latent_pooling_size: int = 1,
                     output_pooling_size: int = 8,
                     latent_channels: int = 256) -> ISDModules:
    """The heads of ``model`` (2D, or 3D when its ``spatial_dims`` is 3).
    ``latent_channels`` is the latent head's hidden width (JAX's
    ``input_channels``); its input width is the channel count of the
    model's latent: the model's ``latent_channels`` attribute (the V-Net's
    128, UNet3D's 256), else ``latent_channels`` (the 2D U-Net's 256).
    The heads draw JAX's init (``jax_init_``) from torch's global
    generator; ``model`` is taken as built."""
    nd = getattr(model, "spatial_dims", 2)
    latent_width = getattr(model, "latent_channels", latent_channels)
    return ISDModules(
        model=model,
        latent_head=jax_init_(LatentMLP(
            input_channels=latent_channels, num_class=latent_feature_size,
            pooling_size=latent_pooling_size, latent_channels=latent_width,
            nd=nd)),
        latent_predictor=jax_init_(
            LatentPredictor(feature_size=latent_feature_size)),
        outputs_head=jax_init_(ProjectionHead(
            num_classes, proj_dim=num_classes,
            output_pooling_size=output_pooling_size, nd=nd)),
        outputs_predictor=jax_init_(
            OutputsPredictor(num_classes=num_classes, nd=nd)))


# the (teacher, student) pairs of the EMA: not the predictors
EMA_PAIRS = (("ema_model", "model"), ("ema_latent_head", "latent_head"),
             ("ema_outputs_head", "outputs_head"))


@dataclass
class PretrainState:
    model: torch.nn.Module               # student
    latent_head: torch.nn.Module
    latent_predictor: torch.nn.Module
    outputs_head: torch.nn.Module
    outputs_predictor: torch.nn.Module
    ema_model: torch.nn.Module           # teacher: EMA params, own BN stats
    ema_latent_head: torch.nn.Module
    ema_outputs_head: torch.nn.Module
    queue: torch.Tensor                  # [K, latent_feature_size] f32
    queue_ptr: int
    queue_mask: torch.Tensor             # [K, P, F] f32
    mask_queue_ptr: int
    optimizer: torch.optim.Optimizer
    generator: torch.Generator
    step: int
    compute_dtype: torch.dtype


def _num_patches(spatial, patch: int, step: int) -> int:
    n = 1
    for s in spatial:
        n *= len(patch_grid_positions(s, patch, step))
    return n


def _randn_cols_normalized(shape, gen, device):
    """randn normalized along axis 0, not per row (model_2D.py:163-172)."""
    x = torch.randn(shape, generator=gen, device=device)
    return x / (torch.linalg.vector_norm(x, dim=0, keepdim=True) + 1e-12)


def init_pretrain_state(modules: ISDModules, cfg, input_shape,
                        optim: OptimConfig = None, seed: int = 0,
                        device="cuda",
                        compute_dtype=torch.bfloat16) -> PretrainState:
    """Move the modules to ``device``, copy the teacher, draw both queues
    and build the optimizer over what trains (``cfg``: config.ISDConfig,
    whose train_encoder/train_decoder freeze a half of the U-Net or V-Net).
    input_shape: [B, C, *spatial]. The module weights are the ones the modules were
    built with; ``seed`` drives the queues and every later draw."""
    device = resolve_device(device)
    optim = optim or OptimConfig()
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    student = {name: getattr(modules, name).to(device).train()
               for name in ISDModules._fields}
    teacher = {}
    for t, s in EMA_PAIRS:
        teacher[t] = copy.deepcopy(student[s])
        for p in teacher[t].parameters():
            p.requires_grad_(False)

    pool = cfg.output_pooling_size
    spatial = tuple(input_shape[2:])
    p = _num_patches(spatial, cfg.patch_size, cfg.patch_size // 2)
    f = student["outputs_head"][-1].out_channels * pool ** len(spatial)
    queue = _randn_cols_normalized((cfg.K, cfg.latent_feature_size), gen,
                                   device)
    queue_mask = _randn_cols_normalized((cfg.K, p, f), gen, device)

    params = freeze.apply_freeze(student["model"], cfg.train_encoder,
                                 cfg.train_decoder)
    for name in ISDModules._fields[1:]:
        params += list(student[name].parameters())
    optimizer = make_optimizer(params, optim.base_lr, optim.weight_decay,
                               optim.momentum, optim.nesterov)
    return PretrainState(**student, **teacher, queue=queue, queue_ptr=0,
                         queue_mask=queue_mask, mask_queue_ptr=0,
                         optimizer=optimizer, generator=gen, step=0,
                         compute_dtype=compute_dtype)


def _patch_descriptors(head, logits, patch: int, step: int, pool: int,
                       predictor=None):
    """[B, C, *spatial] logits -> per-patch descriptors [B, P, F], each
    pooled cell flattened in (h, w, c) / (x, y, z, c) order."""
    pooled = pooled_patch_grid(_nhwc(logits), patch, step, pool)
    b, p = pooled.shape[:2]
    out = head(pooled.reshape((b * p,) + pooled.shape[2:]), pre_pooled=True)
    if predictor is not None:
        out = predictor(out)
    return out.reshape(b, p, -1)


def _normalized_logits(queries, keys, temp: float):
    """Cosine logits / temp in f32 whatever autocast is on (in JAX the bf16
    head outputs meet the f32 queue); the norms get + 1e-12, not a clamp
    (pretrain.py:185-188)."""
    with torch.autocast(queries.device.type, enabled=False):
        q, k = queries.float(), keys.float()
        q = q / (torch.linalg.vector_norm(q, dim=-1, keepdim=True) + 1e-12)
        k = k / (torch.linalg.vector_norm(k, dim=-1, keepdim=True) + 1e-12)
        return (q @ k.t()) / temp


def pretrain_loss_fn(state: PretrainState, cfg, batch, labeled_bs: int,
                     num_classes: int, dmask=None):
    """The differentiable part of the step: (loss, metrics, k_lat,
    tea_desc), the last two the raw teacher keys to enqueue."""
    dmask = dmask or {}
    dev = state.queue.device
    gen = state.generator
    patch, pool = cfg.patch_size, cfg.output_pooling_size
    step = patch // 2
    with _autocast(dev, state.compute_dtype):
        outputs, latent, _ = state.model(batch["student_image"],
                                         dmask.get("student"), gen)
        stu_desc = _patch_descriptors(state.outputs_head, outputs, patch,
                                      step, pool, state.outputs_predictor)
        q_lat = state.latent_predictor(state.latent_head(latent))
        with torch.no_grad():
            ema_outputs, ema_latent, _ = state.ema_model(
                batch["teacher_image"], dmask.get("teacher"), gen)
            tea_desc = _patch_descriptors(state.ema_outputs_head,
                                          ema_outputs, patch, step, pool)
            k_lat = state.ema_latent_head(ema_latent)

    queue_keys = state.queue_mask.reshape(-1, state.queue_mask.shape[-1])
    bp = stu_desc.shape[0] * stu_desc.shape[1]
    loss_latent = kld_batchmean(
        _normalized_logits(q_lat, state.queue, cfg.Ts),
        _normalized_logits(k_lat, state.queue, cfg.Tt))
    loss_output = kld_batchmean(
        _normalized_logits(stu_desc.reshape(bp, -1), queue_keys, cfg.Ts),
        _normalized_logits(tea_desc.reshape(bp, -1), queue_keys, cfg.Tt))

    # supervised on the labeled sub-batch (pretrain_2D.py:238-242)
    pred_l = _nhwc(outputs[:labeled_bs])
    label_l = batch["label"][:labeled_bs]
    loss_ce = cross_entropy(pred_l, label_l)
    loss_dice = dice_loss(torch.softmax(pred_l.float(), dim=-1), label_l,
                          num_classes)
    # encoder-only pretraining drops the supervised and output-head terms
    # (pretrain_2D.py:249: `loss = args.k1 * loss_latent`)
    if cfg.train_encoder and not cfg.train_decoder:
        loss = cfg.k1 * loss_latent
    else:
        loss = loss_ce + loss_dice + cfg.k1 * loss_latent \
            + cfg.k2 * loss_output
    metrics = {"loss": loss, "loss_ce": loss_ce, "loss_dice": loss_dice,
               "loss_latent": loss_latent, "loss_output": loss_output}
    return loss, {k: v.detach() for k, v in metrics.items()}, k_lat, tea_desc


def make_pretrain_step(cfg, labeled_bs: int, num_classes: int,
                       max_iterations: int, optim: OptimConfig = None,
                       device="cuda"):
    """Returns step(state, batch, draws=None) -> metrics, which updates
    ``state`` in place.

    batch: student_image, teacher_image [B, C, *spatial]; label [B,
    *spatial] int.
    draws (optional): {"dropout": {"student": masks, "teacher": masks}},
    each the model's list of keep-masks: one per encoder block of the 2D
    U-Net (models/unet2d.py), [x5, x9] of the V-Net, those of
    ``draw_dropout_masks`` for UNet3D; missing ones come from
    ``state.generator``."""
    device = resolve_device(device)
    optim = optim or OptimConfig()

    def step_fn(state: PretrainState, batch, draws=None):
        batch = {k: v.to(device) for k, v in batch.items()}
        # momentum update of the teacher BEFORE its forward, from the
        # pre-update student (model_2D.py:241-243)
        for t, s in EMA_PAIRS:
            ema_update(getattr(state, t), getattr(state, s), cfg.m)
        loss, metrics, k_lat, tea_desc = pretrain_loss_fn(
            state, cfg, batch, labeled_bs, num_classes,
            (draws or {}).get("dropout"))
        opt = state.optimizer
        opt.zero_grad(set_to_none=True)
        loss.backward()
        # a trainable parameter the loss does not reach (the outputs head
        # when only the encoder trains) still decays, as optax's
        # add_decayed_weights decays it; torch's SGD skips a None grad
        for group in opt.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
        set_lr(opt, poly_lr(optim.base_lr, state.step, max_iterations,
                            optim.poly_power))
        opt.step()
        # the raw teacher keys: the logits normalize at compute time
        # (model_2D.py:306-307)
        state.queue_ptr = enqueue_fixed(state.queue, state.queue_ptr, k_lat)
        state.mask_queue_ptr = enqueue_fixed(state.queue_mask,
                                             state.mask_queue_ptr, tea_desc)
        state.step += 1
        return metrics

    return step_fn
