"""Stage-2 ARCO training step, 2D and 3D (counterpart of
arco_tpu/train/arco2d.py).

One step, in the JAX order:
  feature-extractor EMA -> teacher pseudo-labels -> cutout/cutmix/classmix
  -> photometric + AdvMorph strong aug -> teacher forwards + fusion
  -> student forwards (l, u) + heads -> losses
      k1*reco + k3*unsup + sup(CE+Dice) + k2*eqv + k4*loss_q
  -> SGD + poly LR -> teacher EMA -> random-pool enqueue.

PyTorch idiom: the state holds nn.Modules and is updated in place. BatchNorm
running statistics thread through the forwards as they run (teacher:
pseudo -> labeled -> strong-unlabeled; student: l -> u -> tps), the memory
bank is enqueued before the InfoNCE reads it, and the revisiting loss reads
the random pool before the in-place enqueue at the end of the step. The
models and heads run under autocast in the compute dtype (bf16 on the main
path); losses, percentiles and the optimizer run in f32. The InfoNCE term
goes through the fused kernel pair and the revisiting loss through the
pool_sims kernel (arco_torch/kernels). The strong augmentations run in f32
outside autocast. With ``remat`` the student forwards that carry a gradient
(labeled, unlabeled, TPS) keep no activations and recompute them in the
backward (torch.utils.checkpoint), which changes nothing in the result:
their dropout masks are drawn before the forward and handed to both runs,
and the recompute leaves the BatchNorm running statistics alone.

The step is rank-generic: images NCHW (2D U-Net) or NCDHW (3D V-Net,
[B, C, X, Y, Z] in the JAX package's axis order); class maps, fused reps
and the pool are channels-last [B, *spatial, C] in both.

With a ``mesh`` the step is data-parallel: each rank is handed its shard
of the batch and computes what one process computes over the whole batch,
as JAX's step does under a batch sharding:
- every random draw that the caller does not inject is taken from
  ``state.generator`` at the global batch's shape, up front and
  identically on every rank (``_global_draws``, which every step calls,
  with or without a mesh), and each rank keeps its rows
  (``_local_draws``), so the generators stay equal;
- CutMix / ClassMix pair sample i with i + 1 of the global unlabeled
  batch: the last local sample takes the next rank's first one;
- the student's and teacher's BatchNorm statistics run over the global
  batch (``sync_batch_norm``); the heads have no norm;
- every loss term is a global mean, the entropy thresholds and the
  memory-bank sampling run over the global batch, and the bank and random
  pool take the global batch's keys in its order, so every rank holds the
  one process's bank and pool.
Every loss term reaches the all-reduced global sums through the
differentiable ``all_reduce_sum`` (the supervised step's convention): each
rank's loss is the global loss, its gradient ``world`` times its samples'
share, and ``average_gradients`` divides the world size out.
"""

from __future__ import annotations

import contextlib
import copy
from dataclasses import dataclass
from typing import Any, NamedTuple

import torch
import torch.utils.checkpoint

from arco_torch import resolve_device
from arco_torch.augment.mixing import draw_cutout_boxes, generate_unsup_data
from arco_torch.augment.morph import adv_morph_batch, draw_morph
from arco_torch.augment.photometric import batch_photometric, draw_photometric
from arco_torch.augment.tps import RandTPS, draw_tps
from arco_torch.config import OptimConfig
from arco_torch.losses.consistency import (compute_unsupervised_loss,
                                           equivariance_loss, revisiting_loss)
from arco_torch.losses.contrastive import (MemoBank,
                                           compute_contra_memobank_loss,
                                           create_memobank, descending_rank)
from arco_torch.losses.supervised import cross_entropy, dice_loss, one_hot
from arco_torch.models.heads import FeatureExtractor, QRepresentation
from arco_torch.models.init import jax_init_
from arco_torch.models.layers import running_stats_frozen, sync_batch_norm
from arco_torch.ops import normalize
from arco_torch.ops.collectives import BatchShard
from arco_torch.ops.interpolate import resize_nearest
from arco_torch.ops.ring_buffer import enqueue_fixed
from arco_torch.parallel.mesh import average_gradients, axis_rank
from arco_torch.train.schedule import make_optimizer, poly_lr, set_lr
from arco_torch.utils.tree import ema_update


class ArcoModules(NamedTuple):
    model: Any
    feature_extractor: Any
    q_representation: Any
    tps: RandTPS


@dataclass
class ArcoState:
    model: torch.nn.Module               # student
    ema_model: torch.nn.Module           # teacher: EMA params, own BN stats
    feature_extractor: torch.nn.Module
    k_feature_extractor: torch.nn.Module  # EMA of the student's
    q_representation: torch.nn.Module
    optimizer: torch.optim.Optimizer
    memobank: MemoBank
    random_pool: torch.Tensor            # [K, *spatial, C] L2-normalized
    random_pool_ptr: int
    generator: torch.Generator
    step: int
    compute_dtype: torch.dtype


def _f32(x, device):
    """A 0-d f32 tensor on ``device``; a Python number becomes a fill
    there, not a host-to-device copy (which would make the host wait)."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    return torch.full((), x, dtype=torch.float32, device=device)


def _at(values, index):
    """values[index] for a 0-d index tensor, without reading it on the
    host."""
    return values[index.reshape(1)].reshape(())


def masked_percentiles(values, mask, pcts):
    """np.percentile(values[mask], pct) for several pcts with one sort.
    ``pcts`` are floats or 0-d f32 tensors; the arithmetic is f32 as in
    JAX, so the thresholds are the same to the ulp."""
    flat = values.reshape(-1).float()
    m = mask.reshape(-1)
    sorted_vals = torch.sort(torch.where(m, flat, torch.inf)).values
    n = m.to(torch.int32).sum()
    size = sorted_vals.shape[0]
    nm1 = torch.clamp(n - 1, min=0).float()
    outs = []
    for pct in pcts:
        rank = _f32(pct, flat.device) / 100.0 * nm1
        lo = torch.floor(rank).to(torch.int64)
        hi = torch.ceil(rank).to(torch.int64)
        v_lo = _at(sorted_vals, lo.clamp(0, size - 1))
        v_hi = _at(sorted_vals, hi.clamp(0, size - 1))
        out = v_lo + (v_hi - v_lo) * (rank - lo.float())
        outs.append(torch.where(n > 0, out, 0.0))
    return outs


def masked_percentiles_histogram(values, mask, pcts, bins: int = 2048,
                                 lo: float = 0.0, hi: float = None):
    """O(n) approximate masked percentiles from a fixed-range histogram
    (``ArcoConfig.fast_percentile``)."""
    flat = values.reshape(-1).float()
    m = mask.reshape(-1).float()
    hi = _f32(hi, flat.device) if hi is not None \
        else (flat * m).max() + 1e-6
    hi = torch.maximum(hi, _f32(lo + 1e-6, flat.device))
    idx = torch.clamp(((flat - lo) / (hi - lo) * bins).to(torch.int32),
                      0, bins - 1)
    hist = torch.zeros((bins,), dtype=torch.float32, device=flat.device)
    hist.index_add_(0, idx.long(), m)
    cdf = torch.cumsum(hist, 0)
    n = cdf[-1]
    edges = lo + (torch.arange(bins, dtype=torch.float32, device=flat.device)
                  + 1.0) / bins * (hi - lo)
    outs = []
    for pct in pcts:
        target = _f32(pct, flat.device) / 100.0 * n
        b = torch.searchsorted(cdf, target.reshape(1)).reshape(())
        out = _at(edges, b.clamp(0, bins - 1))
        outs.append(torch.where(n > 0, out, 0.0))
    return outs


def make_arco_modules(model, width: int, height: int, batch_size: int,
                      feature_channels=(256, 128, 64, 32, 16),
                      fused_dim=None, tps_sigma: float = 0.01,
                      total_batch: int = None) -> ArcoModules:
    """2D: fea_dim [256,128,64,32,16] -> 496 (train_arco_2d.py:231-242);
    3D: fea_dim [128,64,32,16,16] -> fused_dim 16 (train_arco_3d.py:
    208-216), the heads' convs 3-D for a model with ``spatial_dims`` 3.
    ``total_batch`` (labeled + unlabeled, the TPS warp's batch) defaults to
    2 * batch_size. The heads draw JAX's init (``jax_init_``) from torch's
    global generator; ``model`` is taken as built."""
    fused = int(fused_dim) if fused_dim else int(sum(feature_channels))
    total = total_batch if total_batch is not None else batch_size * 2
    nd = getattr(model, "spatial_dims", 2)
    return ArcoModules(
        model=model,
        feature_extractor=jax_init_(
            FeatureExtractor(tuple(feature_channels), fused, nd)),
        q_representation=jax_init_(QRepresentation(fused, nd)),
        tps=RandTPS(width, height, batch_size=total, sigma=tps_sigma,
                    random_scale=(0.8, 1.2), mode="affine"))


def _num_classes_of(model):
    for attr in ("class_num", "n_classes", "num_classes"):
        if hasattr(model, attr):
            return int(getattr(model, attr))
    raise AttributeError("model has no class-count attribute")


def init_arco_state(modules: ArcoModules, cfg, input_shape,
                    optim: OptimConfig = None, seed: int = 0,
                    device="cuda", compute_dtype=torch.bfloat16,
                    pool_dtype=torch.bfloat16) -> ArcoState:
    """Move the modules to ``device`` and build the teacher copies, the
    optimizer, the memory bank and the random pool. input_shape: NCHW or
    NCDHW.
    The module weights are the ones the modules were built with (seed the
    global torch RNG before building them); ``seed`` drives the pool, the
    bank's init row and every later draw of the step."""
    device = resolve_device(device)
    optim = optim or OptimConfig()
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    model = modules.model.to(device).train()
    fe = modules.feature_extractor.to(device).train()
    qr = modules.q_representation.to(device).train()
    ema_model = copy.deepcopy(model).train()
    k_fe = copy.deepcopy(fe)
    for p in list(ema_model.parameters()) + list(k_fe.parameters()):
        p.requires_grad_(False)

    # the fused representation's shape, from one eval-mode forward of a
    # single zero image (running stats are read, not updated)
    with torch.no_grad():
        model.eval()
        x = torch.zeros((1,) + tuple(input_shape[1:]), device=device)
        _, _, fmap = model(x)
        model.train()
        row_shape = tuple(fe(fmap).shape[1:])

    pool = torch.empty((cfg.K,) + row_shape, dtype=pool_dtype, device=device)
    for k in range(cfg.K):   # row by row: the f32 pool would be 4.7 GB
        row = torch.randn((1,) + row_shape, generator=gen, device=device)
        pool[k] = normalize.l2_normalize(
            row, normalize.feature_axes(row))[0].to(pool_dtype)

    memobank = create_memobank(
        num_classes=_num_classes_of(model), feat=row_shape[-1],
        capacity=cfg.memobank_size, capacity_bg=cfg.memobank_size_bg,
        dtype=compute_dtype, init=getattr(cfg, "memobank_init", "zeros"),
        generator=gen, device=device)
    params = list(model.parameters()) + list(fe.parameters()) \
        + list(qr.parameters())
    optimizer = make_optimizer(params, optim.base_lr, optim.weight_decay,
                               optim.momentum, optim.nesterov)
    return ArcoState(model=model, ema_model=ema_model, feature_extractor=fe,
                     k_feature_extractor=k_fe, q_representation=qr,
                     optimizer=optimizer, memobank=memobank,
                     random_pool=pool, random_pool_ptr=0, generator=gen,
                     step=0, compute_dtype=compute_dtype)


def _nhwc(x):
    """[B, C, *spatial] -> channels-last [B, *spatial, C] (a view)."""
    return x.movedim(1, -1)


def _autocast(device, dtype):
    if dtype == torch.float32:
        return contextlib.nullcontext()
    return torch.autocast(device.type, dtype=dtype)


def _sync(module, group):
    """``sync_batch_norm`` over ``group``, or nothing without one."""
    if group is None:
        return contextlib.nullcontext()
    return sync_batch_norm(module, group)


@contextlib.contextmanager
def _recompute(model, group):
    with running_stats_frozen(model), _sync(model, group):
        yield


def _student_forward(model, x, masks, gen, remat: bool, group=None):
    """model(x, masks, gen), its BatchNorm statistics over ``group``'s
    batch; with ``remat`` and a gradient to take, as a checkpointed region
    whose recompute draws the same dropout masks (drawn here, before it),
    takes the same statistics and leaves the running ones alone."""
    if not (remat and torch.is_grad_enabled()):
        with _sync(model, group):
            return model(x, masks, gen)
    if masks is None:
        masks = model.draw_dropout_masks(x.shape, gen, x.device)
    return torch.utils.checkpoint.checkpoint(
        model, x, masks, use_reentrant=False,
        context_fn=lambda: (_sync(model, group), _recompute(model, group)))


def _fuse(fe, l_fmap, u_fmap):
    """One head application over the labeled ++ unlabeled maps (the heads
    are convs only, so this is exact)."""
    return fe([torch.cat([a, b], dim=0) for a, b in zip(l_fmap, u_fmap)])


def arco_loss_fn(state: ArcoState, modules: ArcoModules, cfg, batch, aug,
                 draws, num_classes, max_iterations, shard=None):
    """The differentiable part of the step; returns (loss, metrics).
    ``aug`` carries the augmented tensors and teacher outputs. ``shard``
    (an ``ops.collectives.BatchShard``): the batch is this rank's shard,
    and the loss and metrics are the global batch's."""
    dev = state.random_pool.device
    group = None if shard is None else shard.group
    gen = state.generator
    dmask = draws.get("dropout", {})
    image_l, label_l = batch["image_l"], batch["label_l"]
    u_aug_data, u_aug_label = aug["u_aug_data"], aug["u_aug_label"]
    u_aug_logits = aug["u_aug_logits"]
    model = state.model
    cast = lambda: _autocast(dev, state.compute_dtype)

    remat = cfg.remat
    with cast():
        pred_l, _, l_fmap = _student_forward(model, image_l, dmask.get("l"),
                                             gen, remat, group)
        if getattr(cfg, "dead_forward", False):
            with torch.no_grad(), _sync(model, group):
                model(aug["images_cj2_l"], dmask.get("dead"), gen)
        pred_u, _, u_fmap = _student_forward(model, u_aug_data,
                                             dmask.get("u"), gen, remat,
                                             group)
        rep_all = state.q_representation(
            _fuse(state.feature_extractor, l_fmap, u_fmap))
    b_l = pred_l.shape[0]
    rep_u = rep_all[b_l:]
    pred_l, pred_u = _nhwc(pred_l), _nhwc(pred_u)
    pred_all = torch.cat([pred_l, pred_u], dim=0)
    zero = torch.zeros((), device=dev)

    loss_q = revisiting_loss(state.random_pool, rep_u, aug["rep_u_teacher"],
                             topk=cfg.topk, group=group) \
        if cfg.compute_revisit else zero

    probs_l = torch.softmax(pred_l.float(), dim=-1)
    loss_ce = cross_entropy(pred_l, label_l, group=group)
    loss_dice = dice_loss(probs_l, label_l, num_classes, group=group)
    supervised = loss_ce + loss_dice

    unsup = compute_unsupervised_loss(
        pred_u, u_aug_label, u_aug_logits, cfg.strong_threshold,
        conf_mask=getattr(cfg, "unsup_conf_mask", False), group=group) \
        if cfg.compute_unsup else zero

    reco = zero
    if cfg.compute_contrastive:
        valid_u = u_aug_label >= 0
        if cfg.use_entropy_split:
            prob_u_stu = torch.softmax(pred_u.detach().float(), dim=-1)
            entropy = -(prob_u_stu * torch.log(prob_u_stu + 1e-10)).sum(-1)
            alpha_t = 20.0 * (1.0 - _f32(state.step, dev) / max_iterations)
            pct_fn = (masked_percentiles_histogram if cfg.fast_percentile
                      else masked_percentiles)
            # the thresholds of the global unlabeled batch
            all_entropy, all_valid = (entropy, valid_u) if shard is None \
                else (shard.gather(entropy), shard.gather(valid_u))
            low_t, high_t = pct_fn(all_entropy, all_valid,
                                   [alpha_t, 100.0 - alpha_t])
            low_entropy_mask = (entropy <= low_t) & valid_u
            high_entropy_mask = (entropy >= high_t) & valid_u
        else:
            low_entropy_mask = high_entropy_mask = valid_u

        ones_l = torch.ones(label_l.shape, dtype=torch.bool, device=dev)
        low_mask_all = torch.cat([ones_l, low_entropy_mask], dim=0)
        high_mask_all = torch.cat([ones_l, high_entropy_mask], dim=0)

        spatial = tuple(rep_all.shape[1:-1])

        def to_rep_size(x):
            if tuple(x.shape[1:-1]) != spatial:
                return resize_nearest(x, spatial, channels_last=True)
            return x

        onehot_l = to_rep_size(one_hot(label_l, num_classes))
        onehot_u = to_rep_size(one_hot(u_aug_label, num_classes))
        label_all = torch.cat([onehot_l, onehot_u], dim=0)
        label_l_padded = torch.cat([onehot_l, torch.zeros_like(onehot_u)],
                                   dim=0)
        prob_teacher_all = to_rep_size(torch.cat(
            [aug["prob_l_teacher"], aug["prob_u_teacher"]], dim=0))
        rank_all = descending_rank(prob_teacher_all)
        is_labeled = torch.cat([
            torch.ones((b_l,), dtype=torch.bool, device=dev),
            torch.zeros((u_aug_data.shape[0],), dtype=torch.bool,
                        device=dev)])
        _, reco = compute_contra_memobank_loss(
            rep_all, label_all, prob_teacher_all, rank_all, is_labeled,
            label_l_padded,
            to_rep_size(low_mask_all[..., None].float())[..., 0],
            to_rep_size(high_mask_all[..., None].float())[..., 0],
            aug["rep_teacher_all"], state.memobank,
            delta_n=cfg.strong_threshold_u2pl, func=cfg.func,
            num_queries=cfg.num_queries, num_negatives=cfg.num_negatives,
            temp=cfg.temp, low_rank=cfg.low_rank, high_rank=cfg.high_rank,
            current_class_threshold=cfg.current_class_threshold,
            enqueue_per_class=cfg.memobank_enqueue,
            draws=draws.get("contra"), generator=gen, shard=shard)

    loss_eqv = zero
    if cfg.compute_eqv:
        labels_cat = torch.cat([label_l, u_aug_label], dim=0)
        logits_cat = torch.cat([torch.ones(label_l.shape, device=dev),
                                u_aug_logits.float()], dim=0)
        mask = torch.ones(labels_cat.shape, device=dev)
        mask = torch.where(labels_cat == 0, 0.0, mask)
        mask = torch.where(logits_cat < cfg.weak_threshold, 0.0, mask)
        images_cj2 = torch.cat([aug["images_cj2_l"], aug["images_cj2_u"]],
                               dim=0)
        grid = modules.tps.reset(draws.get("tps"), generator=gen, device=dev)
        # one warp for images, mask and detached predictions (same grid,
        # zeros padding); nothing here carries a gradient
        c_img = images_cj2.shape[1]
        stacked = torch.cat([images_cj2.float(), mask[:, None],
                             pred_all.detach().float().movedim(-1, 1)],
                            dim=1)
        warped = modules.tps.apply(stacked, grid, padding_mode="zeros")
        images_tps = warped[:, :c_img]
        mask_tps = _nhwc(warped[:, c_img:c_img + 1])
        pred_tps_org = _nhwc(warped[:, c_img + 1:])
        grad_ctx = contextlib.nullcontext() if cfg.use_eqv_loss \
            else torch.no_grad()
        with grad_ctx, cast():
            pred_tps, _, _ = _student_forward(model, images_tps,
                                              dmask.get("tps"), gen, remat,
                                              group)
        loss_eqv = equivariance_loss(_nhwc(pred_tps), pred_tps_org, mask_tps,
                                     group=group)

    loss = (cfg.k1 * reco + cfg.k3 * unsup + supervised
            + (cfg.k2 * loss_eqv if cfg.use_eqv_loss else 0.0)
            + cfg.k4 * loss_q)
    metrics = {"loss": loss, "reco_loss": reco, "loss_q": loss_q,
               "unsup_loss": unsup, "loss_ce": loss_ce,
               "loss_dice": loss_dice, "loss_eqv": loss_eqv}
    metrics = {k: v.detach() for k, v in metrics.items()}
    pred_label = pred_l.detach().argmax(-1).to(torch.int32)
    metrics["pred_l_label"] = pred_label if shard is None \
        else shard.gather(pred_label)
    return loss, metrics


def _global_draws(state: ArcoState, modules: ArcoModules, cfg, draws,
                  l_shape, u_in_shape, u_shape, num_classes):
    """``draws`` with every draw it lacks taken from ``state.generator`` at
    the global batch's shapes: the step's one list of its draws, which it
    hands to the callees (they draw lazily only for their other callers),
    in the order in which those would draw: the teacher's pseudo-label
    dropout, the mix boxes or scores, the photometric and AdvMorph draws,
    the teacher's and the student's dropout, the sampler uniforms, the TPS
    draws and the TPS forward's dropout. Shapes: the global labeled
    images, the unlabeled ones as given and as mixed (after
    ``output_size``). An injected dropout entry must hold every mask of
    its forward."""
    gen, dev = state.generator, state.random_pool.device
    out = dict(draws)
    dmask = dict(out.get("dropout", {}))

    def masks(name, model, shape):
        if dmask.get(name) is None:
            dmask[name] = model.draw_dropout_masks(shape, gen, dev)

    b_u, spatial = u_shape[0], tuple(u_shape[2:])
    masks("pseudo", state.ema_model, u_in_shape)
    if cfg.apply_aug in ("cutout", "cutmix"):
        if out.get("mix_boxes") is None:
            out["mix_boxes"] = draw_cutout_boxes(b_u, spatial, generator=gen,
                                                 device=dev)
    elif cfg.apply_aug == "classmix" and out.get("mix_scores") is None:
        out["mix_scores"] = torch.rand((b_u, num_classes), generator=gen,
                                       device=dev)
    for flag, key, draw in (
            (cfg.use_photometric, "photometric",
             lambda: draw_photometric(b_u, gen, dev)),
            (cfg.use_adv_morph, "morph",
             lambda: draw_morph(b_u, (spatial[1] // 8,) * 2, gen, dev))):
        if flag:
            part = dict(out.get(key, {}))
            for name in (("cj1", "cj2") if key == "photometric"
                         else ("m1", "m2")):
                if part.get(name) is None:
                    part[name] = draw()
            out[key] = part
    masks("tl", state.ema_model, l_shape)
    masks("tu", state.ema_model, u_shape)
    masks("l", state.model, l_shape)
    if getattr(cfg, "dead_forward", False):
        masks("dead", state.model, l_shape)
    masks("u", state.model, u_shape)
    if cfg.compute_contrastive:
        contra = dict(out.get("contra") or {})
        half = 2 if cfg.func == "asmc" else 1
        q = cfg.num_queries
        for name, n in (("enq", cfg.memobank_enqueue), ("anchor", q // half),
                        ("neg", q * cfg.num_negatives // half)):
            if contra.get(name) is None:
                contra[name] = torch.rand((num_classes, n), generator=gen,
                                          device=dev)
        out["contra"] = contra
    if cfg.compute_eqv:
        total = l_shape[0] + b_u
        if out.get("tps") is None:
            out["tps"] = draw_tps(total, modules.tps.sigma,
                                  random_scale=modules.tps.random_scale,
                                  generator=gen, device=dev)
        masks("tps", state.model, (total,) + tuple(u_shape[1:]))
    out["dropout"] = dmask
    return out


def _local_draws(draws, shard: BatchShard):
    """This rank's rows of the global ``draws``: the unlabeled samples'
    for the mix, the strong augmentations and the forwards of unlabeled
    images, the labeled samples' for the labeled forwards, both (labeled
    then unlabeled) for the TPS warp and its forward; scalars (AdvMorph's
    ``p``, the TPS flip) and the sampler uniforms stay whole."""
    u, lu = shard.rows_u(), shard.take_lu
    parts = {"pseudo": u, "tu": u, "u": u, "tl": shard.rows_l(),
             "l": shard.rows_l(), "dead": shard.rows_l(), "tps": lu}
    cut = lambda x, rows: rows(x) if callable(rows) else x[rows]
    out = dict(draws)
    for key in ("mix_boxes", "mix_scores"):
        if out.get(key) is not None:
            out[key] = out[key][u]
    if "photometric" in out:
        out["photometric"] = {name: {k: v[u] for k, v in d.items()}
                              for name, d in out["photometric"].items()}
    if "morph" in out:
        out["morph"] = {name: {**d, "velocity": d["velocity"][u]}
                        for name, d in out["morph"].items()}
    if out.get("tps") is not None:
        out["tps"] = {k: v if k == "flip" else lu(v)
                      for k, v in out["tps"].items()}
    out["dropout"] = {
        name: None if ms is None else
        [None if m is None else cut(m, parts[name]) for m in ms]
        for name, ms in out.get("dropout", {}).items()}
    return out


def make_arco_step(modules: ArcoModules, cfg, num_classes: int,
                   max_iterations: int, optim: OptimConfig = None,
                   output_size=None, device="cuda", mesh=None):
    """Returns step(state, batch, draws=None) -> metrics, which updates
    ``state`` in place.

    batch: image_l [B, C, *S], label_l [B, *S] int, image_u [B, C, *S]
    with S = (H, W) or (X, Y, Z).

    mesh: a ``parallel.mesh.create_mesh`` mesh whose every axis shards the
    batch ("data", or "data" and "space" as ``parallel.dryrun`` shards
    it). Every rank calls the step with its shard of the batch
    (``shard_batch(batch, mesh, mesh.mesh_dim_names)``) and a state equal
    to every other rank's, and gets the whole batch's metrics
    (``pred_l_label`` over the global labeled batch); the state stays
    equal on every rank, and equal to one process's over the whole batch.
    Injected ``draws`` are the global batch's, the same on every rank.
    draws (all optional; missing ones come from ``state.generator``):
      mix_boxes [B_u, 3] (2D) or [B_u, 5] (3D) / mix_scores [B_u, K]
                (augment/mixing.py)
      photometric {cj1, cj2}: the draws of the two batch_photometric calls,
                on the teacher-side copy (images_cj2_u) and the student's
                strong copy (u_aug_strong)  (augment/photometric.py)
      morph {m1, m2}: the draws of the two adv_morph_batch calls, on the
                same two copies               (augment/morph.py)
      tps   {pert, angle, scale, tx, ty, flip}   (augment/tps.py)
      contra {enq, anchor, neg} uniforms         (losses/contrastive.py)
      dropout {pseudo, tl, tu, l, u, tps, dead}: per forward, the model's
                keep-masks: one per encoder block (models/unet2d.py), or
                x5 and x9 (models/vnet3d.py)
    """
    device = resolve_device(device)
    optim = optim or OptimConfig()
    rank, world, group = 0, 1, None
    if mesh is not None:
        rank, world, group = axis_rank(mesh, tuple(mesh.mesh_dim_names))

    def step_fn(state: ArcoState, batch, draws=None):
        draws = draws or {}
        gen = state.generator
        batch = {k: v.to(device) for k, v in batch.items()}
        cast = lambda: _autocast(device, state.compute_dtype)
        # every draw up front, at the global batch's shapes; a rank keeps
        # its rows
        glob = lambda x: (world * x.shape[0],) + tuple(x.shape[1:])
        u_in = glob(batch["image_u"])
        u_shape = u_in if output_size is None \
            else u_in[:2] + tuple(output_size)
        draws = _global_draws(state, modules, cfg, draws,
                              glob(batch["image_l"]), u_in, u_shape,
                              num_classes)
        shard = None
        if group is not None:
            shard = BatchShard(group, rank, world, batch["image_l"].shape[0],
                               batch["image_u"].shape[0])
            draws = _local_draws(draws, shard)
        dmask = draws.get("dropout", {})

        # teacher EMA of the feature extractor BEFORE the forwards
        ema_update(state.k_feature_extractor, state.feature_extractor, 0.99)

        with torch.no_grad():
            with cast(), _sync(state.ema_model, group):
                pred_u_t0, _, _ = state.ema_model(batch["image_u"],
                                                  dmask.get("pseudo"), gen)
            probs = torch.softmax(_nhwc(pred_u_t0).float(), dim=-1)
            pseudo_logits, pseudo_labels = probs.max(dim=-1)
            pseudo_labels = pseudo_labels.to(torch.int32)

            u_img = batch["image_u"]
            if output_size is not None \
                    and tuple(u_img.shape[2:]) != tuple(output_size):
                u_img = resize_nearest(u_img, output_size)
                pseudo_labels = resize_nearest(pseudo_labels[:, None],
                                               output_size)[:, 0]
                pseudo_logits = resize_nearest(pseudo_logits[:, None],
                                               output_size)[:, 0]
            u_aug_data, u_aug_label, u_aug_logits = generate_unsup_data(
                u_img, pseudo_labels, pseudo_logits, mode=cfg.apply_aug,
                num_classes=num_classes, boxes=draws.get("mix_boxes"),
                scores=draws.get("mix_scores"), generator=gen, shard=shard)

            # two independently drawn strong copies: images_cj2_u for the
            # eqv warp, u_aug_strong for the teacher and student forwards
            images_cj2_l = batch["image_l"]
            u_aug_strong = images_cj2_u = u_aug_data
            if cfg.use_photometric:
                pd = draws.get("photometric", {})
                images_cj2_u = batch_photometric(images_cj2_u, pd.get("cj1"),
                                                 gen)
                u_aug_strong = batch_photometric(u_aug_strong, pd.get("cj2"),
                                                 gen)
            if cfg.use_adv_morph:
                md = draws.get("morph", {})
                coarse = cfg.morph_coarse_exp
                images_cj2_u = adv_morph_batch(images_cj2_u,
                                               coarse_exp=coarse,
                                               draws=md.get("m1"),
                                               generator=gen)
                u_aug_strong = adv_morph_batch(u_aug_strong,
                                               coarse_exp=coarse,
                                               draws=md.get("m2"),
                                               generator=gen)
            if getattr(cfg, "quantize_augs", False):
                q8 = lambda x: torch.floor(x.clamp(0.0, 1.0) * 255.0) / 255.0
                u_aug_strong, images_cj2_u = q8(u_aug_strong), \
                    q8(images_cj2_u)
                u_aug_logits, images_cj2_l = q8(u_aug_logits), \
                    q8(images_cj2_l)

            with cast(), _sync(state.ema_model, group):
                pred_l_t, _, l_fmap_t = state.ema_model(
                    batch["image_l"], dmask.get("tl"), gen)
                pred_u_t, _, u_fmap_t = state.ema_model(
                    u_aug_strong, dmask.get("tu"), gen)
                rep_t_all = _fuse(state.k_feature_extractor, l_fmap_t,
                                  u_fmap_t)
            b_tl = batch["image_l"].shape[0]
            aug = {"u_aug_data": u_aug_strong, "u_aug_label": u_aug_label,
                   "u_aug_logits": u_aug_logits,
                   "images_cj2_l": images_cj2_l,
                   "images_cj2_u": images_cj2_u,
                   "prob_l_teacher": torch.softmax(
                       _nhwc(pred_l_t).float(), dim=-1),
                   "prob_u_teacher": torch.softmax(
                       _nhwc(pred_u_t).float(), dim=-1),
                   "rep_teacher_all": rep_t_all,
                   "rep_u_teacher": rep_t_all[b_tl:]}

        loss, metrics = arco_loss_fn(state, modules, cfg, batch, aug, draws,
                                     num_classes, max_iterations, shard)
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        if group is not None:
            average_gradients(torch.nn.ModuleList([
                state.model, state.feature_extractor,
                state.q_representation]), group)
        set_lr(state.optimizer, poly_lr(optim.base_lr, state.step,
                                        max_iterations, optim.poly_power))
        state.optimizer.step()

        # teacher model EMA (m = 0.99) over parameters; its BN statistics
        # came from its own forwards above
        ema_update(state.ema_model, state.model, 0.99)

        # random-pool enqueue, after the revisiting loss read the pool
        with torch.no_grad():
            keys = normalize.l2_normalize(
                aug["rep_u_teacher"].float(),
                normalize.feature_axes(aug["rep_u_teacher"]))
            if shard is not None:
                # the global unlabeled batch's keys, in its order
                keys = shard.gather(keys.to(state.random_pool.dtype))
            state.random_pool_ptr = enqueue_fixed(
                state.random_pool, state.random_pool_ptr, keys)
        state.step += 1
        return metrics

    return step_fn
