"""Local pretrained-weight importers for the transformer/CNN zoo
(counterpart of arco_tpu/compat/pretrained.py; the ``--pretrained_path``
of ``pretrain_2d`` and ``train_arco_2d``).

The reference loads ImageNet weights for TransUNet
(vit_seg_modeling.py:400-457 ``load_from``, R50+ViT-B_16 .npz), Swin-UNet
(vision_transformer.py:50-89 ``load_from``, Swin .pth with encoder->decoder
mirroring) and EfficientUNet (lukemelas EfficientNet .pth). Nothing is
downloaded: the converters read a local file into a partial state dict of
the port's models (models/transunet.py, models/swin_unet.py,
models/efficientunet.py), which keep the reference's torch layouts, and
``deep_merge`` copies it in by name and shape.

Layout conversions:
- ViT .npz is flax-native: HWIO convs -> OIHW, Dense [in, out] -> Linear
  [out, in], attention kernels [hidden, heads, head_dim] -> [hidden,
  hidden]; the position embedding's class token is dropped and its grid
  resized bilinearly (``scipy.ndimage.zoom(order=1)``) as the reference
  does (vit_seg_modeling.py:406-428).
- Swin .pth is torch already. PatchMerging's 4C concat order differs: the
  reference's x0..x3 are h0w0, h1w0, h0w1, h1w1, and the port's
  ``PatchMerging`` flattens (row, col) as h0w0, h0w1, h1w0, h1w1 (as JAX
  does), so its norm and reduction take the channel-block permutation
  [0, 2, 1, 3]; relative-position bias tables are resized to each stage's
  clamped window; encoder stage s is mirrored into the decoder stage of the
  same width (vision_transformer.py:74-79).
- EfficientNet .pth (lukemelas): ``_blocks.{i}`` in order are the port's
  ``encoder.blocks.{i}``; a 3-channel stem is summed over its input
  channels for a grayscale model.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch


def _np(v):
    return v.cpu().numpy() if hasattr(v, "cpu") else np.asarray(v)


def _t(v):
    return torch.from_numpy(np.array(_np(v), copy=True))


def deep_merge(target: Dict, updates: Dict) -> Dict:
    """A copy of the state dict ``target`` with the tensors of ``updates``
    in place of its own; a name ``target`` lacks raises KeyError and a
    shape mismatch ValueError, so no key can be lost silently."""
    out = dict(target)
    for k, v in updates.items():
        if k not in out:
            raise KeyError(f"pretrained key {k!r} not in target state dict "
                           f"(have {sorted(out)[:8]}...)")
        if tuple(out[k].shape) != tuple(v.shape):
            raise ValueError(
                f"shape mismatch for {k!r}: target {tuple(out[k].shape)} "
                f"vs pretrained {tuple(v.shape)}")
        out[k] = v
    return out


# --------------------------------------------------------------------------
# TransUNet: ViT .npz (R50+ViT-B_16)
# --------------------------------------------------------------------------

def _resize_posembed(posemb: np.ndarray, n_tokens: int) -> np.ndarray:
    """Drop the class token and bilinearly resize the grid
    (vit_seg_modeling.py:406-428)."""
    posemb = np.asarray(posemb)
    if posemb.shape[1] == n_tokens:
        return posemb
    if posemb.shape[1] - 1 == n_tokens:
        return posemb[:, 1:]
    grid = posemb[0, 1:] if posemb.shape[1] % 2 else posemb[0]
    gs_old = int(np.sqrt(grid.shape[0]))
    gs_new = int(np.sqrt(n_tokens))
    from scipy import ndimage
    grid = grid.reshape(gs_old, gs_old, -1)
    zoom = (gs_new / gs_old, gs_new / gs_old, 1)
    grid = ndimage.zoom(grid, zoom, order=1)
    return grid.reshape(1, gs_new * gs_new, -1)


def _hwio(k):
    return _t(np.asarray(k).transpose(3, 2, 0, 1))


def convert_vit_npz(weights: Dict, n_tokens: int, num_layers: int = 12,
                    resnet_units: Sequence[int] = (3, 4, 9)) -> Dict:
    """R50+ViT-B_16 .npz -> partial state dict of
    models.transunet.VisionTransformerSeg: the hybrid ResNet stem, the
    patch embedding, the position embedding, ``num_layers`` transformer
    blocks and the encoder norm, the subset the reference's load_from
    restores; the decoder and the head keep their init."""
    w = {k: np.asarray(v) for k, v in weights.items()}
    sd: Dict = {"resnet.root_conv.weight": _hwio(w["conv_root/kernel"]),
                "resnet.root_gn.weight": _t(w["gn_root/scale"].reshape(-1)),
                "resnet.root_gn.bias": _t(w["gn_root/bias"].reshape(-1))}
    for stage, n_units in enumerate(resnet_units):
        for u in range(1, n_units + 1):
            src = f"block{stage + 1}/unit{u}/"
            dst = f"resnet.stages.{stage}.{u - 1}."
            names = [("conv_proj", "downsample", "gn_proj")] if u == 1 \
                else []
            names += [(f"conv{c}", f"conv{c}", f"gn{c}") for c in (1, 2, 3)]
            for conv, port_conv, gn in names:
                sd[dst + f"{port_conv}.weight"] = _hwio(
                    w[src + f"{conv}/kernel"])
                sd[dst + f"{gn}.weight"] = _t(
                    w[src + f"{gn}/scale"].reshape(-1))
                sd[dst + f"{gn}.bias"] = _t(w[src + f"{gn}/bias"].reshape(-1))

    # patch embedding (1x1 conv over the 1/16 hybrid features)
    sd["patch_embeddings.weight"] = _hwio(w["embedding/kernel"])
    sd["patch_embeddings.bias"] = _t(w["embedding/bias"])
    sd["pos_embedding"] = _t(_resize_posembed(
        w["Transformer/posembed_input/pos_embedding"], n_tokens))

    def norm(dst, src):
        sd[dst + ".weight"] = _t(w[src + "/scale"])
        sd[dst + ".bias"] = _t(w[src + "/bias"])

    def dense(dst, src):
        sd[dst + ".weight"] = _t(w[src + "/kernel"].T)
        sd[dst + ".bias"] = _t(w[src + "/bias"])

    for i in range(num_layers):
        src = f"Transformer/encoderblock_{i}/"
        dst = f"layers.{i}."
        att = src + "MultiHeadDotProductAttention_1/"
        norm(dst + "attention_norm", src + "LayerNorm_0")
        for name in ("query", "key", "value"):
            k = w[att + f"{name}/kernel"]
            sd[dst + f"attn.{name}.weight"] = _t(k.reshape(k.shape[0], -1).T)
            sd[dst + f"attn.{name}.bias"] = _t(
                w[att + f"{name}/bias"].reshape(-1))
        k = w[att + "out/kernel"]
        sd[dst + "attn.out.weight"] = _t(k.reshape(-1, k.shape[-1]).T)
        sd[dst + "attn.out.bias"] = _t(w[att + "out/bias"])
        norm(dst + "ffn_norm", src + "LayerNorm_2")
        dense(dst + "fc1", src + "MlpBlock_3/Dense_0")
        dense(dst + "fc2", src + "MlpBlock_3/Dense_1")
    norm("encoder_norm", "Transformer/encoder_norm")
    return sd


# --------------------------------------------------------------------------
# Swin-UNet: ImageNet Swin .pth
# --------------------------------------------------------------------------

# the port's PatchMerging concatenates (row, col) row-major = [x0, x2, x1,
# x3] in the reference's [x0, x1, x2, x3] = [h0w0, h1w0, h0w1, h1w1]
_MERGE_PERM = (0, 2, 1, 3)


def _perm4c(v: np.ndarray, axis: int = 0) -> np.ndarray:
    chunks = np.split(v, 4, axis=axis)
    return np.concatenate([chunks[i] for i in _MERGE_PERM], axis=axis)


def _resize_bias_table(table: np.ndarray, ws_new: int) -> np.ndarray:
    side_old = int(np.sqrt(table.shape[0]))
    side_new = 2 * ws_new - 1
    if side_old == side_new:
        return table
    from scipy import ndimage
    t = table.reshape(side_old, side_old, -1)
    t = ndimage.zoom(t, (side_new / side_old, side_new / side_old, 1),
                     order=1)
    return t.reshape(side_new * side_new, -1)


def _swin_block(sd: Dict, src: str, dst: str, ws: int, out: Dict):
    for a, b in (("norm1", "norm1"), ("attn.qkv", "attn.qkv"),
                 ("attn.proj", "attn.proj"), ("norm2", "norm2"),
                 ("mlp.fc1", "fc1"), ("mlp.fc2", "fc2")):
        out[f"{dst}{b}.weight"] = _t(sd[f"{src}{a}.weight"])
        out[f"{dst}{b}.bias"] = _t(sd[f"{src}{a}.bias"])
    out[f"{dst}attn.relative_position_bias_table"] = _t(_resize_bias_table(
        _np(sd[f"{src}attn.relative_position_bias_table"]), ws))


def convert_swin_state_dict(sd: Dict, depths: Sequence[int] = (2, 2, 2, 2),
                            depths_decoder: Optional[Sequence[int]] = None,
                            window_size: int = 8, img_size: int = 224,
                            ape: bool = False) -> Dict:
    """ImageNet Swin encoder .pth ({'model': state_dict} or flat) ->
    partial state dict of models.swin_unet.SwinUnet, with the reference's
    encoder->decoder mirroring (vision_transformer.py:74-79: decoder stage
    s reuses encoder stage s's block weights).

    ``img_size`` sets each stage's effective window (SwinBlock clamps
    ws = min(window_size, stage resolution)), which sizes the
    relative-position bias tables to resize into."""
    sd = sd.get("model", sd)
    n = len(depths)
    stage_ws = [min(window_size, max(1, img_size // 4 // (2 ** s)))
                for s in range(n)]
    out: Dict = {"patch_embed.weight": _t(sd["patch_embed.proj.weight"]),
                 "patch_embed.bias": _t(sd["patch_embed.proj.bias"])}
    if "patch_embed.norm.weight" in sd:
        out["patch_norm.weight"] = _t(sd["patch_embed.norm.weight"])
        out["patch_norm.bias"] = _t(sd["patch_embed.norm.bias"])
    if ape and "absolute_pos_embed" in sd:
        emb = _np(sd["absolute_pos_embed"])          # [1, L, C]
        side = int(np.sqrt(emb.shape[1]))
        out["absolute_pos_embed"] = _t(emb.reshape(1, side, side, -1))

    for stage, depth in enumerate(depths):
        for j in range(depth):
            src = f"layers.{stage}.blocks.{j}."
            if f"{src}norm1.weight" in sd:
                _swin_block(sd, src, f"layers.{stage}.{j}.", stage_ws[stage],
                            out)
        pre = f"layers.{stage}.downsample."
        if stage < n - 1 and f"{pre}norm.weight" in sd:
            out[f"downsample.{stage}.norm.weight"] = _t(_perm4c(
                _np(sd[f"{pre}norm.weight"])))
            out[f"downsample.{stage}.norm.bias"] = _t(_perm4c(
                _np(sd[f"{pre}norm.bias"])))
            out[f"downsample.{stage}.reduction.weight"] = _t(_perm4c(
                _np(sd[f"{pre}reduction.weight"]), axis=1))
    if "norm.weight" in sd:
        out["norm.weight"] = _t(sd["norm.weight"])
        out["norm.bias"] = _t(sd["norm.bias"])

    # decoder mirror: the port's layers_up.{i} is stage n - 2 - i, whose
    # depth comes from depths_decoder or the encoder's
    for stage in range(n - 2, -1, -1):
        d = (depths_decoder[n - 1 - stage]
             if depths_decoder is not None else depths[stage])
        for j in range(d):
            src = f"layers.{stage}.blocks.{j}."
            if f"{src}norm1.weight" in sd:
                _swin_block(sd, src, f"layers_up.{n - 2 - stage}.{j}.",
                            stage_ws[stage], out)
    return out


# --------------------------------------------------------------------------
# EfficientUNet: lukemelas EfficientNet .pth
# --------------------------------------------------------------------------

def _conv(sd, src, dst, out):
    out[f"{dst}.weight"] = _t(sd[f"{src}.weight"])
    if f"{src}.bias" in sd:
        out[f"{dst}.bias"] = _t(sd[f"{src}.bias"])


def _bn(sd, src, dst, out):
    for a, b in (("weight", "weight"), ("bias", "bias"),
                 ("running_mean", "running_mean"),
                 ("running_var", "running_var")):
        out[f"{dst}.{b}"] = _t(sd[f"{src}.{a}"])


def convert_efficientnet_state_dict(sd: Dict, depth: float = 1.4,
                                    in_chns: int = 3) -> Dict:
    """lukemelas EfficientNet(-B3) .pth -> partial state dict (weights and
    BatchNorm running statistics) of the ``encoder`` of
    models.efficientunet.EffiUNet, ``depth`` the B3 block-count scale
    (the channel widths come from the file). The classifier head
    (_conv_head/_fc) has no counterpart and is skipped. For a grayscale
    model (in_chns=1) the RGB stem is summed over its input channels, the
    standard adaptation that keeps the response to replicated-gray
    inputs."""
    from arco_torch.models.efficientunet import B0_BLOCKS, _round_repeats
    out: Dict = {}
    _conv(sd, "_conv_stem", "encoder.stem_conv", out)
    stem = out["encoder.stem_conv.weight"]
    if in_chns != stem.shape[1]:
        if in_chns != 1:
            raise ValueError(f"cannot adapt stem from {stem.shape[1]} to "
                             f"{in_chns} channels")
        out["encoder.stem_conv.weight"] = _t(
            _np(stem).sum(axis=1, keepdims=True))
    _bn(sd, "_bn0", "encoder.stem_bn", out)

    i = 0
    for (e, _c, r, _s, _k) in B0_BLOCKS:
        for _ in range(_round_repeats(r, depth)):
            src, dst = f"_blocks.{i}", f"encoder.blocks.{i}"
            if e != 1:
                _conv(sd, f"{src}._expand_conv", f"{dst}.expand_conv", out)
                _bn(sd, f"{src}._bn0", f"{dst}.expand_bn", out)
            _conv(sd, f"{src}._depthwise_conv", f"{dst}.dw_conv", out)
            _bn(sd, f"{src}._bn1", f"{dst}.dw_bn", out)
            _conv(sd, f"{src}._se_reduce", f"{dst}.se.reduce", out)
            _conv(sd, f"{src}._se_expand", f"{dst}.se.expand", out)
            _conv(sd, f"{src}._project_conv", f"{dst}.project_conv", out)
            _bn(sd, f"{src}._bn2", f"{dst}.project_bn", out)
            i += 1
    return out


# --------------------------------------------------------------------------
# top-level loader
# --------------------------------------------------------------------------

@torch.no_grad()
def load_pretrained(model: str, path: str, module: torch.nn.Module,
                    **kw) -> list:
    """Merge the local pretrained checkpoint file at ``path`` into
    ``module`` in place (its weights and, where the file has them, its
    BatchNorm running statistics); return the names loaded. ``model`` in
    {'vit_seg', 'swin_unet', 'efficient_unet'} (the factory key 'ViT_Seg'
    accepted); extra kwargs go to the converter."""
    key = model.lower()
    if key == "vit_seg":
        w = dict(np.load(path))
        sub = convert_vit_npz(w, int(module.pos_embedding.shape[1]), **kw)
    elif key == "swin_unet":
        sub = convert_swin_state_dict(
            torch.load(path, map_location="cpu", weights_only=True), **kw)
    elif key == "efficient_unet":
        sd = torch.load(path, map_location="cpu", weights_only=True)
        sd = sd.get("state_dict", sd)
        kw.setdefault("in_chns",
                      int(module.encoder.stem_conv.weight.shape[1]))
        sub = convert_efficientnet_state_dict(sd, **kw)
    else:
        raise ValueError(f"no pretrained importer for model {key!r}")
    module.load_state_dict(deep_merge(module.state_dict(), sub))
    return sorted(sub)
