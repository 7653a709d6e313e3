"""Carry a JAX ``ArcoState`` (stage 2) or ``PretrainState`` (stage 1) across
into the port.

The input is the JAX state as numpy arrays in nested dicts (the memory
bank as ``{"data", "ptr", "count"}``). This inverts arco_tpu/compat/torch_import.py
(convert_unet_state_dict, convert_feature_extractor_state_dict,
convert_q_representation_state_dict) without importing it:

- conv kernels [kh, kw, in, out] -> [out, in, kh, kw];
- Dense kernels [in, out] -> Linear weights [out, in];
- a stacked head's ``Conv_{i}`` / ``Dense_{i}`` -> its layer ``{i}``;
- BatchNorm scale/bias + batch_stats mean/var -> weight/bias +
  running_mean/running_var;
- the random pool [K, H, W, C] is already the port's layout (channels-last
  reps, see models/heads.py) and is copied as it is.
"""

from __future__ import annotations

import numpy as np
import torch


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


def _conv(p):
    out = {"weight": _t(np.asarray(p["kernel"]).transpose(3, 2, 0, 1))}
    if "bias" in p:
        out["bias"] = _t(p["bias"])
    return out


def _bn(p, s):
    return {"weight": _t(p["scale"]), "bias": _t(p["bias"]),
            "running_mean": _t(s["mean"]), "running_var": _t(s["var"]),
            "num_batches_tracked": torch.tensor(0)}


def _block(p, s, prefix, sd):
    for j, idx in enumerate((0, 4)):
        cp, cs = p[f"ConvBNAct_{j}"], s[f"ConvBNAct_{j}"]
        for k, v in _conv(cp["Conv_0"]).items():
            sd[f"{prefix}.conv_conv.{idx}.{k}"] = v
        for k, v in _bn(cp["BatchNorm_0"], cs["BatchNorm_0"]).items():
            sd[f"{prefix}.conv_conv.{idx + 1}.{k}"] = v


def unet_state_dict_from_flax(params, batch_stats) -> dict:
    """flax UNet (params, batch_stats) -> state_dict of models.unet2d.UNet
    (the reference module names)."""
    sd = {}
    enc_p, enc_s = params["Encoder_0"], batch_stats["Encoder_0"]
    _block(enc_p["ConvBlock2D_0"], enc_s["ConvBlock2D_0"],
           "encoder.in_conv", sd)
    depth = sum(1 for k in enc_p if k.startswith("ConvBlock2D_"))
    for k in range(1, depth):
        _block(enc_p[f"ConvBlock2D_{k}"], enc_s[f"ConvBlock2D_{k}"],
               f"encoder.down{k}.maxpool_conv.1", sd)
    dec_p, dec_s = params["Decoder_0"], batch_stats["Decoder_0"]
    for k in range(1, depth):
        for n, v in _conv(dec_p[f"BilinearUp_{k - 1}"]["Conv_0"]).items():
            sd[f"decoder.up{k}.conv1x1.{n}"] = v
        _block(dec_p[f"ConvBlock2D_{k - 1}"], dec_s[f"ConvBlock2D_{k - 1}"],
               f"decoder.up{k}.conv", sd)
    for n, v in _conv(dec_p["Conv_0"]).items():
        sd[f"decoder.out_conv.{n}"] = v
    return sd


def feature_extractor_state_dict_from_flax(params) -> dict:
    return {f"{name}.weight": _conv(p)["weight"]
            for name, p in params.items()}


def head_state_dict_from_flax(params) -> dict:
    """A stacked head's flax params (QRepresentation, ProjectionHead,
    LatentMLP, LatentPredictor, OutputsPredictor, RepresentationHead) ->
    the port head's state_dict."""
    sd = {}
    for name, p in params.items():
        kind, i = name.rsplit("_", 1)
        layer = {"weight": _t(np.asarray(p["kernel"]).T)} \
            if kind == "Dense" else _conv(p)
        if kind == "Dense" and "bias" in p:
            layer["bias"] = _t(p["bias"])
        sd.update({f"{i}.{k}": v for k, v in layer.items()})
    return sd


@torch.no_grad()
def load_flax_arco_state(state, flax_state: dict):
    """Copy a JAX ArcoState (numpy, as ``{"params", "batch_stats",
    "ema_params", "ema_batch_stats", "k_feature_params", "memobank",
    "random_pool", "random_pool_ptr", "step"}``) into the port's
    ``train.arco2d.ArcoState`` in place. The optimizer's momentum is not
    carried (a fresh JAX state has a zero trace, as a fresh SGD has none)."""
    params = flax_state["params"]
    state.model.load_state_dict(unet_state_dict_from_flax(
        params["model"], flax_state["batch_stats"]["model"]))
    state.ema_model.load_state_dict(unet_state_dict_from_flax(
        flax_state["ema_params"]["model"],
        flax_state["ema_batch_stats"]["model"]))
    state.feature_extractor.load_state_dict(
        feature_extractor_state_dict_from_flax(params["feature_extractor"]))
    state.k_feature_extractor.load_state_dict(
        feature_extractor_state_dict_from_flax(
            flax_state["k_feature_params"]))
    state.q_representation.load_state_dict(
        head_state_dict_from_flax(params["q_representation"]))

    bank, dev = flax_state["memobank"], state.memobank.data.device
    state.memobank.data.copy_(_t(bank["data"]).to(
        dev, state.memobank.data.dtype))
    state.memobank.ptr = _t(bank["ptr"]).to(dev, torch.int32)
    state.memobank.count = _t(bank["count"]).to(dev, torch.int32)
    state.random_pool.copy_(_t(np.asarray(
        flax_state["random_pool"], np.float32)).to(
        dev, state.random_pool.dtype))
    state.random_pool_ptr = int(flax_state["random_pool_ptr"])
    state.step = int(flax_state.get("step", 0))
    return state


@torch.no_grad()
def load_flax_pretrain_state(state, flax_state: dict):
    """Copy a JAX PretrainState (numpy, as ``{"params", "batch_stats",
    "ema_params", "ema_batch_stats", "queue", "queue_ptr", "queue_mask",
    "mask_queue_ptr", "step"}``) into the port's
    ``train.pretrain.PretrainState`` in place. The queues keep their
    layout: JAX flattens each descriptor in (h, w, c) order, as the port
    does. The optimizer's momentum is not carried."""
    params, ema = flax_state["params"], flax_state["ema_params"]
    for target, p, s in ((state.model, params, flax_state["batch_stats"]),
                         (state.ema_model, ema,
                          flax_state["ema_batch_stats"])):
        target.load_state_dict(unet_state_dict_from_flax(p["model"],
                                                         s["model"]))
    for name in ("latent_head", "latent_predictor", "outputs_head",
                 "outputs_predictor"):
        getattr(state, name).load_state_dict(
            head_state_dict_from_flax(params[name]))
    for name in ("latent_head", "outputs_head"):
        getattr(state, f"ema_{name}").load_state_dict(
            head_state_dict_from_flax(ema[name]))
    for name in ("queue", "queue_mask"):
        dst = getattr(state, name)
        dst.copy_(_t(np.asarray(flax_state[name], np.float32)).to(dst))
    state.queue_ptr = int(flax_state["queue_ptr"])
    state.mask_queue_ptr = int(flax_state["mask_queue_ptr"])
    state.step = int(flax_state.get("step", 0))
    return state
