"""Carry a JAX ``ArcoState`` (stage 2) or ``PretrainState`` (stage 1) across
into the port.

The input is the JAX state as numpy arrays in nested dicts (the memory
bank as ``{"data", "ptr", "count"}``). This inverts arco_tpu/compat/torch_import.py
(convert_unet_state_dict, convert_feature_extractor_state_dict,
convert_q_representation_state_dict) without importing it:

- conv kernels [*k, in, out] -> [out, in, *k] (2D and 3D);
- transposed-conv kernels [*k, in, out] -> [in, out, *k] flipped in every
  spatial dim (flax places an unflipped kernel, torch's transposed conv is
  the gradient of a conv: the inverse of torch_import's ``_convT3d``);
- Dense kernels [in, out] -> Linear weights [out, in];
- a stacked head's ``Conv_{i}`` / ``Dense_{i}`` -> its layer ``{i}``;
- BatchNorm scale/bias + batch_stats mean/var -> weight/bias +
  running_mean/running_var;
- the random pool [K, *spatial, C] is already the port's layout
  (channels-last reps, see models/heads.py) and is copied as it is.

The model is the 2D U-Net, the 3D V-Net or one of the 3-D U-Nets (module
names of models/unet2d.py, models/vnet3d.py and models/unet3d.py), told
apart by the flax tree.
"""

from __future__ import annotations

import numpy as np
import torch


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


def _conv(p):
    k = np.asarray(p["kernel"])
    nd = k.ndim - 2
    out = {"weight": _t(k.transpose((nd + 1, nd) + tuple(range(nd))))}
    if "bias" in p:
        out["bias"] = _t(p["bias"])
    return out


def _conv_transpose(p):
    k = np.asarray(p["kernel"])
    nd = k.ndim - 2
    k = np.flip(k, axis=tuple(range(nd)))
    return {"weight": _t(k.transpose((nd, nd + 1) + tuple(range(nd)))),
            "bias": _t(p["bias"])}


def _put(sd, prefix, layer):
    sd.update({f"{prefix}.{k}": v for k, v in layer.items()})


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


_VNET_NAMES = ("one", "two", "three", "four", "five", "six", "seven",
               "eight", "nine")


def vnet_state_dict_from_flax(params, batch_stats) -> dict:
    """flax VNet (params, batch_stats) -> state_dict of models.vnet3d.VNet
    (the reference module names; inverse of torch_import's
    convert_vnet_state_dict)."""
    sd = {}
    for i, name in enumerate(_VNET_NAMES):
        p, s = params[f"VNetConvBlock_{i}"], batch_stats[f"VNetConvBlock_{i}"]
        for j in range(sum(1 for k in p if k.startswith("ConvBNAct_"))):
            cp, cs = p[f"ConvBNAct_{j}"], s[f"ConvBNAct_{j}"]
            _put(sd, f"block_{name}.conv.{3 * j}", _conv(cp["Conv_0"]))
            _put(sd, f"block_{name}.conv.{3 * j + 1}",
                 _bn(cp["BatchNorm_0"], cs["BatchNorm_0"]))
    for kind, names, conv in (
            ("DownBlock", _VNET_NAMES[:4], lambda p: _conv(p["Conv_0"])),
            ("UpBlock", _VNET_NAMES[4:8], lambda p: _conv_transpose(
                p["ConvTransposeUp_0"]["ConvTranspose_0"]))):
        suffix = "dw" if kind == "DownBlock" else "up"
        for i, name in enumerate(names):
            p, s = params[f"{kind}_{i}"], batch_stats[f"{kind}_{i}"]
            _put(sd, f"block_{name}_{suffix}.conv.0", conv(p))
            _put(sd, f"block_{name}_{suffix}.conv.1",
                 _bn(p["BatchNorm_0"], s["BatchNorm_0"]))
    _put(sd, "out_conv", _conv(params["Conv_0"]))
    return sd


def _unet_conv3(p, prefix, sd):
    """A UnetConv3's two convs (its InstanceNorms hold no state)."""
    _put(sd, f"{prefix}.conv1.0", _conv(p["Conv_0"]))
    _put(sd, f"{prefix}.conv2.0", _conv(p["Conv_1"]))


def unet3d_state_dict_from_flax(params, batch_stats) -> dict:
    """flax UNet3D, UNet3DDVSemi or AttentionUNet3D (params, batch_stats)
    -> state_dict of the models.unet3d model (the reference module names;
    inverse of torch_import_zoo's convert_unet3d_state_dict,
    convert_unet3d_dv_semi_state_dict and
    convert_attention_unet_state_dict)."""
    sd = {}
    for i, name in enumerate(("conv1", "conv2", "conv3", "conv4", "center")):
        _unet_conv3(params[f"UnetConv3_{i}"], name, sd)
    for i, name in enumerate(("up_concat4", "up_concat3", "up_concat2",
                              "up_concat1")):
        _unet_conv3(params[f"UnetUp3CT_{i}"]["UnetConv3_0"], f"{name}.conv",
                    sd)
    if "dsv1" in params:
        _put(sd, "dsv1", _conv(params["dsv1"]))
        for k in (2, 3, 4):
            _put(sd, f"dsv{k}.dsv.0", _conv(params[f"dsv{k}"]))
    if "final" in params:                     # AttentionUNet3D
        _put(sd, "final", _conv(params["final"]))
    elif "Conv_0" in params:                  # UNet3D
        _put(sd, "final", _conv(params["Conv_0"]))
    if "MultiAttentionBlock_0" in params:
        _put(sd, "gating.conv1.0", _conv(params["Conv_0"]))
        for i, blk in enumerate(("attentionblock4", "attentionblock3",
                                 "attentionblock2")):
            p = params[f"MultiAttentionBlock_{i}"]
            s = batch_stats[f"MultiAttentionBlock_{i}"]
            for g in range(2):
                gp = p[f"GridAttentionBlock3D_{g}"]
                gs = s[f"GridAttentionBlock3D_{g}"]
                pre = f"{blk}.gate_block_{g + 1}"
                for j, part in enumerate(("theta", "phi", "psi", "W.0")):
                    _put(sd, f"{pre}.{part}", _conv(gp[f"Conv_{j}"]))
                _put(sd, f"{pre}.W.1", _bn(gp["BatchNorm_0"],
                                           gs["BatchNorm_0"]))
            _put(sd, f"{blk}.combine_gates.0", _conv(p["Conv_0"]))
            _put(sd, f"{blk}.combine_gates.1", _bn(p["BatchNorm_0"],
                                                   s["BatchNorm_0"]))
    return sd


def model_state_dict_from_flax(params, batch_stats) -> dict:
    """The model's state_dict: U-Net, V-Net or a 3-D U-Net by the flax
    tree."""
    if "VNetConvBlock_0" in params:
        return vnet_state_dict_from_flax(params, batch_stats)
    if "UnetConv3_0" in params:
        return unet3d_state_dict_from_flax(params, batch_stats)
    return unet_state_dict_from_flax(params, batch_stats)


def feature_extractor_state_dict_from_flax(params) -> dict:
    return {f"{name}.weight": _conv(p)["weight"]
            for name, p in params.items()}


def head_state_dict_from_flax(params) -> dict:
    """A stacked head's flax params (QRepresentation, ProjectionHead,
    LatentMLP, LatentPredictor, OutputsPredictor, RepresentationHead; 1x1
    or 1x1x1 conv kernels) -> the port head's state_dict."""
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
    """Copy a JAX ArcoState, 2D or 3D (numpy, as ``{"params",
    "batch_stats", "ema_params", "ema_batch_stats", "k_feature_params",
    "memobank", "random_pool", "random_pool_ptr", "step"}``) into the port's
    ``train.arco2d.ArcoState`` in place. The optimizer's momentum is not
    carried (a fresh JAX state has a zero trace, as a fresh SGD has none)."""
    params = flax_state["params"]
    state.model.load_state_dict(model_state_dict_from_flax(
        params["model"], flax_state["batch_stats"]["model"]))
    state.ema_model.load_state_dict(model_state_dict_from_flax(
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
    ``train.pretrain.PretrainState`` in place, 2D or 3D (the model told
    apart by its flax tree). The queues keep their layout: JAX flattens
    each descriptor in (h, w, c) / (x, y, z, c) order, as the port does.
    The optimizer's momentum is not carried."""
    params, ema = flax_state["params"], flax_state["ema_params"]
    for target, p, s in ((state.model, params, flax_state["batch_stats"]),
                         (state.ema_model, ema,
                          flax_state["ema_batch_stats"])):
        target.load_state_dict(model_state_dict_from_flax(p["model"],
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
