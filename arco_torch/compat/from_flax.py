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

- flax's attention (q/k/v kernels [hidden, heads, head_dim], out kernel
  [heads, head_dim, hidden]) -> query/key/value/out Linear layers;
- LayerNorm / GroupNorm scale/bias -> weight/bias.

The model is any ported one (the 2D zoo, the 3D V-Net, the 3-D U-Nets,
the DeepLabs;
module names of arco_torch/models), told apart by the flax tree
(``model_state_dict_from_flax``). Where the reference's names are known
(U-Net family, PNet, ENet), the port's module names are the reference's.
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
    out = {"weight": _t(k.transpose((nd, nd + 1) + tuple(range(nd))))}
    if "bias" in p:
        out["bias"] = _t(p["bias"])
    return out


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


def _encoder(enc_p, enc_s, prefix, sd):
    _block(enc_p["ConvBlock2D_0"], enc_s["ConvBlock2D_0"],
           f"{prefix}.in_conv", sd)
    depth = sum(1 for k in enc_p if k.startswith("ConvBlock2D_"))
    for k in range(1, depth):
        _block(enc_p[f"ConvBlock2D_{k}"], enc_s[f"ConvBlock2D_{k}"],
               f"{prefix}.down{k}.maxpool_conv.1", sd)


def _decoder(dec_p, dec_s, prefix, sd):
    """A Decoder's tree (or UNetSTEGO's top level, which inlines one)."""
    depth = sum(1 for k in dec_p if k.startswith("BilinearUp_")) + 1
    for k in range(1, depth):
        _put(sd, f"{prefix}.up{k}.conv1x1",
             _conv(dec_p[f"BilinearUp_{k - 1}"]["Conv_0"]))
        _block(dec_p[f"ConvBlock2D_{k - 1}"], dec_s[f"ConvBlock2D_{k - 1}"],
               f"{prefix}.up{k}.conv", sd)
    _put(sd, f"{prefix}.out_conv", _conv(dec_p["Conv_0"]))


def unet_state_dict_from_flax(params, batch_stats) -> dict:
    """flax UNet (params, batch_stats) -> state_dict of models.unet2d.UNet
    (the reference module names); also UNetDS and UNetURPC (plus their
    out_conv_dp* heads) and UNetCCT (main_decoder, aux_decoder1..3)."""
    sd = {}
    _encoder(params["Encoder_0"], batch_stats["Encoder_0"], "encoder", sd)
    main = "main_decoder" if "aux_decoder1" in params else "decoder"
    _decoder(params["Decoder_0"], batch_stats["Decoder_0"], main, sd)
    for k in range(1, 4):
        if f"aux_decoder{k}" in params:
            _decoder(params[f"aux_decoder{k}"],
                     batch_stats[f"aux_decoder{k}"], f"aux_decoder{k}", sd)
    for name in ("dp3", "dp2", "dp1"):
        if f"out_conv_{name}" in params:
            _put(sd, f"out_conv_{name}", _conv(params[f"out_conv_{name}"]))
    return sd


def unet_stego_state_dict_from_flax(params, batch_stats) -> dict:
    """flax UNetSTEGO -> models.unet2d_variants.UNetSTEGO (the inverse of
    torch_import_zoo's convert_unet_stego_state_dict)."""
    sd = {}
    _encoder(params["Encoder_0"], batch_stats["Encoder_0"], "encoder", sd)
    _decoder(params, batch_stats, "decoder", sd)
    _put(sd, "decoder.nonLinearPro.0", _conv(params["Conv_1"]))
    _put(sd, "decoder.nonLinearPro.2", _conv(params["Conv_2"]))
    return sd


def _har_block(p, s, prefix, sd):
    for j in range(2):
        _put(sd, f"{prefix}.conv{j + 1}", _conv(p[f"Conv_{j}"]))
        bp, bs = p[f"BatchNormMul_{j}"], s[f"BatchNormMul_{j}"]["BatchNorm_0"]
        _put(sd, f"{prefix}.bn{j + 1}", {
            "gamma": _t(bp["gamma"]), "beta": _t(bp["beta"]),
            "bn.running_mean": _t(bs["mean"]), "bn.running_var": _t(bs["var"]),
            "bn.num_batches_tracked": torch.tensor(0)})


def unet_har_state_dict_from_flax(params, batch_stats) -> dict:
    """flax UNetHAR -> models.unet2d_variants.UNetHAR (the inverse of
    torch_import_zoo's convert_unet_har_state_dict)."""
    sd = {}
    n = sum(1 for k in params if k.startswith("ConvBlockHAR_"))
    depth = (n + 1) // 2
    for k in range(depth):
        _har_block(params[f"ConvBlockHAR_{k}"],
                   batch_stats[f"ConvBlockHAR_{k}"],
                   "encoder.in_conv" if k == 0 else
                   f"encoder.down{k}.convBlock", sd)
    for k in range(1, depth):
        _put(sd, f"decoder.up{k}.conv1x1",
             _conv(params[f"BilinearUp_{k - 1}"]["Conv_0"]))
        _har_block(params[f"ConvBlockHAR_{k + depth - 1}"],
                   batch_stats[f"ConvBlockHAR_{k + depth - 1}"],
                   f"decoder.up{k}.conv", sd)
    _put(sd, "decoder.out_conv", _conv(params["Conv_0"]))
    return sd


def pnet_state_dict_from_flax(params, batch_stats) -> dict:
    """flax PNet2D -> models.pnet.PNet2D (the reference names; inverse of
    torch_import_zoo's convert_pnet_state_dict)."""
    sd = {}
    n = sum(1 for k in params if k.startswith("PNetBlock_"))
    for b in range(n):
        p, s = params[f"PNetBlock_{b}"], batch_stats[f"PNetBlock_{b}"]
        for j in range(2):
            _put(sd, f"block{b + 1}.conv{j + 1}", _conv(p[f"Conv_{j}"]))
            _put(sd, f"block{b + 1}.in{j + 1}",
                 _bn(p[f"BatchNorm_{j}"], s[f"BatchNorm_{j}"]))
    for i, name in enumerate(("catblock.conv1", "catblock.conv2",
                              "out.conv1", "out.conv2")):
        _put(sd, name, _conv(params[f"Conv_{i}"]))
    return sd


def _prelu(p):
    return {"weight": _t(p["alpha"])}


def _enet_seq(p, s, prefix, sd, j, torch_index=0):
    """Conv_j, BatchNorm_j (and PReLU_j) -> ``prefix``.{i, i+1, i+2}."""
    _put(sd, f"{prefix}.{torch_index}", _conv(p[f"Conv_{j}"]))
    _put(sd, f"{prefix}.{torch_index + 1}",
         _bn(p[f"BatchNorm_{j}"], s[f"BatchNorm_{j}"]))
    if f"PReLU_{j}" in p:
        _put(sd, f"{prefix}.{torch_index + 2}", _prelu(p[f"PReLU_{j}"]))


# the flax ENet's RegularBottleneck_i in creation order (enet.py:453-614)
_ENET_REGULARS = (
    "regular1_1", "regular1_2", "regular1_3", "regular1_4",
    "regular2_1", "dilated2_2", "asymmetric2_3", "dilated2_4", "regular2_5",
    "dilated2_6", "asymmetric2_7", "dilated2_8",
    "regular3_0", "dilated3_1", "asymmetric3_2", "dilated3_3", "regular3_4",
    "dilated3_5", "asymmetric3_6", "dilated3_7",
    "regular4_1", "regular4_2", "regular5_1")


def enet_state_dict_from_flax(params, batch_stats) -> dict:
    """flax ENet -> models.enet.ENet (the reference names; inverse of
    torch_import_zoo's convert_enet_state_dict). A block with PReLU
    activations has PReLU_* params; the ReLU blocks have none."""
    sd = {}
    p, s = params["InitialBlock_0"], batch_stats["InitialBlock_0"]
    _put(sd, "initial_block.main_branch", _conv(p["Conv_0"]))
    _put(sd, "initial_block.batch_norm", _bn(p["BatchNorm_0"],
                                             s["BatchNorm_0"]))
    if "PReLU_0" in p:
        _put(sd, "initial_block.out_activation", _prelu(p["PReLU_0"]))
    for i, name in enumerate(("downsample1_0", "downsample2_0")):
        p = params[f"DownsamplingBottleneck_{i}"]
        s = batch_stats[f"DownsamplingBottleneck_{i}"]
        for j in range(3):
            _enet_seq(p, s, f"{name}.ext_conv{j + 1}", sd, j)
        if "PReLU_3" in p:
            _put(sd, f"{name}.out_activation", _prelu(p["PReLU_3"]))
    for i, name in enumerate(_ENET_REGULARS):
        p = params[f"RegularBottleneck_{i}"]
        s = batch_stats[f"RegularBottleneck_{i}"]
        n2 = 2 if name.startswith("asymmetric") else 1
        _enet_seq(p, s, f"{name}.ext_conv1", sd, 0)
        for j in range(n2):
            _enet_seq(p, s, f"{name}.ext_conv2", sd, 1 + j, 3 * j)
        _enet_seq(p, s, f"{name}.ext_conv3", sd, 1 + n2)
        if f"PReLU_{2 + n2}" in p:
            _put(sd, f"{name}.out_activation", _prelu(p[f"PReLU_{2 + n2}"]))
    for i, name in enumerate(("upsample4_0", "upsample5_0")):
        p = params[f"UpsamplingBottleneck_{i}"]
        s = batch_stats[f"UpsamplingBottleneck_{i}"]
        bn = lambda j: _bn(p[f"BatchNorm_{j}"], s[f"BatchNorm_{j}"])
        _put(sd, f"{name}.main_conv1.0", _conv(p["Conv_0"]))
        _put(sd, f"{name}.main_conv1.1", bn(0))
        _put(sd, f"{name}.ext_conv1.0", _conv(p["Conv_1"]))
        _put(sd, f"{name}.ext_conv1.1", bn(1))
        _put(sd, f"{name}.ext_tconv1", _conv_transpose(p["ConvTranspose_0"]))
        _put(sd, f"{name}.ext_tconv1_bnorm", bn(2))
        _put(sd, f"{name}.ext_conv2.0", _conv(p["Conv_2"]))
        _put(sd, f"{name}.ext_conv2.1", bn(3))
        if "PReLU_0" in p:
            for j, act in enumerate(("ext_conv1.2", "ext_tconv1_activation",
                                     "ext_conv2.2", "out_activation")):
                _put(sd, f"{name}.{act}", _prelu(p[f"PReLU_{j}"]))
    _put(sd, "transposed_conv", _conv_transpose(params["ConvTranspose_0"]))
    return sd


def efficientunet_state_dict_from_flax(params, batch_stats) -> dict:
    """flax EffiUNet -> models.efficientunet.EffiUNet."""
    sd = {}
    ep, es = params["EfficientNetEncoder_0"], \
        batch_stats["EfficientNetEncoder_0"]
    _put(sd, "encoder.stem_conv", _conv(ep["Conv_0"]))
    _put(sd, "encoder.stem_bn", _bn(ep["BatchNorm_0"], es["BatchNorm_0"]))
    n = sum(1 for k in ep if k.startswith("MBConv_"))
    for i in range(n):
        p, s = ep[f"MBConv_{i}"], es[f"MBConv_{i}"]
        names = ("expand", "dw", "project") if "Conv_2" in p \
            else ("dw", "project")
        for j, name in enumerate(names):
            _put(sd, f"encoder.blocks.{i}.{name}_conv", _conv(p[f"Conv_{j}"]))
            _put(sd, f"encoder.blocks.{i}.{name}_bn",
                 _bn(p[f"BatchNorm_{j}"], s[f"BatchNorm_{j}"]))
        se = p["SqueezeExcite_0"]
        _put(sd, f"encoder.blocks.{i}.se.reduce", _conv(se["Conv_0"]))
        _put(sd, f"encoder.blocks.{i}.se.expand", _conv(se["Conv_1"]))
    stages = sum(1 for k in params if k.startswith("Conv_")) // 2
    for i in range(stages):
        for j in range(2):
            k = 2 * i + j
            _put(sd, f"decoder.{i}.conv{j + 1}", _conv(params[f"Conv_{k}"]))
            _put(sd, f"decoder.{i}.bn{j + 1}",
                 _bn(params[f"BatchNorm_{k}"], batch_stats[f"BatchNorm_{k}"]))
    _put(sd, "out_conv", _conv(params[f"Conv_{2 * stages}"]))
    return sd


def _dense(p):
    out = {"weight": _t(np.asarray(p["kernel"]).T)}
    if "bias" in p:
        out["bias"] = _t(p["bias"])
    return out


def _norm(p):
    """flax LayerNorm / GroupNorm (scale, bias) -> weight, bias."""
    return {"weight": _t(p["scale"]), "bias": _t(p["bias"])}


def _mha(p):
    """flax MultiHeadDotProductAttention -> query/key/value/out Linear:
    q/k/v kernels [hidden, heads, head_dim] (biases [heads, head_dim]),
    out kernel [heads, head_dim, hidden], heads-major as the port splits
    its projections."""
    sd = {}
    for name in ("query", "key", "value"):
        k = np.asarray(p[name]["kernel"])
        _put(sd, name, {"weight": _t(k.reshape(k.shape[0], -1).T),
                        "bias": _t(np.asarray(p[name]["bias"]).reshape(-1))})
    k = np.asarray(p["out"]["kernel"])
    _put(sd, "out", {"weight": _t(k.reshape(-1, k.shape[-1]).T),
                     "bias": _t(p["out"]["bias"])})
    return sd


def transunet_state_dict_from_flax(params, batch_stats,
                                   units=(3, 4, 9)) -> dict:
    """flax VisionTransformerSeg -> models.transunet.VisionTransformerSeg
    (its ResNet stem has ``units`` bottlenecks per stage)."""
    sd = {}
    rp = params["ResNetV2Stem_0"]
    _put(sd, "resnet.root_conv", _conv(rp["StdConv_0"]))
    _put(sd, "resnet.root_gn", _norm(rp["GroupNorm_0"]))
    i = 0
    for stage, n in enumerate(units):
        for u in range(n):
            p = rp[f"PreActBottleneck_{i}"]
            names = ("downsample", "conv1", "conv2", "conv3") \
                if "StdConv_3" in p else ("conv1", "conv2", "conv3")
            for j, name in enumerate(names):
                pre = f"resnet.stages.{stage}.{u}"
                gn = "gn_proj" if name == "downsample" else f"gn{name[-1]}"
                _put(sd, f"{pre}.{name}", _conv(p[f"StdConv_{j}"]))
                _put(sd, f"{pre}.{gn}", _norm(p[f"GroupNorm_{j}"]))
            i += 1
    _put(sd, "patch_embeddings", _conv(params["Conv_0"]))
    sd["pos_embedding"] = _t(params["pos_embedding"])
    n = sum(1 for k in params if k.startswith("TransformerBlock_"))
    for i in range(n):
        p = params[f"TransformerBlock_{i}"]
        _put(sd, f"layers.{i}.attention_norm", _norm(p["LayerNorm_0"]))
        _put(sd, f"layers.{i}.attn",
             _mha(p["MultiHeadDotProductAttention_0"]))
        _put(sd, f"layers.{i}.ffn_norm", _norm(p["LayerNorm_1"]))
        _put(sd, f"layers.{i}.fc1", _dense(p["Dense_0"]))
        _put(sd, f"layers.{i}.fc2", _dense(p["Dense_1"]))
    _put(sd, "encoder_norm", _norm(params["LayerNorm_0"]))
    _put(sd, "conv_more", _conv(params["Conv_1"]))
    _put(sd, "conv_more_bn", _bn(params["BatchNorm_0"],
                                 batch_stats["BatchNorm_0"]))
    n = sum(1 for k in params if k.startswith("DecoderBlock_"))
    for i in range(n):
        p, s = params[f"DecoderBlock_{i}"], batch_stats[f"DecoderBlock_{i}"]
        for j in range(2):
            _put(sd, f"blocks.{i}.conv{j + 1}", _conv(p[f"Conv_{j}"]))
            _put(sd, f"blocks.{i}.bn{j + 1}", _bn(p[f"BatchNorm_{j}"],
                                                 s[f"BatchNorm_{j}"]))
    _put(sd, "segmentation_head", _conv(params["Conv_2"]))
    return sd


def _swin_block(p, prefix, sd):
    _put(sd, f"{prefix}.norm1", _norm(p["LayerNorm_0"]))
    wa = p["WindowAttention_0"]
    _put(sd, f"{prefix}.attn.qkv", _dense(wa["Dense_0"]))
    _put(sd, f"{prefix}.attn.proj", _dense(wa["Dense_1"]))
    sd[f"{prefix}.attn.relative_position_bias_table"] = _t(
        wa["relative_position_bias_table"])
    _put(sd, f"{prefix}.norm2", _norm(p["LayerNorm_1"]))
    _put(sd, f"{prefix}.fc1", _dense(p["Dense_0"]))
    _put(sd, f"{prefix}.fc2", _dense(p["Dense_1"]))


def swin_unet_state_dict_from_flax(params, batch_stats=None) -> dict:
    """flax SwinUnet -> models.swin_unet.SwinUnet. The stages are the runs
    of SwinBlock_* of one width, in creation order: the encoder's, then
    the decoder's."""
    sd = {}
    ln = iter(f"LayerNorm_{i}" for i in range(
        sum(1 for k in params if k.startswith("LayerNorm_"))))
    _put(sd, "patch_embed", _conv(params["Conv_0"]))
    n_stages = sum(1 for k in params if k.startswith("PatchMerging_")) + 1
    if len([k for k in params if k.startswith("LayerNorm_")]) == 4:
        _put(sd, "patch_norm", _norm(params[next(ln)]))
    if "absolute_pos_embed" in params:
        sd["absolute_pos_embed"] = _t(params["absolute_pos_embed"])
    n_blocks = sum(1 for k in params if k.startswith("SwinBlock_"))
    widths = [np.asarray(params[f"SwinBlock_{i}"]["LayerNorm_0"]["scale"])
              .shape[0] for i in range(n_blocks)]
    runs = []                      # [first block, count] per stage
    for i, w in enumerate(widths):
        if i and w == widths[i - 1]:
            runs[-1][1] += 1
        else:
            runs.append([i, 1])
    for stage, (first, count) in enumerate(runs):
        kind, idx = ("layers", stage) if stage < n_stages \
            else ("layers_up", stage - n_stages)
        for b in range(count):
            _swin_block(params[f"SwinBlock_{first + b}"],
                        f"{kind}.{idx}.{b}", sd)
    for i in range(n_stages - 1):
        p = params[f"PatchMerging_{i}"]
        _put(sd, f"downsample.{i}.norm", _norm(p["LayerNorm_0"]))
        _put(sd, f"downsample.{i}.reduction", _dense(p["Dense_0"]))
        p = params[f"PatchExpand_{i}"]
        _put(sd, f"upsample.{i}.expand", _dense(p["Dense_0"]))
        _put(sd, f"upsample.{i}.norm", _norm(p["LayerNorm_0"]))
        _put(sd, f"concat_back_dim.{i}", _dense(params[f"Dense_{i}"]))
    _put(sd, "norm", _norm(params[next(ln)]))
    _put(sd, "norm_up", _norm(params[next(ln)]))
    _put(sd, "up.expand", _dense(params[f"Dense_{n_stages - 1}"]))
    _put(sd, "up.norm", _norm(params[next(ln)]))
    _put(sd, "output", _conv(params["Conv_1"]))
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


def _sequence(layers, sd, prefix=""):
    """(port name, converted layer) pairs into ``sd``; None layers skip."""
    for name, layer in layers:
        if layer is not None:
            _put(sd, prefix + name, layer)


def _nn_stack(p, prefix, sd):
    """A StackedConvLayers' ConvNormLRelu_j -> ``prefix``.blocks.j (conv
    and affine instnorm)."""
    for j in range(sum(1 for k in p if k.startswith("ConvNormLRelu_"))):
        b = p[f"ConvNormLRelu_{j}"]
        _put(sd, f"{prefix}.blocks.{j}.conv", _conv(b["Conv_0"]))
        _put(sd, f"{prefix}.blocks.{j}.instnorm",
             _norm(b["InstanceNormAffine_0"]))


def nnunet_state_dict_from_flax(params, batch_stats=None) -> dict:
    """flax GenericUNet (2D or 3D, any option) -> models.nnunet.GenericUNet
    (the reference's Generic_UNet names). The flax tree holds the context
    stages StackedConvLayers_0..n-1, the bottleneck's two (n, n + 1), each
    localization stage's two (n + 2 + 2u, n + 3 + 2u), ConvTranspose_u
    under convolutional upsampling, and the live heads Conv_i: every stage
    under deep supervision, else the finest; InstanceNorm holds no
    statistics."""
    sd = {}
    n = (sum(1 for k in params if k.startswith("StackedConvLayers_")) - 2) \
        // 3
    for d in range(n):
        _nn_stack(params[f"StackedConvLayers_{d}"],
                  f"conv_blocks_context.{d}", sd)
    for i in range(2):
        _nn_stack(params[f"StackedConvLayers_{n + i}"],
                  f"conv_blocks_context.{n}.{i}", sd)
    for u in range(n):
        if f"ConvTranspose_{u}" in params:
            _put(sd, f"tu.{u}", _conv_transpose(params[f"ConvTranspose_{u}"]))
        for i in range(2):
            _nn_stack(params[f"StackedConvLayers_{n + 2 + 2 * u + i}"],
                      f"conv_blocks_localization.{u}.{i}", sd)
    heads = sum(1 for k in params if k.startswith("Conv_"))
    for i in range(heads):
        _put(sd, f"seg_outputs.{i if heads == n else n - 1}",
             _conv(params[f"Conv_{i}"]))
    return sd


def voxresnet_state_dict_from_flax(params, batch_stats=None) -> dict:
    """flax VoxResNet -> models.voxresnet.VoxResNet (the reference names;
    inverse of torch_import_zoo's convert_voxresnet_state_dict)."""
    sd = {}
    _put(sd, "conv1", _conv(params["Conv_0"]))
    for r in range(6):
        for j, idx in enumerate((2, 5)):
            _put(sd, f"res{r + 1}.block.{idx}",
                 _conv(params[f"VoxRex_{r}"][f"Conv_{j}"]))
    for u in range(2):
        for j, idx in enumerate((2, 5)):
            _put(sd, f"up{u + 1}.conv.conv_conv.{idx}",
                 _conv(params[f"UpBlock_{u}"][f"Conv_{j}"]))
    _put(sd, "out", _conv(params["Conv_1"]))
    return sd


def _norms(params, batch_stats):
    """The BatchNorm_i of a tree in creation order, converted; endless
    Nones when it has none (instance or no norm: no state)."""
    i = 0
    while f"BatchNorm_{i}" in params:
        yield _bn(params[f"BatchNorm_{i}"], batch_stats[f"BatchNorm_{i}"])
        i += 1
    while True:
        yield None


def resnet_generator_state_dict_from_flax(params, batch_stats=None,
                                          use_dropout: bool = False) -> dict:
    """flax ResnetGenerator -> models.gan.ResnetGenerator (``model.{i}``,
    each ResnetBlock's ``conv_block.{i}``; a block's second conv sits one
    index later with ``use_dropout``, which the flax tree does not show)."""
    sd, bs = {}, batch_stats or {}
    norms = _norms(params, bs)
    seq = [("1", _conv(params["Conv_0"])), ("2", next(norms))]
    for i in range(2):
        seq += [(str(4 + 3 * i), _conv(params[f"Conv_{1 + i}"])),
                (str(5 + 3 * i), next(norms))]
    n = sum(1 for k in params if k.startswith("ResnetBlock_"))
    second = 6 if use_dropout else 5
    for b in range(n):
        p, s = params[f"ResnetBlock_{b}"], bs.get(f"ResnetBlock_{b}", {})
        bn = _norms(p, s)
        _sequence([("1", _conv(p["Conv_0"])), ("2", next(bn)),
                   (str(second), _conv(p["Conv_1"])),
                   (str(second + 1), next(bn))], sd,
                  f"model.{10 + b}.conv_block.")
    for i in range(2):
        seq += [(str(10 + n + 3 * i),
                 _conv_transpose(params[f"ConvTranspose_{i}"])),
                (str(11 + n + 3 * i), next(norms))]
    seq.append((str(17 + n), _conv(params["Conv_3"])))
    _sequence(seq, sd, "model.")
    return sd


def unet_generator_state_dict_from_flax(params, batch_stats=None) -> dict:
    """flax UnetGenerator -> models.gan.UnetGenerator (``down.{level}``,
    ``down_norm.{level}``, ``up.{level}``, ``up_norm.{level}``): the down
    convs Conv_0..L-1, the up convs ConvTranspose_0..L-1 innermost first,
    the norms in creation order (levels 1..L-2 down, then L-1..1 up)."""
    sd = {}
    levels = sum(1 for k in params if k.startswith("Conv_"))
    norms = _norms(params, batch_stats or {})
    for lv in range(levels):
        _put(sd, f"down.{lv}", _conv(params[f"Conv_{lv}"]))
    _sequence([(f"down_norm.{lv}", next(norms))
               for lv in range(1, levels - 1)], sd)
    for i, lv in enumerate(reversed(range(levels))):
        _put(sd, f"up.{lv}", _conv_transpose(params[f"ConvTranspose_{i}"]))
    _sequence([(f"up_norm.{lv}", next(norms))
               for lv in reversed(range(1, levels))], sd)
    return sd


def nlayer_discriminator_state_dict_from_flax(params,
                                              batch_stats=None) -> dict:
    """flax NLayerDiscriminator -> models.gan.NLayerDiscriminator
    (``model.{i}``, the reference's Sequential indices)."""
    sd = {}
    n_layers = sum(1 for k in params if k.startswith("Conv_")) - 2
    norms = _norms(params, batch_stats or {})
    seq = [("0", _conv(params["Conv_0"]))]
    for n in range(1, n_layers + 1):
        seq += [(str(2 + 3 * (n - 1)), _conv(params[f"Conv_{n}"])),
                (str(3 + 3 * (n - 1)), next(norms))]
    seq.append((str(2 + 3 * n_layers), _conv(params[f"Conv_{n_layers + 1}"])))
    _sequence(seq, sd, "model.")
    return sd


def _dense_from_nhwc_flatten(p, channels: int, spatial=None):
    """A flax Dense over an (h, w, c) flatten -> a Linear over torch's
    (c, h, w) flatten; ``spatial`` (h, w) defaults to a square map."""
    k = np.asarray(p["kernel"])                       # [h * w * c, out]
    hw = k.shape[0] // channels
    h, w = spatial or (int(round(hw ** 0.5)),) * 2
    if h * w * channels != k.shape[0]:
        raise ValueError(f"a Dense of {k.shape[0]} inputs is not an "
                         f"({h}, {w}, {channels}) flatten")
    wt = k.T.reshape(-1, h, w, channels).transpose(0, 3, 1, 2)
    return {"weight": _t(wt.reshape(wt.shape[0], -1)), "bias": _t(p["bias"])}


def discriminator_state_dict_from_flax(params, batch_stats=None,
                                       spatial=None) -> dict:
    """flax FC3DDiscriminator or FCDiscriminator -> the models.discriminator
    module (``conv0..4``, ``classifier``). The 2D classifier reads torch's
    (c, h, w) flatten of the pooled map, ``spatial`` (h, w) by default
    square; the 3D one the global mean."""
    sd = {}
    for i in range(5):
        _put(sd, f"conv{i}", _conv(params[f"Conv_{i}"]))
    k = np.asarray(params["Conv_4"]["kernel"])
    _put(sd, "classifier", _dense(params["Dense_0"]) if k.ndim == 5 else
         _dense_from_nhwc_flatten(params["Dense_0"], k.shape[-1], spatial))
    return sd


def vgg19_features_state_dict_from_flax(params, batch_stats=None) -> dict:
    """flax VGG19Features -> models.vgg.VGG19Features (torchvision's
    ``features.{i}``, the ReLUs and pools counted)."""
    from arco_torch.models.vgg import VGG19_CFG
    sd, ti, ci = {}, 0, 0
    for v in VGG19_CFG:
        if v == "M":
            ti += 1
            continue
        if f"Conv_{ci}" in params:      # the trunk stops at its last tap
            _put(sd, f"features.{ti}", _conv(params[f"Conv_{ci}"]))
        ti, ci = ti + 2, ci + 1
    return sd


def deepcluster_vgg16_state_dict_from_flax(params, batch_stats=None,
                                           spatial=None) -> dict:
    """flax DeepClusterVGG16 -> models.vgg.DeepClusterVGG16 (the
    reference's ``features.{i}``, ``classifier.{0,3}``, ``top_layer``; the
    first Linear permuted to torch's (c, h, w) flatten, ``spatial`` (h, w)
    of the trunk's map by default square)."""
    from arco_torch.models.vgg import VGG16_CFG
    sd, ti, ci = {}, 0, 0
    bn = "BatchNorm_0" in params
    for v in VGG16_CFG:
        if v == "M":
            ti += 1
            continue
        _put(sd, f"features.{ti}", _conv(params[f"Conv_{ci}"]))
        if bn:
            _put(sd, f"features.{ti + 1}", _bn(params[f"BatchNorm_{ci}"],
                                               batch_stats[f"BatchNorm_{ci}"]))
        ti, ci = ti + (3 if bn else 2), ci + 1
    _put(sd, "classifier.0",
         _dense_from_nhwc_flatten(params["Dense_0"], 512, spatial))
    _put(sd, "classifier.3", _dense(params["Dense_1"]))
    if "Dense_2" in params:
        _put(sd, "top_layer", _dense(params["Dense_2"]))
    return sd


def _resnet_trunk(p, s, layers_prefix=""):
    """A flax ResNetBackbone (conv1/bn1 as Conv_0/BatchNorm_0, then
    Bottleneck_{i} numbered across the four layers) -> the reference's
    ``conv1``, ``bn1``, ``layer{l}.{b}.*`` names; the blocks per layer are
    read from the conv shapes (a layer's first block is downsampled)."""
    sd = {}
    _put(sd, "conv1", _conv(p["Conv_0"]))
    _put(sd, "bn1", _bn(p["BatchNorm_0"], s["BatchNorm_0"]))
    n_blocks = sum(1 for k in p if k.startswith("Bottleneck_"))
    layer, b = 0, 0
    for i in range(n_blocks):
        bp, bs = p[f"Bottleneck_{i}"], s[f"Bottleneck_{i}"]
        if "Conv_3" in bp:
            layer, b = layer + 1, 0
        pre = f"layer{layer}.{b}"
        for j in range(3):
            _put(sd, f"{pre}.conv{j + 1}", _conv(bp[f"Conv_{j}"]))
            _put(sd, f"{pre}.bn{j + 1}",
                 _bn(bp[f"BatchNorm_{j}"], bs[f"BatchNorm_{j}"]))
        if "Conv_3" in bp:
            _put(sd, f"{pre}.downsample.0", _conv(bp["Conv_3"]))
            _put(sd, f"{pre}.downsample.1",
                 _bn(bp["BatchNorm_3"], bs["BatchNorm_3"]))
        b += 1
    return sd


def _conv_bn(sd, prefix, p, s, conv, bn, idx=(0, 1)):
    _put(sd, f"{prefix}.{idx[0]}", _conv(p[f"Conv_{conv}"]))
    _put(sd, f"{prefix}.{idx[1]}", _bn(p[f"BatchNorm_{bn}"],
                                       s[f"BatchNorm_{bn}"]))


def deeplab_state_dict_from_flax(params, batch_stats) -> dict:
    """flax DeepLabV2, DeepLab2Branch (``ClassifierModule_0``) or
    DeepLabV3Plus (``ASPP_0``) -> state_dict of models/deeplab.py (the
    reference's names)."""
    sd = _resnet_trunk(params["ResNetBackbone_0"],
                       batch_stats["ResNetBackbone_0"])
    if "ClassifierModule_0" in params:
        cls = params["ClassifierModule_0"]
        for j in range(sum(1 for k in cls if k.startswith("Conv_"))):
            _put(sd, f"layer5.conv2d_list.{j}", _conv(cls[f"Conv_{j}"]))
        return sd
    ap, as_ = params["ASPP_0"], batch_stats["ASPP_0"]
    n = sum(1 for k in ap if k.startswith("Conv_"))
    for j in range(n - 2):           # the 1x1 and the dilated branches
        _conv_bn(sd, f"ASPP.convs.{j}", ap, as_, j, j)
    _conv_bn(sd, f"ASPP.convs.{n - 2}", ap, as_, n - 2, n - 2, (1, 2))
    _conv_bn(sd, "ASPP.project", ap, as_, n - 1, n - 1)
    _conv_bn(sd, "project", params, batch_stats, 0, 0)
    for name, conv, bn in (("classifier", 1, 1), ("representation", 3, 2)):
        _conv_bn(sd, name, params, batch_stats, conv, bn)
        _put(sd, f"{name}.3", _conv(params[f"Conv_{conv + 1}"]))
    return sd


def _kernel_size(params):
    return np.asarray(params["Conv_0"]["kernel"]).shape[0]


# each flax model's tree -> its loader, in the order they are told apart
_LOADERS = (
    (lambda p: "ResNetBackbone_0" in p, deeplab_state_dict_from_flax),
    (lambda p: "VNetConvBlock_0" in p, vnet_state_dict_from_flax),
    (lambda p: "UnetConv3_0" in p, unet3d_state_dict_from_flax),
    (lambda p: "ConvBlockHAR_0" in p, unet_har_state_dict_from_flax),
    (lambda p: "BilinearUp_0" in p, unet_stego_state_dict_from_flax),
    (lambda p: "PNetBlock_0" in p, pnet_state_dict_from_flax),
    (lambda p: "InitialBlock_0" in p, enet_state_dict_from_flax),
    (lambda p: "EfficientNetEncoder_0" in p,
     efficientunet_state_dict_from_flax),
    (lambda p: "ResNetV2Stem_0" in p, transunet_state_dict_from_flax),
    (lambda p: "SwinBlock_0" in p, swin_unet_state_dict_from_flax),
    (lambda p: "Encoder_0" in p, unet_state_dict_from_flax),
    (lambda p: "StackedConvLayers_0" in p, nnunet_state_dict_from_flax),
    (lambda p: "VoxRex_0" in p, voxresnet_state_dict_from_flax),
    (lambda p: "ResnetBlock_0" in p, resnet_generator_state_dict_from_flax),
    (lambda p: "ConvTranspose_0" in p, unet_generator_state_dict_from_flax),
    # the rest are plain Conv_* (+ BatchNorm_*, Dense_*) trees: the
    # discriminators' 4x4 kernels, the VGGs' 3x3 ones
    (lambda p: "Dense_0" in p and _kernel_size(p) == 4,
     discriminator_state_dict_from_flax),
    (lambda p: "Dense_0" in p, deepcluster_vgg16_state_dict_from_flax),
    (lambda p: "Conv_0" in p and _kernel_size(p) == 4,
     nlayer_discriminator_state_dict_from_flax),
    (lambda p: "Conv_0" in p, vgg19_features_state_dict_from_flax))


def model_state_dict_from_flax(params, batch_stats, **kwargs) -> dict:
    """The model's state_dict, the model told apart by its flax tree: the
    U-Net family (UNet, UNetDS, UNetCCT, UNetURPC, UNetSTEGO, UNetHAR),
    PNet2D, ENet, EffiUNet, VisionTransformerSeg, SwinUnet, the V-Net, a
    3-D U-Net, nnU-Net (2D or 3D), VoxResNet, a DeepLab (v2, v3+ or
    2branch), the two generators,
    NLayerDiscriminator, the FC discriminators, VGG19Features or
    DeepClusterVGG16. ``kwargs`` go to the loader (ResnetGenerator's
    ``use_dropout``, the flatten ``spatial`` of FCDiscriminator and
    DeepClusterVGG16)."""
    for match, loader in _LOADERS:
        if match(params):
            return loader(params, batch_stats or {}, **kwargs)
    raise ValueError(f"no loader for a flax tree with {sorted(params)[:4]}")


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
