"""Configuration of the port (counterpart of arco_tpu/config.py).

A copy, not an import, of the JAX package's config tree and its CLI parser:
the same field names and defaults, so a recipe's flags mean the same in
both packages (reference: code/train_arco_2d.py:26-89). Fields that only
the JAX package reads (the Pallas InfoNCE choice and tile, the device mesh)
are kept so the dataclasses stay interchangeable. The port adds one field,
``TrainConfig.device``: its entry points take the card unless told
otherwise.
"""

from __future__ import annotations

import argparse
import dataclasses
from dataclasses import dataclass, field
from typing import List, Optional, Tuple


# Label-budget maps: patients -> number of labeled 2D slices
# (code/train_arco_2d.py:91-106).
PATIENTS_TO_SLICES = {
    "ACDC": {"1": 23, "3": 68, "7": 136, "14": 256, "21": 396,
             "28": 512, "35": 664, "140": 1312},
    "MM": {"1": 38, "2": 76, "5": 191, "10": 382, "100": 3823},
    "Syn": {"1": 44, "3": 66, "5": 111, "10": 221, "100": 2211},
    "Lits": {"1": 167, "5": 835, "10": 1668, "20": 3336, "50": 8340,
             "100": 16684},
    "JHU": {"1": 57, "5": 275, "10": 568, "100": 5675},
}


def patients_to_slices(dataset: str, patients_num: int) -> int:
    """Map a patient budget to a labeled-slice count (train_arco_2d.py:91)."""
    key = str(patients_num)
    if "ACDC" in dataset:
        return PATIENTS_TO_SLICES["ACDC"][key]
    if "MM" in dataset:
        return PATIENTS_TO_SLICES["MM"][key]
    if "Syn" in dataset or "syn" in dataset:
        return PATIENTS_TO_SLICES["Syn"][key]
    if "Lits" in dataset or "LiTS" in dataset:
        return PATIENTS_TO_SLICES["Lits"][key]
    if "jhu" in dataset or "JHU" in dataset:
        return PATIENTS_TO_SLICES["JHU"][key]
    raise ValueError(f"unknown dataset for label budget: {dataset}")


@dataclass
class DataConfig:
    root_path: str = "../data/ACDC"
    exp: str = "ACDC/example_training"
    patch_size: Tuple[int, ...] = (256, 256)
    num_classes: int = 4
    labeled_num: int = 7
    labeled_bs: int = 2
    batch_size: int = 4
    in_channels: int = 1
    # 3D (LA) path: patch [112,112,80] (train_arco_3d.py:41)
    list_dir: Optional[str] = None
    # stage the training slices on the card once and draw each batch with
    # one gather there (data/device_bank.py): per step only the [B, 5]
    # transform parameters cross from the host. The batches are the host
    # pipeline's, bit for bit; slices that are not square at the output
    # size fall back to the host pipeline.
    device_data: bool = True


@dataclass
class OptimConfig:
    base_lr: float = 0.01
    weight_decay: float = 1e-4
    momentum: float = 0.9
    nesterov: bool = True
    poly_power: float = 0.9
    max_iterations: int = 30000


@dataclass
class ArcoConfig:
    """Stage-2 ARCO method hyper-parameters (train_arco_2d.py:56-89)."""
    strong_threshold: float = 0.97
    # beyond-parity: FixMatch-style confidence masking of the unsup CE
    # (losses/consistency.py docstring) — the reference formula trains ALL
    # valid pixels at a scalar weight, which is the sole collapsing term
    # of the 3D gates in noise-dominated regimes; default False keeps
    # reference semantics
    unsup_conf_mask: bool = False
    strong_threshold_u2pl: float = 0.97
    weak_threshold: float = 0.7
    temp: float = 0.5
    num_negatives: int = 512
    num_queries: int = 256
    apply_aug: str = "cutmix"        # cutout | cutmix | classmix
    K: int = 36                      # revisiting random-pool size
    k1: float = 0.01                 # contrastive (reco) loss weight
    k2: float = 1.0                  # eqv loss weight
    k3: float = 1.0                  # unsup loss weight
    k4: float = 1.0                  # revisiting (nn) loss weight
    k5: float = 1.0
    topk: int = 5
    func: str = "smc"                # smc | asmc | uniform
    tps_sigma: float = 0.01
    # memory bank: per-class capacity; class 0 gets 50k (train_arco_2d.py:147-154)
    memobank_size: int = 30000
    memobank_size_bg: int = 50000
    # max teacher keys enqueued per class per step (static-shape rebuild knob;
    # the reference enqueues a variable number — see losses/contrastive.py)
    memobank_enqueue: int = 256
    # per-class bank init row: 'zeros' (train_arco_2d.py:152) or 'randn'
    # (train_arco_3d.py:149) — the row is every negative until real keys
    # arrive, and on 2-class LA it stays so for the whole run (the
    # degenerate-reco quirk; see losses.contrastive.create_memobank)
    memobank_init: str = "zeros"
    # --- trajectory-parity ablation knobs (VERDICT r3 item 3): re-add the
    # reference's intentional-delta behaviors one at a time to attribute the
    # rebuild's Dice dominance at matched budgets ---
    # re-add the dead 6th student forward on the labeled batch
    # (train_arco_2d.py:311 model(images_cj2_l): its outputs are unused, but
    # in train mode it advances BatchNorm running statistics — NOT dead for
    # eval, which runs on running stats)
    dead_forward: bool = False
    # quantize augmented images/logits to uint8 granularity, replicating the
    # reference's PIL round-trip (augment.py:255-281 tensor->PIL->tensor:
    # every augmented image and confidence map is floor-quantized to 1/255)
    quantize_augs: bool = False
    # JAX-only: the port always takes the kernel path (the JAX 'pallas'
    # choice) and ignores infonce_impl and pallas_tile
    infonce_impl: str = "xla"
    pallas_tile: int = 2000
    low_rank: int = 3
    high_rank: int = 20
    current_class_threshold: float = 0.3
    # eqv loss participates in the 2D total but not the 3D one
    # (train_arco_3d.py:390-391); flag-gated instead of silently dropped.
    use_eqv_loss: bool = True
    # whether to run the TPS-equivariance forward at all (the 3D reference
    # computes it only for logging; skipping saves one forward)
    compute_eqv: bool = True
    # compute the logging-only eqv term only on logging iterations instead
    # of every step. Applies only when compute_eqv is on and use_eqv_loss is
    # off (the 3D path): measured 767 -> ~435 ms/step on chip, because the
    # eqv leg (slice-wise 3D TPS gather + 6th V-Net forward) costs ~43% of
    # the step to produce a scalar the total loss never sees. The dataclass
    # default stays False (2D keeps eqv in the loss), but the 3D CLI turns
    # it ON: the every-step forward's only training effect is a BN-stat
    # nudge, and the paired 3-seed measurement (ref_parity/
    # trajectory_3d_arco_noeqv.json) shows that nudge hurts end Dice on
    # all three seeds. --arco.eqv_on_log_only false restores every-step
    # reference parity.
    eqv_on_log_only: bool = False
    # 2D strong augmentation (color jitter + blur + AdvMorph); the 3D
    # reference's batch_transform is a passthrough (augment_3d.py:209-226)
    use_photometric: bool = True
    use_adv_morph: bool = True
    # AdvMorph field exponentiation on the coarse lattice (fast,
    # distributionally-equivalent default; ~35% pointwise deviation from the
    # reference's full-resolution scaling-and-squaring). Set False
    # (--arco.morph_coarse_exp 0) for reference-exact deformations.
    morph_coarse_exp: bool = True
    # ablations (reference --combinations: 0 all, 1 no reco, 2 no unsup,
    # train_arco_2d.py:76) + perf-bisect toggles
    compute_contrastive: bool = True
    compute_unsup: bool = True
    compute_revisit: bool = True
    use_entropy_split: bool = True
    # O(n) histogram percentile instead of a device sort for the entropy
    # split (see arco2d.masked_percentiles_histogram)
    fast_percentile: bool = False
    # rematerialize the student forwards that carry a gradient
    # (torch.utils.checkpoint; jax.checkpoint in JAX): trades FLOPs for
    # device memory — useful for the 3D path where 5 V-Net forwards at
    # [112,112,80] are activation-memory-bound (SURVEY §7.3 hard part #4)
    remat: bool = False


@dataclass
class ISDConfig:
    """Stage-1 self-distillation wrapper (model_2D.py:115, pretrain_2D.py)."""
    K: int = 36                      # queue length
    m: float = 0.99                  # EMA momentum
    # effective reference defaults are the pretrain scripts' argparse values
    # T_s = T_t = 0.1 (pretrain_2D.py:80-81, pretrain_3D.py:80-81)
    Ts: float = 0.1                  # student temperature
    Tt: float = 0.1                  # teacher temperature
    latent_pooling_size: int = 1
    latent_feature_size: int = 512
    output_pooling_size: int = 8
    patch_size: int = 64             # contrastive patch grid window
    k1: float = 1.0                  # latent KLD weight
    k2: float = 1.0                  # output KLD weight
    # weak/strong combo id (pretrain_2D.py:210); the stage-2 CLI reads it
    # as the reference's ablation flag: 1 no reco, 2 no unsup
    combinations: int = 0
    # freeze surface (pretrain_2D.py:71-72)
    train_encoder: bool = True
    train_decoder: bool = True


@dataclass
class TrainConfig:
    data: DataConfig = field(default_factory=DataConfig)
    optim: OptimConfig = field(default_factory=OptimConfig)
    isd: ISDConfig = field(default_factory=ISDConfig)
    arco: ArcoConfig = field(default_factory=ArcoConfig)
    model: str = "unet"
    exp: str = "ACDC/example_training"
    seed: int = 1337
    deterministic: bool = True
    consistency: float = 0.1
    consistency_rampup: float = 200.0
    snapshot_dir: str = "../model"
    resume: str = ""                 # stage-1 checkpoint experiment name
    # local pretrained checkpoint for the zoo backbones (ViT .npz, Swin and
    # EfficientNet .pth; compat/pretrained.py); the 3D CLIs ignore it
    pretrained_path: str = ""
    ckpt_every: int = 1000
    # rolling full-state (optimizer, EMA, generator) checkpoint cadence for
    # crash resume; 0 = same as ckpt_every
    full_ckpt_every: int = 0
    log_every: int = 20
    # model compute dtype under autocast; parameters stay f32
    compute_dtype: str = "bfloat16"
    # JAX-only: the device mesh of the JAX trainers; the port runs on one
    # card and ignores both
    mesh_shape: Tuple[int, ...] = (-1,)
    mesh_axes: Tuple[str, ...] = ("data",)
    # the port only: the torch device of the entry points
    device: str = "cuda"


def _add_dataclass_args(parser: argparse.ArgumentParser, cfg,
                        prefix: str = ""):
    for f in dataclasses.fields(cfg):
        val = getattr(cfg, f.name)
        if dataclasses.is_dataclass(val):
            _add_dataclass_args(parser, val, prefix=f"{prefix}{f.name}.")
            continue
        name = f"--{prefix}{f.name}"
        if isinstance(val, bool):
            parser.add_argument(
                name, type=lambda v: v.lower() in ("1", "true", "yes"),
                default=val)
        elif isinstance(val, tuple):
            parser.add_argument(name, type=int, nargs="+", default=list(val))
        elif val is None:
            parser.add_argument(name, type=str, default=None)
        else:
            parser.add_argument(name, type=type(val), default=val)


def _assign(cfg, key: str, value):
    parts = key.split(".")
    obj = cfg
    for p in parts[:-1]:
        obj = getattr(obj, p)
    f = parts[-1]
    cur = getattr(obj, f)
    if isinstance(cur, tuple) and isinstance(value, list):
        value = tuple(value)
    setattr(obj, f, value)


# Flat reference flag name -> dotted config path, for 1:1 CLI parity with
# the reference argparse blocks (train_arco_2d.py:26-89).
REFERENCE_FLAG_MAP = {
    "root_path": "data.root_path",
    "exp": "exp",
    "model": "model",
    "max_iterations": "optim.max_iterations",
    "batch_size": "data.batch_size",
    "base_lr": "optim.base_lr",
    "patch_size": "data.patch_size",
    "seed": "seed",
    "num_classes": "data.num_classes",
    "labeled_bs": "data.labeled_bs",
    "labeled_num": "data.labeled_num",
    "strong_threshold": "arco.strong_threshold",
    "strong_threshold_u2pl": "arco.strong_threshold_u2pl",
    "weak_threshold": "arco.weak_threshold",
    "temp": "arco.temp",
    "num_negatives": "arco.num_negatives",
    "num_queries": "arco.num_queries",
    "apply_aug": "arco.apply_aug",
    "resume": "resume",
    "K": "arco.K",
    "k1": "arco.k1",
    "k2": "arco.k2",
    "k3": "arco.k3",
    "k4": "arco.k4",
    "k5": "arco.k5",
    "topk": "arco.topk",
    "latent_pooling_size": "isd.latent_pooling_size",
    "latent_feature_size": "isd.latent_feature_size",
    "output_pooling_size": "isd.output_pooling_size",
    # pretrain-only reference flags (pretrain_2D.py:80-82)
    "T_s": "isd.Ts",
    "T_t": "isd.Tt",
    "cut_size": "isd.patch_size",
    "train_encoder": "isd.train_encoder",
    "train_decoder": "isd.train_decoder",
    "func": "arco.func",
    "tps_sigma": "arco.tps_sigma",
    "consistency": "consistency",
    "consistency_rampup": "consistency_rampup",
    "deterministic": "deterministic",
}


def parse_args(argv: Optional[List[str]] = None,
               base: Optional[TrainConfig] = None) -> TrainConfig:
    """Parse CLI flags into a TrainConfig: dotted config paths
    (--optim.base_lr) and the flat reference flag names (--base_lr)."""
    cfg = base or TrainConfig()
    parser = argparse.ArgumentParser()
    _add_dataclass_args(parser, cfg)
    for flat, dotted in REFERENCE_FLAG_MAP.items():
        if flat != dotted and f"--{flat}" not in parser._option_string_actions:
            obj = cfg
            parts = dotted.split(".")
            for p in parts[:-1]:
                obj = getattr(obj, p)
            val = getattr(obj, parts[-1])
            if isinstance(val, bool):
                parser.add_argument(
                    f"--{flat}", dest=f"alias_{flat}",
                    type=lambda v: v.lower() in ("1", "true", "yes"),
                    default=None)
            elif isinstance(val, tuple):
                parser.add_argument(f"--{flat}", dest=f"alias_{flat}",
                                    type=int, nargs="+", default=None)
            else:
                parser.add_argument(f"--{flat}", dest=f"alias_{flat}",
                                    type=type(val), default=None)
    ns = parser.parse_args(argv)
    for k, v in vars(ns).items():
        if k.startswith("alias_"):
            continue
        _assign(cfg, k, v)
    for flat, dotted in REFERENCE_FLAG_MAP.items():
        v = getattr(ns, f"alias_{flat}", None)
        if v is not None:
            _assign(cfg, dotted, v)
    return cfg
