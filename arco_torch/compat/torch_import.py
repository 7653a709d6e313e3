"""Partial restore of a local torch checkpoint into a port model (the
``--restore_from`` of the natural-image trainer).

The semantics of arco_tpu/compat/torch_import.py:convert_deeplab_state_dict
plus merge_params (:325-340) and of the reference's model_factory.py:55-60:
the file's ``module.`` prefixes (a DataParallel save) are stripped, and a
tensor is copied where the model has a tensor of the same name and shape;
everything else keeps the model's initialization (a classifier of another
class count, a trunk without ``layer5``). The port's models keep the
reference's parameter names, so no renaming is needed.
"""

from __future__ import annotations

import torch


@torch.no_grad()
def load_partial_state_dict(model: torch.nn.Module, sd: dict) -> list:
    """Copy into ``model`` every tensor of the state dict ``sd`` whose name
    (after stripping ``module.``) and shape match one of the model's;
    return the names copied. BatchNorm batch counters are not copied (the
    JAX importer carries none)."""
    sd = {k.replace("module.", ""): v for k, v in sd.items()}
    own = model.state_dict()
    copied = []
    for name, dst in own.items():
        src = sd.get(name)
        if name.endswith("num_batches_tracked") or src is None \
                or tuple(src.shape) != tuple(dst.shape):
            continue
        dst.copy_(src.to(dst.dtype))
        copied.append(name)
    return copied


def load_torch_checkpoint(model: torch.nn.Module, path: str) -> list:
    """``load_partial_state_dict`` of the checkpoint file at ``path``."""
    return load_partial_state_dict(
        model, torch.load(path, map_location="cpu", weights_only=True))
