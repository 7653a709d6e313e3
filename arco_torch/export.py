"""Ahead-of-time model export for serving, as a ``torch.export`` program
(counterpart of arco_tpu/export.py).

The reference's deployment stops at ``torch.save(state_dict)`` plus
re-importing the model-zoo code to rebuild the module before inference
(test_2D.py:117-122, test.py:197-205). Here the artifact is a
``torch.export.ExportedProgram`` saved with ``torch.export.save``: the
traced graph of ATen operations together with its weights and its calling
convention. A serving process loads it with ``torch.export.load`` and runs
it WITHOUT the arco_torch model code and without a checkpoint.

- **Self-contained**: one file holds the architecture, the weights and the
  input signature.
- **One artifact, either device**: JAX bakes lowerings for several
  platforms (``platforms=``). Its counterpart here is
  ``load_predictor(path, device=...)``, which moves the program's weights
  and device-bound operations with ``move_to_device_pass``, so an artifact
  traced on the CPU serves on the card and one traced on the card serves
  on the CPU. There is no ``platforms`` argument.
- **Optionally batch-polymorphic**: ``batch="dynamic"`` exports a symbolic
  batch dimension (``torch.export.Dim``, up to 65535), so one artifact
  serves any request batch size.

Typical flow::

    ep = export_predictor(model, input_shape=(8, 1, 256, 256))
    save_predictor("unet_acdc.pt2", ep)
    # ... on the serving host (only torch required):
    predict = load_predictor("unet_acdc.pt2")
    seg = predict(x)          # [8, 256, 256] int32 argmax labels

CLI: ``python -m arco_torch.cli.export_model --exp ... --iteration 30000``.
"""

from __future__ import annotations

import copy
from typing import Callable, Sequence

import torch

from arco_torch import resolve_device

OUTPUTS = ("argmax", "softmax", "logits")


class _Predictor(torch.nn.Module):
    """The exported forward: the input cast to ``dtype``, the model in
    eval mode at its own parameter dtype, the logits head (the zoo's
    forward contract is (logits, latent, feature_maps),
    unetWithArgs.py:345-348) in f32, then ``output``."""

    def __init__(self, model: torch.nn.Module, output: str, dtype):
        super().__init__()
        if output not in OUTPUTS:
            raise ValueError(f"output must be one of {OUTPUTS}, got "
                             f"{output!r}")
        self.model = model.eval()
        self.output = output
        self.dtype = dtype
        self.param_dtype = next(model.parameters()).dtype

    def forward(self, x):
        logits = self.model(x.to(self.dtype).to(self.param_dtype))[0]
        logits = logits.float()
        if self.output == "argmax":
            return logits.argmax(1).to(torch.int32)
        if self.output == "softmax":
            return torch.softmax(logits, dim=1)
        return logits


def make_predict_fn(model: torch.nn.Module, output: str = "argmax",
                    dtype=torch.float32) -> Callable:
    """The eager inference function that the artifact exports:
    [B, C, *S] -> argmax labels [B, *S] int32, softmax [B, K, *S] or logits
    [B, K, *S] (f32). ``dtype`` is the artifact's input dtype: the input
    is cast to it first, so ``torch.bfloat16`` yields a genuinely bf16-in
    program (the model still computes in its own dtype, as JAX's does)."""
    return torch.no_grad()(_Predictor(model, output, dtype))


def export_predictor(model: torch.nn.Module, input_shape: Sequence[int], *,
                     output: str = "argmax", batch: str = "static",
                     dtype=torch.float32, device="cuda"):
    """Trace the predictor of a copy of ``model`` on ``device`` into a
    serializable ``torch.export.ExportedProgram``.

    input_shape: ``[B, C, *spatial]``. With ``batch="dynamic"`` the leading
    dimension is exported symbolically (any B up to 65535 at call time).
    torch specializes a dimension whose example size is 0 or 1, so a
    dynamic export traces at a batch of at least 2, whatever
    ``input_shape[0]`` says.
    """
    if batch not in ("static", "dynamic"):
        raise ValueError(f"batch must be 'static' or 'dynamic', got "
                         f"{batch!r}")
    device = resolve_device(device)
    module = _Predictor(copy.deepcopy(model).to(device), output, dtype)
    shape = tuple(input_shape)
    dynamic_shapes = None
    if batch == "dynamic":
        shape = (max(shape[0], 2),) + shape[1:]
        # traced on the card, torch guards the batch at <= 65535 (a CUDA
        # kernel's limit in the graph) and refuses an unbounded Dim; the
        # same cap on every device keeps one artifact servable on either
        dynamic_shapes = ({0: torch.export.Dim("batch", max=65535)},)
    example = torch.zeros(shape, dtype=dtype, device=device)
    with torch.no_grad():
        return torch.export.export(module, (example,),
                                   dynamic_shapes=dynamic_shapes)


def save_predictor(path: str, exported) -> None:
    torch.export.save(exported, path)


def input_spec(exported):
    """(shape, dtype) of the program's input; a symbolic dimension is a
    ``torch.SymInt``."""
    names = set(exported.graph_signature.user_inputs)
    for node in exported.graph.nodes:
        if node.op == "placeholder" and node.name in names:
            val = node.meta["val"]
            return tuple(val.shape), val.dtype
    raise ValueError("the exported program takes no input")


def load_predictor(path: str, device=None) -> Callable:
    """Load an artifact and return ``predict(x) -> tensor``. Given a
    ``device``, the program is moved there first (``move_to_device_pass``).

    Needs only torch on the serving host: no arco_torch model code and no
    checkpoint files.
    """
    exported = torch.export.load(path)
    if device is not None:
        from torch.export.passes import move_to_device_pass
        exported = move_to_device_pass(exported, torch.device(device))
    shape, dtype = input_spec(exported)
    weight = next(iter(exported.state_dict.values()))
    module = exported.module()

    def predict(x):
        x = torch.as_tensor(x).to(device=weight.device, dtype=dtype)
        # symbolic batch dims are SymInts; check the static ones
        static_ok = all(not isinstance(want, int) or got == want
                        for got, want in zip(x.shape, shape))
        if x.ndim != len(shape) or not static_ok:
            raise ValueError(
                f"input shape {tuple(x.shape)} does not match the exported "
                f"calling convention {shape}")
        with torch.no_grad():
            return module(x)

    predict.exported = exported
    return predict
