"""Plain supervised trainer, CE + Dice (counterpart of
arco_tpu/train/supervised.py): the baseline slice of SURVEY §7.2 step 2,
and the backbone's throughput apart from ARCO's heads and losses.

PyTorch idiom: the state holds the model and its optimizer and is updated
in place; the step still returns ``(state, metrics)``, as JAX's does. The
model's train-mode dropout draws from the state's generator unless the
caller hands the step its keep-masks (``model.draw_dropout_masks``'s
layout), as the parity tests hand over JAX's.

With a ``mesh`` the step is data-parallel: each rank is handed its shard of
the batch (parallel.mesh.shard_batch) and computes what one process
computes over the whole batch, as JAX's step does under a batch sharding.
DDP's per-rank BatchNorm and its averaging of per-rank losses would not:
here the BatchNorm statistics, the cross-entropy's mean and the Dice's
whole-batch sums are reduced over the ranks (differentiably), and the
gradients are averaged.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch

from arco_torch import resolve_device
from arco_torch.losses.supervised import cross_entropy, dice_loss
from arco_torch.models.layers import sync_batch_norm
from arco_torch.parallel.mesh import average_gradients
from arco_torch.train.schedule import make_optimizer, poly_lr, set_lr


class PolySGD(NamedTuple):
    """The optimizer of JAX's ``make_optimizer(base_lr, max_iterations)``
    (train/schedule.py): SGD with momentum 0.9, nesterov, weight decay
    1e-4, at the poly LR of the update's step count."""
    base_lr: float
    max_iterations: int
    weight_decay: float = 1e-4
    momentum: float = 0.9
    nesterov: bool = True
    power: float = 0.9

    def init(self, params) -> torch.optim.SGD:
        return make_optimizer(params, self.base_lr, self.weight_decay,
                              self.momentum, self.nesterov)

    def lr(self, step: int) -> float:
        return poly_lr(self.base_lr, step, self.max_iterations, self.power)


@dataclass
class SupervisedState:
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    generator: torch.Generator
    step: int


def init_supervised_state(model: torch.nn.Module, tx: PolySGD,
                          seed: int = 0, device="cuda") -> SupervisedState:
    """Move ``model`` (its weights as built: seed the global torch RNG
    before building it) to ``device``; ``seed`` drives its dropout."""
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    model = model.to(device).train()
    return SupervisedState(model=model, optimizer=tx.init(model.parameters()),
                           generator=gen, step=0)


def make_supervised_step(model: torch.nn.Module, tx: PolySGD,
                         num_classes: int, mesh=None):
    """Returns step(state, batch, dropout_masks=None) -> (state, metrics)
    for the state of ``model``. batch: image [B, C, *S], label [B, *S]
    int (a rank's shard of them with a ``mesh``). metrics: loss, loss_ce,
    loss_dice (0-d tensors, of the whole batch). A ``mesh``'s batch axis is
    "data", as in JAX's batch sharding."""
    group = None if mesh is None else mesh.get_group("data")

    def step_fn(state: SupervisedState, batch, dropout_masks=None):
        device = next(model.parameters()).device
        image = torch.as_tensor(batch["image"]).to(device)
        label = torch.as_tensor(batch["label"]).to(device)
        model.train()
        with sync_batch_norm(model, group):
            logits, _, _ = model(image, dropout_masks, state.generator)
        logits = logits.movedim(1, -1).float()
        ce = cross_entropy(logits, label, group=group)
        dl = dice_loss(torch.softmax(logits, dim=-1), label, num_classes,
                       group=group)
        loss = ce + dl
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        if group is not None:
            average_gradients(model, group)
        set_lr(state.optimizer, tx.lr(state.step))
        state.optimizer.step()
        state.step += 1
        return state, {"loss": loss.detach(), "loss_ce": ce.detach(),
                       "loss_dice": dl.detach()}

    return step_fn


def make_predict_fn(model: torch.nn.Module, output: str = "argmax"):
    """Inference: [B, C, *S] -> argmax labels [B, *S] int32, or (any other
    ``output``) softmax probabilities [B, K, *S] f32."""

    @torch.no_grad()
    def predict(x):
        model.eval()
        logits, _, _ = model(x)
        probs = torch.softmax(logits.float(), dim=1)
        if output == "argmax":
            return probs.argmax(1).to(torch.int32)
        return probs

    return predict
