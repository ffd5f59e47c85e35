"""Single-device training step and epoch loop for the DL path.

The port of ``mmlspark_tpu/dl/train.py``'s single-device half: a
``TrainState``, the step built by ``make_train_step`` and the input loop
``train_epoch``. The JAX step is one jitted graph over a pytree of params
and an optax state; here the state holds an ``nn.Module`` (which carries
its parameters) and a ``torch.optim.Optimizer``, and the step runs eagerly:
forward, loss, ``backward``, ``optimizer.step()``. Kernel launches queue on
the device's stream, so the host returns from a step before the device
finishes it, as JAX's asynchronous dispatch does.

Not ported yet: the mesh half (``partition_train_state``,
``make_partitioned_train_step``, ``shard_train_state``, a ``mesh``
argument) with the parallel slice (item 10).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterable

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

LATER_MESH = ("sharded training over a mesh comes with the parallel slice "
              "(ROADMAP.md §1 item 10)")


@dataclasses.dataclass
class TrainState:
    """What one training run carries from step to step: the model (with its
    parameters), the optimizer (with its moments) and the step count. The
    JAX ``TrainState`` holds ``params``/``batch_stats``/``opt_state``
    pytrees apart from the module; here the module and the optimizer own
    them, and a step updates them in place."""
    model: nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy of integer ``labels`` under ``logits``."""
    logp = F.log_softmax(logits, dim=-1)
    return -logp.gather(-1, labels.long()[..., None])[..., 0].mean()


def make_train_step(model: nn.Module, optimizer: torch.optim.Optimizer,
                    loss_fn: Callable = softmax_xent, fetch: str = "logits",
                    mesh=None, accum_steps: int = 1) -> Callable:
    """Build a train step: ``(state, x, y) -> (state, loss)``. The loss is a
    0-d device tensor; nothing in the step waits for the device.
    ``model(x, train=True)`` may return a dict, whose ``fetch`` entry the
    loss reads. ``model`` and ``optimizer`` are the ones the ``state``
    passed to the step holds.

    ``accum_steps > 1``: the batch splits into that many microbatches, each
    runs forward and backward in turn (so only one microbatch's activations
    live at a time), their gradients are summed and divided by
    ``accum_steps``, and one optimizer update follows; the loss is the mean
    of the microbatch losses. The batch size must divide by
    ``accum_steps``. The JAX step does the same under one ``lax.scan``."""
    if mesh is not None:
        raise NotImplementedError(LATER_MESH)

    def loss_of(x, y):
        out = model(x, train=True)
        return loss_fn(out[fetch] if isinstance(out, dict) else out, y)

    def step(state: TrainState, x: torch.Tensor, y: torch.Tensor):
        if state.model is not model or state.optimizer is not optimizer:
            raise ValueError("the state holds another model or optimizer "
                             "than the step was built for")
        model.train()
        optimizer.zero_grad(set_to_none=True)
        if accum_steps <= 1:
            loss = loss_of(x, y)
            loss.backward()
        else:
            n = x.shape[0]
            if n % accum_steps:
                raise ValueError(f"batch size {n} must divide by "
                                 f"accum_steps={accum_steps}")
            loss = 0.0
            for xm, ym in zip(x.chunk(accum_steps), y.chunk(accum_steps)):
                loss_m = loss_of(xm, ym)
                loss_m.backward()       # the gradients add up in .grad
                loss = loss + loss_m.detach()
            inv = 1.0 / accum_steps
            for p in model.parameters():
                if p.grad is not None:
                    p.grad.mul_(inv)
            loss = loss * inv
        optimizer.step()
        state.step += 1
        return state, loss.detach()

    return step


def _to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host batch to ``device``: on CUDA through pinned memory with
    ``non_blocking=True``, so the copy is queued behind the running step and
    the host goes on."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def train_epoch(step: Callable, state: TrainState,
                batches: Iterable[tuple[np.ndarray, np.ndarray]],
                device: torch.device | str | None = None
                ) -> tuple[TrainState, list[float]]:
    """Drive ``step`` over host-resident ``(x, y)`` numpy batches. Batch
    i+1 is made on the host and queued to the device while step i runs
    there (the JAX loop overlaps its ``device_put`` with the dispatched
    step the same way). The losses are fetched once, at the end, so the
    loop never waits on a scalar. ``device`` defaults to the device of the
    model's first parameter. Returns ``(state, losses as floats)``."""
    if device is None:
        device = next(state.model.parameters()).device
    device = torch.device(device)
    losses: list[torch.Tensor] = []
    for x, y in batches:
        state, loss = step(state, _to_device(x, device),
                           _to_device(y, device))
        losses.append(loss)
    if not losses:
        return state, []
    return state, [float(v) for v in torch.stack(losses).float().cpu()]


def _later_mesh(*args: Any, **kwargs: Any):
    raise NotImplementedError(LATER_MESH)


partition_train_state = make_partitioned_train_step = shard_train_state = \
    _later_mesh
