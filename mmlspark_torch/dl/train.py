"""Training step and epoch loop for the DL path, on one device or a mesh.

The port of ``mmlspark_tpu/dl/train.py``: a ``TrainState``, the step built
by ``make_train_step`` and the input loop ``train_epoch``, and the mesh
half (``shard_train_state``, ``partition_train_state``,
``make_partitioned_train_step``). The JAX step is one jitted graph over a
pytree of params and an optax state; here the state holds an ``nn.Module``
(which carries its parameters) and a ``torch.optim.Optimizer``, and the
step runs eagerly: forward, loss, ``backward``, ``optimizer.step()``. Kernel launches queue on
the device's stream, so the host returns from a step before the device
finishes it, as JAX's asynchronous dispatch does. The step goes through
``obs.compile_tracker`` as ``train_step``, as the JAX package's jitted step
does (a new input signature counts as a compile).

On a mesh (one process a rank, ``parallel.mesh``) the state's tensors are
placed by partition rules: each rank's model holds only its block of every
sharded parameter (and the optimizer its block of the moments), and
``state.shardings`` records the placements. A step takes the whole host
batch, keeps the rows of its ``dp`` coordinate (and with ``sp`` > 1 the
sequence block of its ``sp`` coordinate), all-gathers each sharded
parameter for the forward (the gather's backward is the reduce-scatter, so
a rank's gradient arrives for its block alone), runs attention on its
``tp`` share of the heads (``text_encoder.head_parallel``), and calls
``backward`` on its loss divided by the mesh's rank count: the
collectives' backwards are the exact transposes, so the ranks together
differentiate the mean of their losses, which is the batch's loss. A
parameter's gradient is then summed over every mesh axis that replicates
it, and the optimizer updates the blocks in place, so the placements hold
from step to step. Dense layers compute on the gathered weights; splitting
their products Megatron-style is a later optimisation.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterable

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..obs.profile import compile_tracker

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
    mesh: Any = None            # set when the state is placed on a mesh
    shardings: dict | None = None   # state path -> NamedSharding


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
    ``accum_steps``. The JAX step does the same under one ``lax.scan``.

    ``mesh``: the sharded step (module docstring) over the placements the
    state carries (``shard_train_state``; a state placed by no one is
    replicated, plain data parallelism), rows over ``dp``; each microbatch
    must still divide by ``dp``."""
    if mesh is not None:
        return _mesh_step(model, optimizer, mesh, None, loss_fn, fetch,
                          ("dp",), accum_steps, None, "train_step")

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

    return compile_tracker.track(step, name="train_step")


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




# ------------------------------------------------------------------ mesh
def _set_tensor(model: nn.Module, path: str, value, buffer: bool) -> None:
    """Replace the parameter (or buffer) at dotted ``path`` by ``value``."""
    owner, _, leaf = path.rpartition(".")
    mod = model.get_submodule(owner) if owner else model
    if buffer:
        mod._buffers[leaf] = value
    else:
        mod._parameters[leaf] = value


def _place_state(state: TrainState, mesh, specs: dict, dtype_policy=None
                 ) -> tuple[TrainState, dict]:
    """Put ``state`` on ``mesh`` in place: every parameter, buffer and
    optimizer moment becomes this rank's block under its spec (cast to
    the policy's storage dtype when floating); the optimizer is pointed at
    the new parameters. Returns the state and ``{path: NamedSharding}``."""
    from ..parallel.partition import local_block, sharding_of, state_tree
    tree = state_tree(state)
    shardings = {path: sharding_of(mesh, tuple(t.shape), specs[path])
                 for path, t in tree.items()}
    dev = torch.device("cuda", torch.cuda.current_device()) \
        if mesh.device_type == "cuda" else torch.device(mesh.device_type)

    def block(t, path):
        t = t.detach().to(dev)
        if dtype_policy is not None and dtype_policy.param_dtype and \
                t.is_floating_point():
            t = t.to(getattr(torch, dtype_policy.param_dtype))
        return local_block(t, shardings[path])

    model, opt = state.model, state.optimizer
    new_of = {}
    for name, p in list(model.named_parameters()):
        path = "params/" + name.replace(".", "/")
        new = nn.Parameter(block(p, path), requires_grad=p.requires_grad)
        new_of[p] = (new, name.replace(".", "/"))
        _set_tensor(model, name, new, buffer=False)
    for name, b in list(model.named_buffers()):
        _set_tensor(model, name, block(b, "buffers/" + name.replace(".", "/")),
                    buffer=True)
    for group in opt.param_groups:
        group["params"] = [new_of[p][0] for p in group["params"]]
    moved = {}
    for p, st in opt.state.items():
        new, name = new_of[p]
        moved[new] = {k: block(v, f"opt_state/{name}/{k}")
                      if f"opt_state/{name}/{k}" in shardings else v
                      for k, v in st.items()}
    opt.state.clear()
    opt.state.update(moved)
    state.mesh, state.shardings = mesh, shardings
    return state, shardings


def param_spec(leaf, tp_size: int) -> tuple:
    """The tensor-parallel heuristic of ``shard_train_state``: shard the
    output dim of a large weight (dim 0 of a torch ``[out, in, ...]``
    weight: the last dim of the flax ``[..., in, out]`` kernel the JAX
    heuristic shards) over ``tp``; replicate everything else."""
    shape = tuple(leaf.shape)
    if len(shape) >= 2 and shape[0] % tp_size == 0 \
            and shape[0] >= 2 * tp_size and leaf.numel() >= 4096:
        return ("tp",) + (None,) * (len(shape) - 1)
    return ()


def shard_train_state(state: TrainState, mesh) -> TrainState:
    """Place ``state`` on ``mesh`` by the :func:`param_spec` heuristic
    (large weights tp-sharded, the rest replicated; optimizer moments as
    their parameter), in place. The step of ``make_train_step(mesh=)``
    reads the placements from the state."""
    from ..parallel.mesh import as_mesh, axis_size
    from ..parallel.partition import state_tree
    mesh = as_mesh(mesh)
    tp = axis_size(mesh, "tp")
    specs = {path: param_spec(t, tp) if tp > 1 and path.startswith(
                 ("params/", "opt_state/")) else ()
             for path, t in state_tree(state).items()}
    return _place_state(state, mesh, specs)[0]


def partition_train_state(state: TrainState, mesh, rules, *,
                          dtype_policy=None, on_unmatched="replicate"):
    """Place ``state`` on ``mesh`` per a model's partition rules, in place.

    The rules match over the whole state: optimizer moments are named after
    their parameter (``opt_state/block0/qkv/weight/exp_avg``), so they sit
    with their weights; scalars (the step counts) replicate; buffers
    (BatchNorm statistics) need their own rules. ``dtype_policy`` casts the
    floating tensors to its storage dtype. Returns ``(state, shardings)``:
    pass the shardings to :func:`make_partitioned_train_step`."""
    from ..parallel.mesh import as_mesh
    from ..parallel.partition import match_partition_rules
    mesh = as_mesh(mesh)
    specs = match_partition_rules(rules, state, on_unmatched=on_unmatched)
    return _place_state(state, mesh, specs, dtype_policy)


def make_partitioned_train_step(model: nn.Module,
                                optimizer: torch.optim.Optimizer, mesh,
                                state_shardings: dict, *,
                                loss_fn: Callable = softmax_xent,
                                fetch: str = "logits",
                                batch_axes: tuple[str, ...] = ("dp",),
                                accum_steps: int = 1,
                                dtype_policy=None) -> Callable:
    """The step over a rule-placed state (:func:`partition_train_state`):
    the module docstring's sharded step with ``state_shardings``, batches
    over ``batch_axes``. ``dtype_policy``: float inputs cast to its compute
    dtype; with ``accum_steps > 1`` the gradients add up in its
    ``grad_accum_dtype``. On a one-rank mesh it computes what
    ``make_train_step`` does."""
    from ..parallel.mesh import as_mesh
    return _mesh_step(model, optimizer, as_mesh(mesh), state_shardings,
                      loss_fn, fetch, tuple(batch_axes), accum_steps,
                      dtype_policy, "partitioned_train_step")


def _mesh_world(mesh) -> int:
    from ..parallel.mesh import mesh_shape
    n = 1
    for s in mesh_shape(mesh).values():
        n *= s
    return n


def _rows(x: torch.Tensor, mesh, batch_axes, accum_steps: int):
    """This rank's rows of the whole batch ``x``: microbatch by microbatch
    (``[accum, m, ...]`` as the JAX step reshapes it), the block of its
    coordinate over ``batch_axes`` in each."""
    from ..parallel.mesh import axis_rank, axis_size
    n, r = 1, 0
    for a in batch_axes:
        r = r * axis_size(mesh, a) + axis_rank(mesh, a)
        n *= axis_size(mesh, a)
    B = x.shape[0]
    if B % accum_steps:
        raise ValueError(f"batch size {B} must divide by accum_steps="
                         f"{accum_steps}")
    m = B // accum_steps
    if m % n:
        raise ValueError(f"microbatch of {m} rows must divide by the batch "
                         f"axes {batch_axes} ({n} ranks)")
    mb = x.reshape(accum_steps, m, *x.shape[1:])
    return mb[:, r * (m // n):(r + 1) * (m // n)]


def _seq_block(x: torch.Tensor, mesh, T: int) -> torch.Tensor:
    """The ``sp`` block of dim 2 of a ``[accum, rows, T, ...]`` input."""
    from ..parallel.mesh import axis_rank, axis_size
    n = axis_size(mesh, "sp")
    if n <= 1 or x.dim() < 3 or x.shape[2] != T:
        return x
    if T % n:
        raise ValueError(f"sequence length {T} must divide by sp={n}")
    r = axis_rank(mesh, "sp")
    return x[:, :, r * (T // n):(r + 1) * (T // n)]


def _gathered(local: torch.Tensor, sharding) -> torch.Tensor:
    """The full parameter from this rank's block, differentiably (the
    backward reduce-scatters: a rank's gradient lands on its block)."""
    from torch.distributed.tensor import Shard
    from ..parallel.collectives import allgather
    from ..parallel.mesh import axis_group, axis_names
    full = local
    for a, pl in reversed(list(zip(axis_names(sharding.mesh),
                                   sharding.placements))):
        if isinstance(pl, Shard):
            full = allgather(full, axis_group(sharding.mesh, a),
                             gather_axis=pl.dim)
    return full


def _reduce_grads(model: nn.Module, shardings: dict | None, mesh) -> None:
    """Sum each parameter's gradient over the mesh axes that replicate it
    (one flat all-reduce per axis set and dtype)."""
    from torch.distributed.tensor import Replicate
    from ..parallel.collectives import allreduce
    from ..parallel.mesh import axis_group, axis_names, axis_size
    names = axis_names(mesh)
    buckets: dict = {}
    for name, p in model.named_parameters():
        sh = (shardings or {}).get("params/" + name.replace(".", "/"))
        axes = tuple(a for i, a in enumerate(names)
                     if axis_size(mesh, a) > 1 and (
                         sh is None or isinstance(sh.placements[i],
                                                  Replicate)))
        if not axes:
            continue
        if p.grad is None:
            p.grad = torch.zeros_like(p)
        buckets.setdefault((axes, p.grad.dtype), []).append(p)
    for (axes, _), params in buckets.items():
        flat = torch.cat([p.grad.reshape(-1) for p in params])
        for a in axes:
            flat = allreduce(flat, axis_group(mesh, a))
        at = 0
        for p in params:
            n = p.grad.numel()
            p.grad.copy_(flat[at:at + n].view_as(p.grad))
            at += n


def _mesh_step(model, optimizer, mesh, shardings, loss_fn, fetch,
               batch_axes, accum_steps, dtype_policy, name) -> Callable:
    """The sharded step (module docstring). ``shardings=None``: the state's
    own (``shard_train_state``)."""
    from torch.func import functional_call
    from ..parallel.collectives import allreduce
    from ..parallel.mesh import (as_mesh, axis_group, axis_names, axis_size,
                                 mesh_scope)
    from .text_encoder import seq_shard
    mesh = as_mesh(mesh)
    if axis_size(mesh, "sp") > 1 and not any(
            seq_shard(getattr(m, "attention_fn", None))
            for m in model.modules()):
        raise ValueError(
            "a mesh with sp > 1 shards the sequence: the model's attention "
            "must be a ring or Ulysses one over that mesh "
            "(make_attention_fn('ring_flash', mesh=...))")
    world = _mesh_world(mesh)
    accum_dtype = None
    if dtype_policy is not None and dtype_policy.grad_accum_dtype:
        accum_dtype = getattr(torch, dtype_policy.grad_accum_dtype)

    def loss_of(x, y, sharded):
        full = {n: _gathered(p, sh) for n, (p, sh) in sharded.items()}
        out = functional_call(model, full, (x,), {"train": True},
                              strict=False)
        return loss_fn(out[fetch] if isinstance(out, dict) else out, y)

    def step(state: TrainState, x: torch.Tensor, y: torch.Tensor):
        if state.model is not model or state.optimizer is not optimizer:
            raise ValueError("the state holds another model or optimizer "
                             "than the step was built for")
        placed = shardings if shardings is not None else state.shardings
        sharded = {}
        for pname, p in model.named_parameters():
            sh = (placed or {}).get("params/" + pname.replace(".", "/"))
            if sh is not None and any(e is not None for e in sh.spec):
                sharded[pname] = (p, sh)
        T = x.shape[1] if x.dim() >= 2 else None
        xs = _seq_block(_rows(x, mesh, batch_axes, accum_steps), mesh, T)
        ys = _seq_block(_rows(y, mesh, batch_axes, accum_steps), mesh, T)
        if dtype_policy is not None and xs.is_floating_point():
            xs = dtype_policy.cast_compute(xs)
        model.train()
        optimizer.zero_grad(set_to_none=True)
        acc = None
        loss = 0.0
        with mesh_scope(mesh):
            for i in range(accum_steps):
                loss_i = loss_of(xs[i], ys[i], sharded)
                (loss_i / (world * accum_steps)).backward()
                loss = loss + loss_i.detach()
                if accum_dtype is not None and accum_steps > 1:
                    ps = [p for p in model.parameters()
                          if p.grad is not None]
                    if acc is None:
                        acc = {p: torch.zeros_like(p, dtype=accum_dtype)
                               if p.is_floating_point() else None
                               for p in ps}
                    for p in ps:
                        if acc.get(p) is not None:
                            acc[p] += p.grad.to(accum_dtype)
                            p.grad = None
            if acc is not None:
                for p, a in acc.items():
                    if a is not None:
                        p.grad = a.to(p.dtype)
            _reduce_grads(model, placed, mesh)
        optimizer.step()
        state.step += 1
        loss = loss / accum_steps
        for a in axis_names(mesh):
            loss = allreduce(loss, axis_group(mesh, a))
        return state, loss / world

    return compile_tracker.track(step, name=name)
