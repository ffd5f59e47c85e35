"""Partition-rule engine: regex rules over named parameters → placements.

The port of ``mmlspark_tpu/parallel/partition.py``. A model ships a small
ordered list of ``(regex, spec)`` rules instead of annotating every tensor,
and the engine walks any tree of named tensors: a module's ``state_dict``, a
``dl.train.TrainState`` (its model's parameters and buffers and its
optimizer's moments, named after their parameter, so the same rules match
``opt_state/block0/qkv/weight/exp_avg``), a nested dict, or anything else
with string-keyed paths.

Semantics are the JAX package's:

- **first match wins** — rules are ordered, ``re.search`` over the
  ``/``-joined path;
- **scalars replicate** — 0-d and single-element leaves match no rule;
- **specs are right-aligned** — ``("tp",)`` places ``tp`` on the last dim;
- **unmatched leaves replicate loudly** — a warning per path and
  ``parallel_unmatched_leaves_total``; ``on_unmatched="error"`` raises;
- matched rules count in ``parallel_rule_match_total{rule=...}``.

Paths are the port's own names (``block0/qkv/weight``; a torch ``Linear``
weight is ``[out, in]`` where a flax kernel is ``[in, out]``), and each rule
set registered next to a port model gives the layout the JAX package's rule
gives the converted weight: the flax ``qkv/kernel (None, "tp")`` is the
port's ``qkv/weight ("tp", None)``.

A spec becomes a :class:`NamedSharding`, whose ``placements`` (one
``Shard(d)`` or ``Replicate()`` per mesh dim) are what a ``DTensor``
carries; a spec that names an axis the mesh lacks, or a dim the axis does
not divide, is demoted to replication with a warning and
``parallel_spec_demoted_total{axis}``. :func:`shard_params` places a tree as
``DTensor`` s, each rank slicing its block of the full value every rank
holds (seeded init: the multi-process contract), and :func:`gather_params`
brings the full values back to the host. The dtype half of the decision,
:class:`DtypePolicy`, lives here too.

This module imports no torch at module scope: rule sets register when a
model's module is imported, and a spec is a plain tuple.
"""

from __future__ import annotations

import dataclasses
import re
import warnings
from typing import Any, Sequence

from ..obs import registry as _obs

_m_rule_match = _obs.counter(
    "parallel_rule_match_total",
    "partition-rule hits while matching param trees, by rule pattern")
_m_unmatched = _obs.counter(
    "parallel_unmatched_leaves_total",
    "param leaves no partition rule matched (loud replicated fallback)")
_m_demoted = _obs.counter(
    "parallel_spec_demoted_total",
    "matched specs demoted to fewer axes because a dim does not divide "
    "the mesh axis, by axis")

# rule: (regex over the /-joined leaf path, spec entries right-aligned to
# the leaf's trailing dims; each entry None | axis name | tuple of names)
PartitionRule = tuple[str, tuple]


def _torch_dtype(name: str):
    import torch
    dtype = getattr(torch, name, None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"unknown dtype name {name!r}")
    return dtype


@dataclasses.dataclass(frozen=True)
class DtypePolicy:
    """Param / compute / grad-accumulation dtypes, named as strings
    (``"float32"``, ``"bfloat16"``) so the policy is constructible with no
    torch import. ``None`` entries mean "leave as is". Casts apply to
    floating leaves only: integer ids, bool masks and step counts pass
    through untouched."""
    param_dtype: str | None = "float32"
    compute_dtype: str | None = "bfloat16"
    grad_accum_dtype: str | None = "float32"

    def _cast(self, tree, dtype_name: str | None):
        if dtype_name is None:
            return tree
        import torch
        dtype = _torch_dtype(dtype_name)

        def one(leaf):
            t = leaf if isinstance(leaf, torch.Tensor) else \
                torch.as_tensor(leaf)
            return t.to(dtype) if t.is_floating_point() else t
        return _tree_map(one, tree)

    def cast_params(self, tree):
        """Storage dtype for parameters (and optimizer moments)."""
        return self._cast(tree, self.param_dtype)

    def cast_compute(self, tree):
        """Activation/input dtype for the forward/backward."""
        return self._cast(tree, self.compute_dtype)

    def cast_grad_accum(self, tree):
        """Dtype of the gradient accumulator under microbatching."""
        return self._cast(tree, self.grad_accum_dtype)


# ---------------------------------------------------------------- trees
def _tree_map(fn, tree):
    """Map ``fn`` over a nested dict/list/tuple's leaves, keeping the
    structure."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "shape"):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _flatten(tree, prefix=(), leaf=lambda x: False):
    """``(path tuple, leaf)`` pairs of a nested dict/list/tuple; ``leaf``
    marks sequences to keep whole (a spec is a tuple)."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flatten(v, prefix + (str(k),), leaf)
    elif isinstance(tree, (list, tuple)) and not hasattr(tree, "shape") \
            and not leaf(tree):
        for i, v in enumerate(tree):
            yield from _flatten(v, prefix + (str(i),), leaf)
    else:
        yield prefix, tree


def _unflatten_like(tree, values, prefix=()):
    if isinstance(tree, dict):
        return {k: _unflatten_like(v, values, prefix + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "shape"):
        return type(tree)(_unflatten_like(v, values, prefix + (str(i),))
                          for i, v in enumerate(tree))
    return values[prefix]


def state_tree(state) -> dict:
    """A ``TrainState`` (or a module) as ``{path: tensor}``: the model's
    ``params/…`` and ``buffers/…``, the optimizer's ``opt_state/<param
    path>/<key>`` (moments named after their parameter) and ``step``."""
    from torch import nn
    if isinstance(state, nn.Module):
        return {n.replace(".", "/"): t
                for n, t in state.state_dict(keep_vars=True).items()}
    model, opt = state.model, state.optimizer
    out = {}
    for n, p in model.named_parameters():
        out["params/" + n.replace(".", "/")] = p
    for n, b in model.named_buffers():
        out["buffers/" + n.replace(".", "/")] = b
    names = {id(p): n.replace(".", "/") for n, p in model.named_parameters()}
    for p, st in opt.state.items():
        for key, v in st.items():
            if hasattr(v, "shape"):
                out[f"opt_state/{names[id(p)]}/{key}"] = v
    return out


def named_leaves(tree, sep: str = "/"):
    """``[(path, leaf), ...]`` with ``sep``-joined string paths: dict keys
    and sequence indices as bare names, a module's ``state_dict`` names
    with ``.`` turned to ``sep``, a ``TrainState`` as :func:`state_tree`
    names it."""
    from torch import nn
    if isinstance(tree, nn.Module) or hasattr(tree, "optimizer"):
        return [(k.replace("/", sep), v) for k, v in state_tree(tree).items()]
    return [(sep.join(p), leaf) for p, leaf in _flatten(tree)]


# ------------------------------------------------------------- matching
def _fit_spec(spec: Sequence, ndim: int, name: str) -> tuple:
    """Right-align a rule spec to a leaf's rank (left-pad with None)."""
    spec = tuple(spec)
    if len(spec) > ndim:
        raise ValueError(
            f"partition rule spec {spec} has more entries than leaf "
            f"{name!r} has dims ({ndim})")
    return (None,) * (ndim - len(spec)) + spec


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= int(s)
    return n


def match_partition_rules(rules: Sequence[PartitionRule], params, *,
                          on_unmatched: str = "replicate",
                          _count: bool = True):
    """Specs (tuples, one entry a dim) congruent with ``params``: a nested
    dict/list gives the same structure; a module or a ``TrainState`` a flat
    ``{path: spec}``. First ``re.search`` match wins; scalar and
    single-element leaves replicate (``()``). ``on_unmatched``:
    ``"replicate"`` (warning + ``parallel_unmatched_leaves_total``) or
    ``"error"``."""
    if on_unmatched not in ("replicate", "error"):
        raise ValueError(f"on_unmatched={on_unmatched!r}")
    compiled = [(re.compile(rule), rule, spec) for rule, spec in rules]

    def spec_of(name: str, leaf) -> tuple:
        shape = tuple(getattr(leaf, "shape", ()))
        if len(shape) == 0 or _numel(shape) <= 1:
            return ()
        for rx, rule, spec in compiled:
            if rx.search(name) is not None:
                if _count:
                    _m_rule_match.inc(1, rule=rule)
                return _fit_spec(spec, len(shape), name)
        if on_unmatched == "error":
            raise ValueError(
                f"no partition rule matched param {name!r} "
                f"(shape {shape})")
        if _count:
            _m_unmatched.inc(1)
        warnings.warn(
            f"no partition rule matched param {name!r} (shape {shape}); "
            "replicating it — add a rule (or register one next to the "
            "model) to silence this", stacklevel=2)
        return ()

    leaves = named_leaves(params)
    if isinstance(params, (dict, list, tuple)):
        specs = {tuple(n.split("/")): spec_of(n, leaf) for n, leaf in leaves}
        return _unflatten_like(params, specs)
    return {n: spec_of(n, leaf) for n, leaf in leaves}


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """Where one tensor lives on a mesh: ``spec`` (full rank, after
    demotion; one entry a tensor dim) and the ``DTensor`` ``placements``
    it gives (one a mesh dim)."""
    mesh: Any
    spec: tuple
    placements: tuple

    def local_shape(self, shape) -> tuple:
        """The shape of one rank's block of a tensor of ``shape``."""
        from .mesh import axis_size
        out = list(shape)
        for entry_i, entry in enumerate(self.spec):
            for a in _axes(entry):
                out[entry_i] //= axis_size(self.mesh, a)
        return tuple(out)


def _axes(entry) -> tuple:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _demote(mesh, shape, spec) -> tuple:
    from .mesh import axis_names, axis_size
    names = axis_names(mesh)
    if len(tuple(spec)) > len(shape):
        raise ValueError(
            f"spec {tuple(spec)} has more entries than the leaf has dims "
            f"(shape {tuple(shape)})")
    entries = [None] * (len(shape) - len(tuple(spec))) + list(spec)
    for i, entry in enumerate(entries):
        axes = _axes(entry)
        if not axes:
            continue
        size = 1
        for a in axes:
            size *= axis_size(mesh, a) if a in names else 0
        if size == 0 or shape[i] % size:
            why = ("the mesh has no such axis" if size == 0 else
                   f"dim {i} of {shape[i]} does not divide by {size}")
            _m_demoted.inc(1, axis=",".join(axes))
            warnings.warn(f"spec entry {entry!r} of a leaf of shape "
                          f"{tuple(shape)} replicates: {why}", stacklevel=3)
            entries[i] = None
    return tuple(entries)


def sharding_of(mesh, shape, spec) -> NamedSharding:
    """One leaf's spec → :class:`NamedSharding` (demoting loudly)."""
    from torch.distributed.tensor import Replicate, Shard
    from .mesh import axis_names
    spec = _demote(mesh, tuple(shape), spec)
    placements = []
    for a in axis_names(mesh):
        dims = [i for i, e in enumerate(spec) if a in _axes(e)]
        placements.append(Shard(dims[0]) if dims else Replicate())
    return NamedSharding(mesh, spec, tuple(placements))


def to_shardings(mesh, params, specs):
    """Specs → :class:`NamedSharding` s for a concrete mesh, congruent with
    ``specs``. A short spec right-aligns, as rule specs do; an entry whose
    axis the mesh lacks or whose axis size does not divide the dim is
    demoted to ``None`` (replicated), with a warning and
    ``parallel_spec_demoted_total{axis=...}``."""
    leaves = dict(named_leaves(params))
    out = {"/".join(p): sharding_of(mesh, tuple(leaves["/".join(p)].shape),
                                    spec)
           for p, spec in _flatten(specs, leaf=lambda x: isinstance(
               x, tuple))}
    if isinstance(params, (dict, list, tuple)):
        return _unflatten_like(params, {tuple(k.split("/")): v
                                        for k, v in out.items()})
    return out


def local_block(full, sharding: NamedSharding):
    """This rank's block of the full tensor ``full`` under ``sharding``
    (mesh dims in order: an outer dim's chunk is cut again by an inner
    one)."""
    from torch.distributed.tensor import Shard
    from .mesh import axis_names, axis_rank, axis_size
    block = full
    for a, pl in zip(axis_names(sharding.mesh), sharding.placements):
        if isinstance(pl, Shard):
            n = axis_size(sharding.mesh, a)
            block = block.chunk(n, pl.dim)[axis_rank(sharding.mesh, a)]
    return block.contiguous()


def _mesh_device(mesh):
    import torch
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def shard_params(mesh, params, specs=None, *, rules=None,
                 dtype_policy: DtypePolicy | None = None,
                 on_unmatched: str = "replicate"):
    """Place a tree of full host values (every rank holds the same ones)
    onto ``mesh`` per ``rules`` or ``specs`` (+ an optional dtype policy).
    Returns ``(placed, shardings)``: ``placed`` holds a ``DTensor`` a leaf
    (this rank's block, ``to_local()``), ``shardings`` the
    :class:`NamedSharding` s."""
    import torch
    from torch.distributed.tensor import DTensor
    if specs is None:
        if rules is None:
            raise ValueError("pass specs= or rules=")
        specs = match_partition_rules(rules, params,
                                      on_unmatched=on_unmatched)
    tree = _tree_map(lambda v: v if isinstance(v, torch.Tensor)
                     else torch.as_tensor(v), params)
    if dtype_policy is not None:
        tree = dtype_policy.cast_params(tree)
    shardings = to_shardings(mesh, tree, specs)
    dev = _mesh_device(mesh)
    flat_sh = {"/".join(p): sh for p, sh in _flatten(shardings)}

    def place(path, leaf):
        sh = flat_sh[path]
        local = local_block(leaf.detach().to(dev), sh)
        return DTensor.from_local(local, mesh, sh.placements,
                                  run_check=False, shape=leaf.shape,
                                  stride=torch.empty(leaf.shape,
                                                     device="meta").stride())
    placed = {tuple(p.split("/")): place(p, leaf)
              for p, leaf in named_leaves(tree)}
    return _unflatten_like(tree, placed), shardings


def gather_local(local, sharding: NamedSharding):
    """The full tensor from this rank's block (an all-gather over each mesh
    dim that shards it, innermost first); every rank of the mesh calls
    it."""
    from torch.distributed.tensor import Shard
    from .collectives import allgather
    from .mesh import axis_group, axis_names
    full = local.detach()
    for a, pl in reversed(list(zip(axis_names(sharding.mesh),
                                   sharding.placements))):
        if isinstance(pl, Shard):
            full = allgather(full, axis_group(sharding.mesh, a),
                             gather_axis=pl.dim)
    return full


def gather_params(params):
    """Placed tree (``DTensor`` leaves) → full host values, the inverse of
    :func:`shard_params` up to the dtype policy: numpy arrays, bf16 leaves
    CPU tensors (numpy has no bf16). Every rank of the mesh must call it
    (each sharded leaf is an all-gather)."""
    import numpy as np
    import torch
    from torch.distributed.tensor import DTensor

    def one(leaf):
        if isinstance(leaf, DTensor):
            sh = NamedSharding(leaf.device_mesh, (), tuple(leaf.placements))
            leaf = gather_local(leaf.to_local(), sh)
        if isinstance(leaf, torch.Tensor):
            leaf = leaf.detach().cpu()
            if leaf.dtype == torch.bfloat16:
                return leaf
            return leaf.numpy()
        return np.asarray(leaf)
    return _tree_map(one, params)


# ------------------------------------------------- per-model rule sets
# name -> (rules, dtype policy, activation spec). The activation spec is
# LEFT-aligned (entry i names dim i: activations are batch-leading) unlike
# the right-aligned weight rules.
_RULE_SETS: dict[str, tuple[tuple[PartitionRule, ...],
                            DtypePolicy | None, tuple | None]] = {}


def register_partition_rules(name: str, rules: Sequence[PartitionRule],
                             dtype_policy: DtypePolicy | None = None,
                             activation_spec: Sequence | None = None
                             ) -> None:
    """Register a model family's rule set (called next to the model
    definition, at import time). Re-registration overwrites: the model
    file is the single source of truth. ``dtype_policy``: the family's
    default (bf16 compute, f32 params/accum), read by
    :func:`dtype_policy_for`; ``activation_spec``: the left-aligned entries
    :func:`constrain_activation` holds the model's block-boundary
    activations to."""
    _RULE_SETS[name] = (tuple(rules), dtype_policy,
                        tuple(activation_spec)
                        if activation_spec is not None else None)


def _entry(name: str):
    if name not in _RULE_SETS:
        raise KeyError(f"no partition rules registered for {name!r}; "
                       f"known: {sorted(_RULE_SETS)}")
    return _RULE_SETS[name]


def partition_rules_for(name: str) -> tuple[PartitionRule, ...]:
    return _entry(name)[0]


def dtype_policy_for(name: str) -> DtypePolicy | None:
    return _entry(name)[1]


def activation_spec_for(name: str) -> tuple | None:
    return _entry(name)[2]


def constrain_activation(x, model: str):
    """The JAX package holds a block-boundary activation to ``model``'s
    activation spec (batch rows over ``dp``) so GSPMD keeps it sharded. One
    process a rank already computes on its own rows and nothing is laid out
    for it, so in the port this is the identity; the model files call it
    where the JAX package does, which keeps the hook points the same."""
    return x


def registered_rule_sets() -> list[str]:
    return sorted(_RULE_SETS)
