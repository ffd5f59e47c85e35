"""Mesh construction and process-group bootstrap.

The port of ``mmlspark_tpu/parallel/mesh.py``. The JAX package is one
controller over a grid of devices; the port runs one process per device
under ``torch.distributed``, and a named mesh axis is a dim of a
``torch.distributed.device_mesh.DeviceMesh`` whose ranks are those
processes. Axis conventions are the JAX package's:

  ``dp`` — data parallel (rows / batch)
  ``tp`` — tensor parallel (model weights, attention heads)
  ``pp`` — pipeline parallel (layer stages)
  ``sp`` — sequence/context parallel (ring and Ulysses attention)
  ``ep`` — expert parallel (MoE)

A mesh keeps its size-1 axes, so every partition spec can name them and a
collective over a size-1 axis is the identity. :func:`mesh_scope` puts a
mesh in scope for the code it wraps, what ``with mesh:`` is to the JAX
package: the model's block-boundary hooks and the sharded losses read it.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import os

AXIS_ORDER = ("pp", "dp", "ep", "sp", "tp")


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Declarative mesh: axis name -> size; -1 for one auto-filled axis."""
    dp: int = -1
    tp: int = 1
    pp: int = 1
    sp: int = 1
    ep: int = 1

    def resolve(self, n_devices: int) -> dict[str, int]:
        sizes = {a: getattr(self, a) for a in AXIS_ORDER}
        fixed = math.prod(s for s in sizes.values() if s > 0)
        autos = [a for a, s in sizes.items() if s <= 0]
        if len(autos) > 1:
            raise ValueError(f"only one axis may be -1, got {autos}")
        if autos:
            if n_devices % fixed:
                raise ValueError(
                    f"{n_devices} devices not divisible by fixed axes "
                    f"{fixed}")
            sizes[autos[0]] = n_devices // fixed
        elif fixed != n_devices:
            raise ValueError(
                f"mesh {sizes} needs {fixed} devices, have {n_devices}")
        return sizes


def _device_type(device) -> str:
    """``"cuda"`` unless the caller asks for the CPU."""
    if device is None:
        return "cuda"
    return device if isinstance(device, str) else device.type


def _ensure_group(device_type: str, world: int) -> None:
    """A one-rank process group on an in-memory store when the process has
    none and the mesh is one device: the JAX package's one-device mesh needs
    no bootstrap either. A larger mesh needs :func:`distributed_init` (or
    ``torchrun``) first."""
    import torch.distributed as dist
    if dist.is_initialized():
        return
    if world != 1:
        raise RuntimeError(
            f"a mesh of {world} ranks needs a process group: call "
            "parallel.distributed_init() (or launch with torchrun) on every "
            "rank first")
    dist.init_process_group(
        "nccl" if device_type == "cuda" else "gloo",
        store=dist.HashStore(), rank=0, world_size=1)


def _ranks(devices, device_type: str) -> list:
    """The ranks a mesh spans: ``devices`` or the whole process group (a
    one-rank one started when the process has none)."""
    import torch.distributed as dist
    ranks = None if devices is None else [int(r) for r in devices]
    _ensure_group(device_type, len(ranks) if ranks is not None else
                  int(os.environ.get("WORLD_SIZE", "1")))
    return ranks if ranks is not None else \
        list(range(dist.get_world_size()))


def build_mesh(spec: MeshSpec | None = None, devices=None, *, device=None):
    """A ``DeviceMesh`` over every rank (or the ranks ``devices`` lists) of
    the process group, shaped by ``spec`` in :data:`AXIS_ORDER` with every
    axis kept, size-1 ones included. ``device``: ``"cuda"`` (default) or
    ``"cpu"``, the device type of the tensors it places. Every rank of the
    mesh must call it with the same arguments (building one is a
    collective)."""
    import torch
    from torch.distributed.device_mesh import DeviceMesh

    dtype = _device_type(device)
    ranks = _ranks(devices, dtype)
    sizes = (spec or MeshSpec()).resolve(len(ranks))
    grid = torch.tensor(ranks, dtype=torch.int64).reshape(
        tuple(sizes[a] for a in AXIS_ORDER))
    return DeviceMesh(dtype, grid, mesh_dim_names=AXIS_ORDER)


def local_mesh(axis: str = "dp", devices=None, *, device=None):
    """1-D mesh over every rank: the default data-parallel world (the
    reference's "one LightGBM machine per Spark task")."""
    import torch
    from torch.distributed.device_mesh import DeviceMesh

    dtype = _device_type(device)
    return DeviceMesh(dtype, torch.tensor(_ranks(devices, dtype),
                                          dtype=torch.int64),
                      mesh_dim_names=(axis,))


def mesh_shape_for(n_devices: int, **axes: int) -> MeshSpec:
    """Convenience: MeshSpec from keyword sizes, validated for n_devices."""
    spec = MeshSpec(**axes)
    spec.resolve(n_devices)
    return spec


def as_mesh(mesh, device=None):
    """``mesh`` itself when it is a ``DeviceMesh``; a :class:`MeshSpec`
    built over the process group's ranks (:func:`build_mesh`)."""
    if isinstance(mesh, MeshSpec):
        return build_mesh(mesh, device=device)
    if not hasattr(mesh, "mesh_dim_names"):
        raise TypeError(f"mesh must be a torch DeviceMesh or a "
                        f"parallel.MeshSpec, got {type(mesh).__name__}")
    return mesh


def axis_names(mesh) -> tuple:
    return tuple(mesh.mesh_dim_names or ())


def axis_size(mesh, axis: str) -> int:
    """Size of ``axis`` in ``mesh`` (1 for an axis the mesh lacks)."""
    names = axis_names(mesh)
    return int(mesh.shape[names.index(axis)]) if axis in names else 1


def mesh_shape(mesh) -> dict[str, int]:
    """``{axis: size}``, the JAX ``Mesh.shape``."""
    return {a: int(s) for a, s in zip(axis_names(mesh), mesh.shape)}


def axis_group(mesh, axis: str):
    """The process group of this rank's line along ``axis``; ``None`` for a
    size-1 axis or one the mesh lacks (every collective is then the
    identity)."""
    if axis_size(mesh, axis) <= 1:
        return None
    return mesh.get_group(axis)


def axis_rank(mesh, axis: str) -> int:
    """This rank's coordinate along ``axis`` (0 for a missing axis)."""
    if axis not in axis_names(mesh):
        return 0
    return int(mesh.get_local_rank(axis))


_SCOPE: list = []


@contextlib.contextmanager
def mesh_scope(mesh):
    """Put ``mesh`` in scope for the wrapped code (``with mesh:`` in the JAX
    package): :func:`current_mesh` returns it."""
    _SCOPE.append(mesh)
    try:
        yield mesh
    finally:
        _SCOPE.pop()


def current_mesh():
    """The innermost mesh in scope, or ``None``."""
    return _SCOPE[-1] if _SCOPE else None


def distributed_init(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None, *,
                     device=None) -> bool:
    """Join the process group, the reference's driver rendezvous
    (``LightGBMUtils.createDriverNodesThread``,
    ``lightgbm/LightGBMUtils.scala:119-188``) as ``torch.distributed``'s
    TCP store: every process dials the coordinator ``host:port``.

    Arguments default from ``MMLSPARK_TPU_COORDINATOR`` /
    ``MMLSPARK_TPU_NUM_PROCESSES`` / ``MMLSPARK_TPU_PROCESS_ID``, then from
    ``torchrun``'s ``MASTER_ADDR``/``MASTER_PORT``/``WORLD_SIZE``/``RANK``;
    explicit arguments win, and ``process_id=0`` is a real value. The
    backend follows the device: NCCL on the card with one card a rank
    (each rank takes card ``LOCAL_RANK`` modulo the cards there are), gloo
    on the CPU or when ranks outnumber the cards (NCCL refuses two ranks on
    one card). Returns False, and starts nothing, when no coordinator is
    named; True once the group is up (or already was)."""
    import torch
    import torch.distributed as dist

    if dist.is_initialized():
        return True
    env = os.environ
    addr = coordinator_address or env.get("MMLSPARK_TPU_COORDINATOR")
    if addr is None and "MASTER_ADDR" in env:
        addr = f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', '29500')}"
    if addr is None:
        return False
    world = num_processes if num_processes is not None else int(
        env.get("MMLSPARK_TPU_NUM_PROCESSES", env.get("WORLD_SIZE", "1")))
    rank = process_id if process_id is not None else int(
        env.get("MMLSPARK_TPU_PROCESS_ID", env.get("RANK", "0")))
    backend = "gloo"
    if _device_type(device) == "cuda":
        cards = torch.cuda.device_count()
        if cards == 0:
            raise RuntimeError("distributed_init(device='cuda') without a "
                               "GPU; pass device='cpu'")
        local = int(env.get("LOCAL_RANK", rank))
        torch.cuda.set_device(local % cards)
        local_world = int(env.get("LOCAL_WORLD_SIZE", world))
        backend = "nccl" if local_world <= cards else "gloo"
    dist.init_process_group(backend, init_method=f"tcp://{addr}",
                            rank=rank, world_size=world)
    return True
