#!/usr/bin/env python3
"""Which ``torch.distributed`` collectives gloo runs on CUDA tensors.

Run from the root of a checkout on a machine with an NVIDIA GPU:

    python3 tools/probe_gloo_cuda.py

Spawns 2 gloo ranks on card 0 once for each operation (all_reduce,
broadcast, all_gather_into_tensor, all_gather, reduce_scatter_tensor,
all_to_all_single, batched point-to-point, and a ``DeviceMesh`` with a
``DTensor``'s ``full_tensor()``; CPU-tensor all_to_all and reduce-scatter
beside them), since a rank that crashes takes its group with it, and prints
each result or how the ranks ended. ``parallel/collectives.py`` stages the
operations gloo cannot run on CUDA tensors through pinned host memory.
"""

from __future__ import annotations

import socket
import sys

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _rank(rank: int, world: int, port: int, op: str) -> None:
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    dev = torch.device("cuda", 0)
    x = torch.arange(4.0, device=dev) + rank

    def all_reduce():
        y = x.clone()
        dist.all_reduce(y)
        return y

    def broadcast():
        y = x.clone()
        dist.broadcast(y, 0)
        return y

    def all_gather_into_tensor():
        o = torch.empty(4 * world, device=dev)
        dist.all_gather_into_tensor(o, x)
        return o

    def all_gather():
        o = [torch.empty(4, device=dev) for _ in range(world)]
        dist.all_gather(o, x)
        return torch.cat(o)

    def reduce_scatter_tensor(src=None):
        src = x if src is None else src
        o = torch.empty(4 // world, device=src.device)
        dist.reduce_scatter_tensor(o, src)
        return o

    def all_to_all_single(src=None):
        src = x if src is None else src
        o = torch.empty_like(src)
        dist.all_to_all_single(o, src)
        return o

    def point_to_point():
        o = torch.empty(4, device=dev)
        ops = [dist.P2POp(dist.isend, x, (rank + 1) % world),
               dist.P2POp(dist.irecv, o, (rank - 1) % world)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return o

    def dtensor_full_tensor():
        from torch.distributed.device_mesh import init_device_mesh
        from torch.distributed.tensor import DTensor, Shard
        mesh = init_device_mesh("cuda", (world,), mesh_dim_names=("tp",))
        d = DTensor.from_local(x, mesh, [Shard(0)], run_check=False)
        return d.full_tensor()

    ops = {f.__name__: f for f in (
        all_reduce, broadcast, all_gather_into_tensor, all_gather,
        reduce_scatter_tensor, all_to_all_single, point_to_point,
        dtensor_full_tensor)}
    ops["cpu_all_to_all_single"] = lambda: all_to_all_single(x.cpu())
    ops["cpu_reduce_scatter_tensor"] = lambda: reduce_scatter_tensor(x.cpu())
    try:
        out = ops[op]().tolist()
    except Exception as e:                  # report, do not crash the group
        out = f"raised {e!r:.160}"
    if rank == 0:
        print(f"{op}: {out}", flush=True)
    dist.destroy_process_group()


OPS = ("all_reduce", "broadcast", "cpu_all_to_all_single",
       "cpu_reduce_scatter_tensor", "all_gather_into_tensor", "all_gather",
       "reduce_scatter_tensor", "all_to_all_single", "point_to_point",
       "dtensor_full_tensor")


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("probe_gloo_cuda: needs an NVIDIA GPU")
    print(sys.version.split()[0], torch.__version__, torch.version.cuda,
          torch.cuda.get_device_name(0), flush=True)
    for op in OPS:
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        try:
            mp.spawn(_rank, args=(2, port, op), nprocs=2)
        except Exception as e:
            print(f"{op}: the ranks ended: {e!r:.160}", flush=True)


if __name__ == "__main__":
    main()
