"""Ranks for the parallel-slice tests (``test_torch_parallel.py``,
``test_torch_partition.py``).

``spawn(scenario, world, payload)`` starts ``world`` processes, joins them
into a gloo process group on 127.0.0.1 and runs one scenario in each with
``payload`` (numpy inputs and converted weights made by the test, which
imports the JAX package; this module imports only numpy, torch and the
port). Rank 0's result comes back to the caller. Every rank runs torch on
one thread, on the CPU.
"""

from __future__ import annotations

import os
import pickle
import socket
import tempfile
import time
import warnings

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

SPAWN_TIMEOUT = 240.0       # seconds a scenario's ranks may take in all


def t(a, dtype=torch.float32):
    return torch.tensor(np.asarray(a), dtype=dtype)


def gather(x: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    """Every rank's block of ``x`` along ``axis``, joined on ``dim``."""
    from mmlspark_torch.parallel.collectives import allgather
    return allgather(x.detach(), axis, mesh=mesh, gather_axis=dim)


def block(x: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    from mmlspark_torch.parallel.mesh import axis_rank, axis_size
    return x.chunk(axis_size(mesh, axis), dim)[axis_rank(mesh, axis)]


def counts():
    """(allreduce calls, the obs collective bytes by op) now."""
    from mmlspark_torch.obs import registry
    from mmlspark_torch.parallel.collectives import allreduce
    snap = registry.snapshot()
    return allreduce.calls, {k: v for k, v in snap.items()
                             if k.startswith("collective_")}


def delta(before, after) -> dict:
    return {k: after.get(k, 0) - before.get(k, 0)
            for k in set(after) | set(before) if after.get(k, 0)
            != before.get(k, 0)}


# ---------------------------------------------------------- attention
def ring_case(mesh, p, impl, causal, dtype=torch.float32):
    """The ring over ``mesh``'s sp axis on this rank's blocks of p's q, k,
    v, mask: the whole output and the whole q/k/v gradients of
    sum(o * w) (each rank's share of the loss over its block)."""
    from mmlspark_torch.parallel import make_ring_attention
    q, k, v = (block(t(p[n], dtype), mesh, "sp", 2).requires_grad_()
               for n in "qkv")
    mask = block(t(p["mask"], torch.bool), mesh, "sp", 1)
    w = block(t(p["w"]), mesh, "sp", 2)
    before = counts()[1]
    o = make_ring_attention(mesh, causal=causal, local_impl=impl)(
        q, k, v, mask)
    moved = delta(before, counts()[1])
    (o.float() * w).sum().backward()
    return dict(o=gather(o, mesh, "sp", 2).float().numpy(),
                grads=[gather(a.grad, mesh, "sp", 2).float().numpy()
                       for a in (q, k, v)], dtype=str(o.dtype),
                moved=moved)


def scenario_attention(p) -> dict:
    """Collectives, meshes, sharding helpers, ring and Ulysses attention,
    2-D data x sequence parallelism and an encoder step through the ring,
    on 4 ranks."""
    from mmlspark_torch.parallel import (MeshSpec, all_to_all, allgather,
                                         allreduce, axis_index, barrier,
                                         build_mesh, local_mesh,
                                         make_ulysses_attention, ppermute,
                                         psum_scatter, ring_permute,
                                         shard_batch)
    from mmlspark_torch.parallel.mesh import mesh_shape
    r = dist.get_rank()
    out = {}
    dp = local_mesh(device="cpu")
    out["local_mesh"] = mesh_shape(dp)
    out["mesh_2x2"] = mesh_shape(build_mesh(MeshSpec(dp=2, tp=2),
                                            device="cpu"))
    out["mesh_auto"] = mesh_shape(build_mesh(MeshSpec(dp=-1, tp=2),
                                             device="cpu"))
    # collectives over dp = 4, one element a rank of arange(4)
    x = torch.arange(4, dtype=torch.float32)
    mine = x[r:r + 1]
    coll = {"sum": allreduce(mine, "dp", mesh=dp),
            "max": allreduce(mine, "dp", "max", mesh=dp),
            "mean": allreduce(mine, "dp", "mean", mesh=dp),
            "allgather": allgather(mine, "dp", mesh=dp),
            "psum_scatter": psum_scatter(x, "dp", mesh=dp),
            "ring_permute": ring_permute(mine, "dp", 1, mesh=dp),
            "ppermute": ppermute(mine, "dp", [(0, 2), (2, 0), (1, 3)],
                                 mesh=dp),
            "all_to_all": all_to_all(x * (r + 1), "dp", split_axis=0,
                                     concat_axis=0, tiled=True, mesh=dp),
            "axis_index": torch.tensor([float(axis_index("dp", mesh=dp))])}
    barrier("dp", mesh=dp)
    out["collectives"] = {k: gather(v, dp, "dp", 0).numpy()
                          for k, v in coll.items()}
    # gradients through the differentiable collectives: each rank's loss
    # is sum(y * (rank + 1))
    g = {}
    for name, fn in (("allgather", lambda a: allgather(a, "dp", mesh=dp)),
                     ("psum_scatter",
                      lambda a: psum_scatter(a, "dp", mesh=dp)),
                     ("ring_permute",
                      lambda a: ring_permute(a, "dp", 1, mesh=dp)),
                     ("all_to_all", lambda a: all_to_all(
                         a, "dp", split_axis=0, concat_axis=0, tiled=True,
                         mesh=dp)),
                     ("psum", lambda a: allreduce(a, "dp", mesh=dp))):
        a = (x.clone() if name in ("psum_scatter", "all_to_all")
             else mine.clone()).requires_grad_()
        (fn(a) * (r + 1)).sum().backward()
        g[name] = gather(a.grad, dp, "dp", 0).numpy()
    out["collective_grads"] = g
    # sharding helpers: 13 rows over dp = 4
    xs, mask, n = shard_batch(dp, t(p["rows13"]))
    total = allreduce((xs * mask[:, None]).sum(), "dp", mesh=dp)
    out["shard_batch"] = (tuple(xs.shape), int(n), float(total))

    sp = build_mesh(MeshSpec(dp=1, sp=4), device="cpu")
    for impl in ("blockwise", "flash"):
        for causal in (False, True):
            out["ring", impl, causal] = ring_case(sp, p["ring"], impl,
                                                  causal)
    out["ring_bf16"] = ring_case(sp, p["ring"], "flash", False,
                                 torch.bfloat16)
    out["ring_bf16_blockwise"] = ring_case(sp, p["ring"], "blockwise",
                                           False, torch.bfloat16)
    # Ulysses over sp = 4 (8 heads: 2 a rank)
    u = p["ulysses"]
    for impl in ("blockwise", "flash"):
        for causal in (False, True):
            q, k, v = (block(t(u[n]), sp, "sp", 2).requires_grad_()
                       for n in "qkv")
            fn = make_ulysses_attention(sp, causal=causal, local_impl=impl,
                                        block_size=16)
            o = fn(q, k, v, block(t(u["mask"], torch.bool), sp, "sp", 1))
            (o * block(t(u["w"]), sp, "sp", 2)).sum().backward()
            out["ulysses", impl, causal] = dict(
                o=gather(o, sp, "sp", 2).numpy(),
                dq=gather(q.grad, sp, "sp", 2).numpy())
    errors = []
    try:
        make_ulysses_attention(sp)(*(block(t(u[n])[:, :2], sp, "sp", 2)
                                     for n in "qkv"))
    except ValueError as e:
        errors.append(("heads", str(e)))
    try:
        make_ulysses_attention(sp, scale=0.5, local_impl="flash")
    except NotImplementedError as e:
        errors.append(("scale", str(e)))
    out["ulysses_errors"] = errors
    # 2-D: rows over dp = 2, the sequence over sp = 2
    mesh2 = build_mesh(MeshSpec(dp=2, sp=2), device="cpu")
    for kind in ("ring", "ulysses"):
        d = p["2d_" + kind]
        for impl in ("blockwise", "flash"):
            q, k, v = (block(block(t(d[n]), mesh2, "dp", 0), mesh2, "sp", 2)
                       for n in "qkv")
            m = block(block(t(d["mask"], torch.bool), mesh2, "dp", 0),
                      mesh2, "sp", 1)
            if kind == "ring":
                from mmlspark_torch.parallel import make_ring_attention
                fn = make_ring_attention(mesh2, batch_axis="dp",
                                         local_impl=impl)
            else:
                fn = make_ulysses_attention(mesh2, batch_axis="dp",
                                            local_impl=impl)
            o = fn(q, k, v, m)
            out["2d", kind, impl] = gather(gather(o, mesh2, "sp", 2),
                                           mesh2, "dp", 0).numpy()
    out["encoder_ring"] = encoder_through_ring(p["encoder"], sp)
    return out


def encoder_through_ring(e, mesh) -> dict:
    """One SGD step of the tiny f32 encoder (converted JAX weights) whose
    attention is the ring over ``mesh``: the loss, the new parameters, and
    what the step moved (the ring's rotations, the gradient all-reduce)."""
    from mmlspark_torch.dl import TrainState, make_attention_fn
    from mmlspark_torch.dl.train import make_train_step
    model = e["model"].with_attention(make_attention_fn("ring", mesh=mesh))
    opt = torch.optim.SGD(model.parameters(), lr=1e-2)
    step = make_train_step(model, opt, fetch="pooled", mesh=mesh,
                           loss_fn=lambda pooled, y: ((pooled.mean(-1) - y)
                                                      ** 2).mean())
    calls, before = counts()
    _, loss = step(TrainState(model, opt), t(e["ids"], torch.int64),
                   t(e["y"]))
    calls2, after = counts()
    return dict(loss=float(loss), allreduce_calls=calls2 - calls,
                moved=delta(before, after),
                params={n: p.detach().numpy().copy()
                        for n, p in model.named_parameters()})


# ---------------------------------------------------------- partition
def bert_step(p, mesh, steps, accum_steps=1, policy=None, sgd=False):
    """``steps`` partitioned BERT steps from the converted JAX weights
    (``_bert_fixture`` of tests/test_partition.py); the losses, the final
    parameters gathered, and the q weights' placement."""
    import copy
    from mmlspark_torch.dl import TrainState
    from mmlspark_torch.dl.pretrain import default_optimizer
    from mmlspark_torch.dl.train import (make_partitioned_train_step,
                                         partition_train_state)
    from mmlspark_torch.parallel import partition_rules_for
    from mmlspark_torch.parallel.partition import gather_local
    model = copy.deepcopy(p["bert"])
    opt = torch.optim.SGD(model.parameters(), lr=1e-2) if sgd else \
        default_optimizer(1e-3)(list(model.parameters()))
    with warnings.catch_warnings():
        warnings.simplefilter("error")          # no unmatched leaf
        state, sh = partition_train_state(
            TrainState(model, opt), mesh, partition_rules_for("BertEncoder"))
    step = make_partitioned_train_step(model, opt, mesh, sh, fetch="pooled",
                                       accum_steps=accum_steps,
                                       dtype_policy=policy)
    losses = []
    for _ in range(steps):
        state, loss = step(state, t(p["ids"], torch.int64),
                           t(p["labels"], torch.int64))
        losses.append(float(loss))
    q = sh["params/block0/q/weight"]
    params = {n: gather_local(p_, sh["params/" + n.replace(".", "/")])
              .numpy().copy() for n, p_ in model.named_parameters()}
    return dict(losses=losses, params=params,
                q_placement=[repr(x) for x in q.placements],
                q_local=tuple(model.block0.q.weight.shape))


def resnet_step(mesh) -> dict:
    """ResNet (stages (1, 1), width 64, 128 classes, f32) placed by
    ``shard_train_state`` over dp x tp and stepped once by
    ``make_train_step(mesh=)``: placements before and after, the loss,
    and the all-reduces the step issued."""
    from mmlspark_torch.dl import TrainState
    from mmlspark_torch.dl.train import make_train_step, shard_train_state
    from mmlspark_torch.models.resnet import BasicBlock, ResNet
    model = ResNet((1, 1), BasicBlock, num_classes=128, width=64,
                   dtype=torch.float32,
                   generator=torch.Generator().manual_seed(0))
    opt = torch.optim.SGD(model.parameters(), lr=1e-2)
    full = {n: tuple(p.shape) for n, p in model.named_parameters()}
    state = shard_train_state(TrainState(model, opt), mesh)
    before = {n: (tuple(sh.spec), tuple(map(repr, sh.placements)))
              for n, sh in state.shardings.items() if n.startswith("params/")}
    x = torch.tensor(np.random.default_rng(0).normal(size=(8, 16, 16, 3)),
                     dtype=torch.float32)
    y = torch.arange(8) % 128
    step = make_train_step(model, opt, mesh=mesh)
    calls, _ = counts()
    state, loss = step(state, x, y)
    calls2, _ = counts()
    shapes_ok = all(tuple(p.shape) == state.shardings[
        "params/" + n.replace(".", "/")].local_shape(full[n])
        for n, p in model.named_parameters())
    after = {n: (tuple(sh.spec), tuple(map(repr, sh.placements)))
             for n, sh in state.shardings.items() if n.startswith("params/")}
    return dict(before=before, after=after, loss=float(loss),
                allreduce_calls=calls2 - calls, shapes_ok=shapes_ok)


def scenario_partition(p) -> dict:
    """Shard/gather, demotions, the partitioned BERT step, mesh
    pretraining, the dp featurizer and the sharding-analysis counts, on 4
    ranks (a 2 x 2 dp x tp mesh)."""
    import copy
    from mmlspark_torch.core import DataFrame
    from mmlspark_torch.dl import TextEncoderFeaturizer
    from mmlspark_torch.dl.pretrain import pretrain_masked_lm
    from mmlspark_torch.lightgbm.engine import TreeParams, grow_tree
    from mmlspark_torch.obs import registry
    from mmlspark_torch.parallel import (DtypePolicy, MeshSpec, build_mesh,
                                         gather_params, local_mesh,
                                         shard_params, to_shardings)
    out = {}
    mesh = build_mesh(MeshSpec(dp=2, tp=2), device="cpu")
    placed, sh = shard_params(mesh, p["tree"], rules=p["tree_rules"])
    out["tree_specs"] = {k: sh[k]["kernel" if k == "qkv" else "embedding"]
                         .spec for k in ("qkv", "emb")}
    out["tree_local"] = tuple(placed["qkv"]["kernel"].to_local().shape)
    back = gather_params(placed)
    out["tree_back"] = back
    c = registry.counter("parallel_spec_demoted_total")
    demote = {}
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        b0 = c.value(axis="tp")
        pl, s = shard_params(mesh, {"w": np.zeros((9, 8), np.float32)},
                             rules=[(r"w", ("tp", None))])
        demote["non_divisible"] = (s["w"].spec, c.value(axis="tp") - b0,
                                   gather_params(pl)["w"].shape)
        b0 = c.value(axis="tp")
        flat = local_mesh(device="cpu")
        pl, s = shard_params(flat, {"w": np.ones((8, 8), np.float32)},
                             rules=[(r"w", (None, "tp"))])
        demote["missing_axis"] = (s["w"].spec, c.value(axis="tp") - b0,
                                  gather_params(pl)["w"])
        demote["warned"] = sum("replicates" in str(x.message) for x in w)
    s = to_shardings(mesh, {"w": np.zeros((6, 8), np.float32)},
                     {"w": ("tp",)})
    demote["short_spec"] = s["w"].spec
    try:
        to_shardings(mesh, {"b": np.zeros(4, np.float32)},
                     {"b": ("dp", "tp")})
    except ValueError as e:
        demote["long_spec"] = str(e)
    pl, _ = shard_params(mesh, {"w": np.zeros((8, 8), np.float32),
                                "ids": np.zeros(8, np.int32)},
                         rules=[(r"w", (None, "tp")), (r"ids", ())],
                         dtype_policy=DtypePolicy(param_dtype="bfloat16"))
    demote["policy_dtypes"] = (str(pl["w"].dtype), str(pl["ids"].dtype))
    out["demote"] = demote
    # the partitioned BERT step over 2 x 2: AdamW trajectory and layout,
    # an SGD step's parameters, accumulation in f32 and in bf16
    out["bert_2x2"] = bert_step(p, mesh, 3)
    out["bert_2x2_sgd"] = bert_step(p, mesh, 1, sgd=True)
    for name, accum in (("f32", "float32"), ("bf16", "bfloat16")):
        pol = DtypePolicy(param_dtype=None, compute_dtype=None,
                          grad_accum_dtype=accum)
        out["bert_accum_" + name] = bert_step(p, mesh, 1, accum_steps=2,
                                              policy=pol)["losses"]
    # mesh pretraining and its checks
    # (pretraining places and trains its model in place: a copy each time)
    _, losses = pretrain_masked_lm(copy.deepcopy(p["mlm"]), p["mlm_ids"],
                                   steps=3, batch_size=8, device="cpu",
                                   mesh=mesh)
    out["mlm_losses"] = losses
    errs = []
    for bad, batch in ((build_mesh(MeshSpec(dp=4), device="cpu"), 6),
                       (local_mesh("tp", device="cpu"), 8)):
        try:
            pretrain_masked_lm(copy.deepcopy(p["mlm"]), p["mlm_ids"],
                               steps=1, batch_size=batch, device="cpu",
                               mesh=bad)
        except ValueError as e:
            errs.append(str(e))
    out["mlm_errors"] = errs
    # the dp featurizer over dp = 4: 5 rows (3 padding rows)
    stage = TextEncoderFeaturizer(mesh=build_mesh(MeshSpec(dp=4),
                                                  device="cpu"),
                                  model=p["feat_model"], seqChunk=8,
                                  device="cpu")
    out["featurizer"] = np.asarray(stage.transform(
        DataFrame({"tokens": p["feat_rows"]}))["features"])
    # sharding analysis: ResNet over dp x tp; accumulation keeps rows; the
    # GBDT grower's histogram all-reduces
    out["resnet"] = resnet_step(mesh)
    out["accum_rows"] = accum_rows(p)
    bins = np.random.default_rng(0).integers(0, 16, size=(64, 6)) \
        .astype(np.uint8)
    r, n = dist.get_rank(), dist.get_world_size()
    g = np.linspace(-1, 1, 64).astype(np.float32)
    calls, before = counts()
    grow_tree(torch.from_numpy(bins[r::n].copy()),
              torch.from_numpy(g[r::n].copy()),
              torch.ones(64 // n), torch.ones(6, dtype=torch.bool),
              torch.ones(64 // n), params=TreeParams(num_leaves=7,
                                                     max_bin=15),
              num_features=6, group=dist.group.WORLD)
    calls2, after = counts()
    out["gbdt"] = (calls2 - calls, delta(before, after))
    return out


def accum_rows(p) -> dict:
    """A dp = 4 step with accum_steps=2 on 32 rows: the rows each
    microbatch's forward sees on a rank, and the all-gathers it issued."""
    import copy
    from mmlspark_torch.dl import TrainState
    from mmlspark_torch.dl.train import make_train_step
    from mmlspark_torch.parallel import MeshSpec, build_mesh
    model = copy.deepcopy(p["mlm"].encoder)
    seen = []
    model.register_forward_pre_hook(lambda m, a: seen.append(a[0].shape[0]))
    opt = torch.optim.SGD(model.parameters(), lr=1e-2)
    mesh = build_mesh(MeshSpec(dp=4), device="cpu")
    step = make_train_step(model, opt, mesh=mesh, fetch="pooled",
                           loss_fn=lambda pooled, y: pooled.sum(),
                           accum_steps=2)
    _, before = counts()
    step(TrainState(model, opt), torch.ones((32, 8), dtype=torch.int64),
         torch.zeros(32))
    _, after = counts()
    return dict(rows=seen, moved=delta(before, after))


def scenario_one_rank(p) -> dict:
    """The partitioned BERT step on a one-rank mesh."""
    from mmlspark_torch.parallel import MeshSpec, build_mesh
    mesh = build_mesh(MeshSpec(dp=1, tp=1), device="cpu")
    return dict(adamw=bert_step(p, mesh, 4), sgd=bert_step(p, mesh, 1,
                                                           sgd=True))


SCENARIOS = {"attention": scenario_attention,
             "partition": scenario_partition,
             "one_rank": scenario_one_rank}


# ------------------------------------------------------------------ launch
def _rank_main(rank, world, port, scenario, in_path, out_path, env):
    os.environ.update(env)
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    try:
        with open(in_path, "rb") as f:
            payload = pickle.load(f)
        result = SCENARIOS[scenario](payload)
        if rank == 0:
            with open(out_path, "wb") as f:
                pickle.dump(result, f)
    finally:
        dist.destroy_process_group()


def spawn(scenario: str, world: int, payload) -> dict:
    """Run ``scenario`` on ``world`` gloo ranks with ``payload``; returns
    rank 0's result. Raises if a rank fails or the ranks outlast
    ``SPAWN_TIMEOUT``."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = {"OMP_NUM_THREADS": "1", "WORLD_SIZE": str(world)}
    with tempfile.TemporaryDirectory() as d:
        in_path = os.path.join(d, "payload.pkl")
        out_path = os.path.join(d, "result.pkl")
        with open(in_path, "wb") as f:
            pickle.dump(payload, f)
        ctx = mp.start_processes(
            _rank_main, args=(world, port, scenario, in_path, out_path, env),
            nprocs=world, join=False, start_method="spawn")
        deadline = time.monotonic() + SPAWN_TIMEOUT
        try:
            while not ctx.join(timeout=max(deadline - time.monotonic(),
                                           0.1)):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{scenario}: ranks still running "
                                       f"after {SPAWN_TIMEOUT} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
        with open(out_path, "rb") as f:
            return pickle.load(f)
