"""Ranks for the sharded-training tests (``test_torch_gbdt_shards.py``).

``spawn(scenario, world)`` starts ``world`` processes, joins them into a
gloo process group on ``localhost`` and runs one scenario in each; the
scenario's result on rank 0 comes back to the caller. The module imports
only numpy, torch and the port, so a rank starts in a couple of seconds
(the test module itself imports the JAX package). Every rank runs torch
on one thread.
"""

from __future__ import annotations

import os
import pickle
import socket
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

SPAWN_TIMEOUT = 240.0       # seconds a scenario's ranks may take in all
GRID = 1024                 # gradients on a 2^-10 grid: exact f32 sums
VOTE_KW = dict(parallelism="voting_parallel", topK=6)


# ------------------------------------------------------------------ frames
def on_grid(a):
    return (np.round(np.asarray(a, np.float64) * GRID) / GRID).astype(
        np.float32)


def make_binary(n=1200, f=12, seed=0):
    """``tests/test_lightgbm_distributed.py``'s frame."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, f)).astype(np.float32)
    logits = x[:, 0] * 2 - x[:, 1] + 0.5 * x[:, 2] * x[:, 3]
    y = (logits + rng.normal(scale=0.5, size=n) > 0).astype(np.float32)
    return x, y


def make_multiclass(n=900, f=8, seed=2):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, f)).astype(np.float32)
    y = np.digitize(x[:, 0] + 0.5 * x[:, 1]
                    + rng.normal(scale=0.3, size=n), [-0.6, 0.6])
    return x, y.astype(np.float32)


def make_ranking(queries=60, docs=10, f=8, seed=5):
    rng = np.random.default_rng(seed)
    n = queries * docs
    x = rng.normal(size=(n, f)).astype(np.float32)
    util = x @ rng.normal(size=f) + rng.normal(scale=1.0, size=n)
    rel = np.digitize(util, np.quantile(util, [0.5, 0.8, 0.95]))
    return x, rel.astype(np.float32), np.repeat(np.arange(queries), docs)


def dense_to_coo(x: np.ndarray):
    """Dense [n, F] → padded-COO (indices, values) with -1/0 padding
    (``tests/test_lightgbm_sparse.py``'s helper)."""
    n, F = x.shape
    nnz = x != 0
    W = max(int(nnz.sum(1).max()), 1)
    indices = np.full((n, W), -1, np.int32)
    values = np.zeros((n, W), np.float32)
    for r in range(n):
        cols = np.flatnonzero(nnz[r])[:W]
        indices[r, :cols.size] = cols
        values[r, :cols.size] = x[r, cols]
    return indices, values


def sparse_bench_frame():
    """``tests/test_benchmarks.py:261-271``'s sparse frame."""
    rng = np.random.default_rng(5)
    x = rng.normal(size=(1500, 16)).astype(np.float32)
    x[rng.random(x.shape) > 0.4] = 0.0
    y = ((x[:, 0] * 2 - x[:, 1] + x[:, 2]
          + rng.normal(scale=0.3, size=1500)) > 0).astype(np.float32)
    idx, val = dense_to_coo(x)
    return idx, val, y


def grid_problem(n=1203, F=10, B=16, seed=0):
    """Binned rows (slot 1 categorical), gradients and hessians on the
    grid, and the same rows as padded COO (zeros implicit)."""
    rng = np.random.default_rng(seed)
    bins = rng.integers(0, B, size=(n, F)).astype(np.uint8)
    bins[:, 1] = rng.integers(1, 9, size=n)
    g = on_grid(rng.normal(size=n) + (bins[:, 0] > B // 2)
                - np.isin(bins[:, 1], [2, 5, 7]))
    h = on_grid(rng.uniform(0.1, 1.0, size=n))
    return bins, g, h


# ----------------------------------------------------------------- growers
def grow_dense(bins, g, h, rm, group, **kw):
    from mmlspark_torch.lightgbm.engine import TreeParams, grow_tree
    F = bins.shape[1]
    p = TreeParams(num_leaves=15, max_bin=15, min_data_in_leaf=5,
                   cat_features=(1,), **kw)
    tree, leaf = grow_tree(
        torch.from_numpy(bins), torch.from_numpy(g), torch.from_numpy(h),
        torch.ones(F, dtype=torch.bool), torch.from_numpy(rm), params=p,
        num_features=F, group=group)
    return tree.to_numpy(), leaf


def sparse_binned(bins):
    """``bins`` as binned COO: bin 0 of every feature is its implicit
    zero bin, the rest explicit entries."""
    from mmlspark_torch.lightgbm.sparse import SparseBinned
    n, F = bins.shape
    idx = np.where(bins > 0, np.arange(F)[None, :], -1)
    return SparseBinned(torch.from_numpy(idx.astype(np.int64)),
                        torch.from_numpy(bins.astype(np.int64)),
                        torch.zeros(F, dtype=torch.int64))


def grow_sparse(bins, g, h, rm, group, **kw):
    from mmlspark_torch.lightgbm.engine import TreeParams
    from mmlspark_torch.lightgbm.sparse import grow_tree_sparse
    F = bins.shape[1]
    p = TreeParams(num_leaves=15, max_bin=15, min_data_in_leaf=5,
                   cat_features=(1,), **kw)
    tree, leaf = grow_tree_sparse(
        *sparse_binned(bins), torch.from_numpy(g), torch.from_numpy(h),
        torch.ones(F, dtype=torch.bool), torch.from_numpy(rm), params=p,
        num_features=F, num_bins=16, group=group)
    return tree.to_numpy(), leaf


def gather_rows(t: torch.Tensor, group, n: int) -> np.ndarray:
    """Every rank's block of a per-row tensor, assembled (an all_reduce
    of a zero-filled full-length buffer)."""
    from mmlspark_torch.parallel.collectives import (allreduce, group_rank,
                                                     group_size)
    lo = group_rank(group) * (n // group_size(group))
    buf = torch.zeros(n, dtype=torch.float64)
    buf[lo:lo + t.shape[0]] = t.to(torch.float64)
    return allreduce(buf, group).numpy()


def sharded_growth(group, modes=("data",)) -> dict:
    """The grid problem's dense and sparse trees grown over ``group``,
    with each tree's all-reduce calls and bytes, and the per-row leaves."""
    from mmlspark_torch.parallel.collectives import (allreduce, group_rank,
                                                     group_size)
    from mmlspark_torch.parallel.sharding import pad_rows
    bins, g, h = grid_problem()
    ranks, r = group_size(group), group_rank(group)
    (bp, gp, hp), mask = pad_rows([bins, g, h], ranks)
    nl = len(mask) // ranks
    sl = slice(r * nl, (r + 1) * nl)
    out = {}
    for kind, grow in (("dense", grow_dense), ("sparse", grow_sparse)):
        for mode in modes:
            calls, nbytes = allreduce.calls, allreduce.bytes
            tree, leaf = grow(bp[sl], gp[sl], hp[sl], mask[sl], group,
                              parallelism=mode, top_k=2)
            comm = (allreduce.calls - calls, allreduce.bytes - nbytes)
            out[kind, mode] = dict(
                tree=tree, comm=comm,
                leaf=gather_rows(leaf, group, len(mask))[:len(g)])
    return out


# -------------------------------------------------------------------- fits
def logistic_fobj(scores, y, w):
    """A custom objective (binary log loss), which sees every row."""
    p = torch.sigmoid(scores)
    return (p - y) * w, p * (1 - p) * w


def fit(est_name, cols, **kw):
    import mmlspark_torch.lightgbm as tl
    from mmlspark_torch.core import DataFrame
    return getattr(tl, est_name)(device="cpu", **kw).fit(DataFrame(cols))


def outputs(model, cols):
    from mmlspark_torch.core import DataFrame
    out = model.transform(DataFrame(cols))
    col = "probability" if "probability" in out.columns else "prediction"
    return np.asarray(out[col])


def binary_fits(shards: int, **extra) -> dict:
    """The distributed test's binary frame: data parallel, voting on its
    wide frame, bagging with feature sampling, GOSS, DART, a custom
    objective, a two-batch continuation with an init-score column."""
    x, y = make_binary()
    cols = {"features": x, "label": y}
    kw = dict(numIterations=30, numLeaves=15, numShards=shards, **extra)
    out = {"data": outputs(fit("LightGBMClassifier", cols, **kw), cols)}
    xw, yw = make_binary(n=1600, f=40, seed=5)
    wide = {"features": xw, "label": yw}
    for mode, vkw in (("data_wide", {}),
                      ("voting_wide", dict(VOTE_KW, topK=8))):
        model = fit("LightGBMClassifier", wide,
                    **dict(kw, numIterations=15), **vkw)
        out[mode] = outputs(model, wide)
        out[mode + "_booster"] = model.booster
    short = dict(kw, numIterations=10)
    bagged = fit("LightGBMClassifier", cols, baggingFraction=0.8,
                 baggingFreq=1, featureFraction=0.7, **short)
    out["bagging"] = outputs(bagged, cols)
    out["bagging_booster"] = bagged.booster
    out["goss"] = outputs(fit("LightGBMClassifier", cols,
                              boostingType="goss", **short), cols)
    out["dart"] = outputs(fit("LightGBMClassifier", cols,
                              boostingType="dart", **short), cols)
    out["fobj"] = outputs(fit("LightGBMClassifier", cols,
                              fobj=logistic_fobj, **short), cols)
    s = np.random.default_rng(3).normal(scale=0.5, size=len(y)) \
        .astype(np.float32)
    out["batches_init"] = outputs(fit(
        "LightGBMClassifier", dict(cols, s=s), numBatches=2,
        initScoreCol="s", **dict(short, numIterations=5)), cols)
    return out


def breadth_fits(shards: int) -> dict:
    """Multiclass, the ranker and the sparse bands' fits."""
    xm, ym = make_multiclass()
    mc = {"features": xm, "label": ym}
    out = {"multiclass": outputs(fit(
        "LightGBMClassifier", mc, objective="multiclass", numIterations=10,
        numLeaves=7, numShards=shards), mc)}
    xr, rel, qid = make_ranking()
    rk = {"features": xr, "label": rel, "query": qid}
    out["ranker"] = outputs(fit(
        "LightGBMRanker", rk, groupCol="query", numIterations=10,
        numLeaves=7, minDataInLeaf=5, numShards=shards), rk)
    idx, val, y = sparse_bench_frame()
    sp = {"features_indices": idx, "features_values": val, "label": y}
    kw = dict(numIterations=30, numLeaves=15, minDataInLeaf=5,
              numShards=shards, seed=0)
    out["sparse_data"] = outputs(fit("LightGBMClassifier", sp, **kw), sp)
    model = fit("LightGBMClassifier", sp, **kw, **VOTE_KW)
    out["sparse_voting"] = outputs(model, sp)
    out["sparse_voting_booster"] = model.booster
    return out


# --------------------------------------------------------------- scenarios
def scenario_one_rank() -> dict:
    """World of one: voting over a real group of one rank."""
    return sharded_growth(dist.group.WORLD, modes=("data", "voting"))


def scenario_two_ranks() -> dict:
    import mmlspark_torch.lightgbm as tl
    from mmlspark_torch.parallel.collectives import allreduce
    out = {"growth": sharded_growth(dist.group.WORLD,
                                    modes=("data", "voting"))}
    x = torch.tensor([1.0, -2.0, 3.0]) * (dist.get_rank() + 1)
    out["sum"] = allreduce(x, dist.group.WORLD).tolist()
    out["sum_left"] = x.tolist()
    clf = tl.LightGBMClassifier()
    out["auto"] = (clf._training_group(100), clf._training_group(10_000)
                   is dist.group.WORLD)
    out["binary"] = binary_fits(2)
    out["breadth"] = breadth_fits(2)
    return out


def scenario_four_ranks() -> dict:
    """Flat group against the two-level (2 hosts x 2 ranks) mesh and two
    blocks of 2 ranks, and the distributed test's uneven padding (1,203
    rows over 4 ranks)."""
    from mmlspark_torch.parallel.collectives import allreduce, shard_group
    mesh = shard_group(4, ("slice", "dp"))
    calls = allreduce.calls
    x = torch.tensor([1.0, -2.0, 3.0]) * (dist.get_rank() + 1)
    mesh_sum = (allreduce(x, mesh).tolist(), allreduce.calls - calls)
    both = ("data", "voting")
    out = {"growth": sharded_growth(dist.group.WORLD, modes=both),
           "mesh_growth": sharded_growth(mesh, modes=both),
           "mesh_shape": tuple(mesh.shape), "mesh_sum": mesh_sum}
    x, y = make_binary(n=1203)
    cols = {"features": x, "label": y}
    kw = dict(numIterations=15, numLeaves=15, numShards=4)
    out["flat"] = outputs(fit("LightGBMClassifier", cols, **kw), cols)
    out["two_level"] = outputs(fit("LightGBMClassifier", cols,
                                   shardAxisName="slice,dp", **kw), cols)
    # numShards=2 of 4 ranks: two blocks of 2 ranks, each its own group
    out["blocks"] = outputs(fit("LightGBMClassifier", cols,
                                **dict(kw, numShards=2)), cols)
    return out


SCENARIOS = {"one_rank": scenario_one_rank, "two_ranks": scenario_two_ranks,
             "four_ranks": scenario_four_ranks}


# ------------------------------------------------------------------ launch
def _rank_main(rank, world, port, scenario, out_path, env):
    os.environ.update(env)
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    try:
        result = SCENARIOS[scenario]()
        if rank == 0:
            with open(out_path, "wb") as f:
                pickle.dump(result, f)
    finally:
        dist.destroy_process_group()


def spawn(scenario: str, world: int, env: dict | None = None):
    """Run ``scenario`` on ``world`` gloo ranks; returns rank 0's result.
    Raises if a rank fails or the ranks outlast ``SPAWN_TIMEOUT``."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(env or {}, OMP_NUM_THREADS="1")
    with tempfile.TemporaryDirectory() as d:
        out_path = os.path.join(d, "result.pkl")
        ctx = mp.start_processes(
            _rank_main, args=(world, port, scenario, out_path, env),
            nprocs=world, join=False, start_method="spawn")
        deadline = time.monotonic() + SPAWN_TIMEOUT
        try:
            # join() returns once a rank ends (raising if it failed), True
            # when every rank has
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
