"""LambdaRank gradients + NDCG — the ranking objective.

Reference: ``LightGBMRanker`` delegates lambdarank to native LightGBM
(``lightgbm/LightGBMRanker.scala:80-110``; group cardinality run-length
encoding at ``TrainUtils.scala:260-282``). The port of
``mmlspark_tpu/lightgbm/ranker_objective.py``: groups are padded to a fixed
width S, so the pairwise lambdas of a group are one dense [S, S] tensor
(ragged query groups become a masked rectangle), and groups are taken in
chunks of [chunk, S, S] to bound memory. The chunk loop runs on the host;
each chunk's math runs on the scores' device. Both rank sorts are stable,
as ``jnp.argsort`` is: at iteration 0 every score of a group ties, and the
tie order decides each document's discount.
"""

from __future__ import annotations

import numpy as np
import torch


def build_group_index(group_ids: np.ndarray,
                      max_group_size: int | None = None) -> np.ndarray:
    """Host-side: group id per row → padded row-index matrix [G, S].

    Rows beyond a group's size are -1. Groups larger than max_group_size
    are truncated for gradient computation (LightGBM's truncation_level
    plays a similar capping role).
    """
    order = np.argsort(group_ids, kind="stable")
    sorted_gids = group_ids[order]
    boundaries = np.flatnonzero(np.diff(sorted_gids)) + 1
    groups = np.split(order, boundaries)
    S = max(len(g) for g in groups)
    if max_group_size is not None:
        S = min(S, max_group_size)
    G = len(groups)
    idx = np.full((G, S), -1, dtype=np.int32)
    for i, g in enumerate(groups):
        take = g[:S]
        idx[i, :len(take)] = take
    return idx


def _dcg_discount(ranks: torch.Tensor) -> torch.Tensor:
    return 1.0 / torch.log2(ranks + 2.0)


def make_lambdarank_grad_hess(labels: np.ndarray, group_index: np.ndarray,
                              sigmoid: float = 1.0,
                              truncation_level: int = 30,
                              chunk: int = 256):
    """Returns fn(scores [n] tensor) -> (grad [n], hess [n]) on the scores'
    device.

    Per group: for each pair (i, j) with label_i > label_j,
    lambda = -sigma * rho * |dNDCG|, rho = 1/(1+exp(sigma (s_i - s_j))),
    hess = sigma^2 rho (1-rho) |dNDCG|, accumulated into both rows.
    """
    labels = np.asarray(labels, np.float32)
    n = labels.shape[0]
    G, S = group_index.shape
    trunc = min(truncation_level, S)
    consts: dict = {}

    def setup(dev: torch.device) -> dict:
        """The per-group constants on ``dev``, built once per device."""
        if dev in consts:
            return consts[dev]
        gidx = torch.as_tensor(group_index, device=dev).to(torch.int64)
        valid = gidx >= 0
        safe_idx = torch.where(valid, gidx, 0)
        lab = torch.as_tensor(labels, device=dev)[safe_idx]
        lab = torch.where(valid, lab, -1.0)
        gains = torch.where(valid, 2.0 ** lab - 1.0, 0.0)
        # ideal DCG per group (gains sorted descending), truncated
        sorted_gains = torch.sort(gains, dim=1).values.flip(1)
        pos = torch.arange(S, dtype=torch.float32, device=dev)
        disc_all = _dcg_discount(pos) * (pos < trunc)
        idcg = (sorted_gains * disc_all[None, :]).sum(dim=1)
        inv_idcg = torch.where(idcg > 0,
                               1.0 / torch.clamp(idcg, min=1e-12), 0.0)
        consts[dev] = dict(valid=valid, safe_idx=safe_idx, lab=lab,
                           gains=gains, inv_idcg=inv_idcg)
        return consts[dev]

    def group_chunk_grads(scores, lab, gains, valid, inv_idcg, safe_idx):
        s = torch.where(valid, scores[safe_idx], float("-inf"))
        # current rank of each document within its group
        order = torch.argsort(-s, dim=1, stable=True)
        ranks = torch.argsort(order, dim=1, stable=True).to(torch.float32)
        disc = _dcg_discount(ranks) * (ranks < trunc)
        # pairwise deltas [g, S, S]
        sdiff = s[:, :, None] - s[:, None, :]
        rho = torch.sigmoid(-sigmoid * sdiff)
        dgain = torch.abs(gains[:, :, None] - gains[:, None, :])
        ddisc = torch.abs(disc[:, :, None] - disc[:, None, :])
        dndcg = dgain * ddisc * inv_idcg[:, None, None]
        better = (lab[:, :, None] > lab[:, None, :]) \
            & valid[:, :, None] & valid[:, None, :]
        lam = torch.where(better, -sigmoid * rho * dndcg, 0.0)
        hes = torch.where(better,
                          sigmoid * sigmoid * rho * (1.0 - rho) * dndcg, 0.0)
        g_doc = lam.sum(dim=2) - lam.sum(dim=1)
        h_doc = hes.sum(dim=2) + hes.sum(dim=1)
        return g_doc, h_doc

    def grad_hess(scores: torch.Tensor):
        c = setup(scores.device)
        grad = torch.zeros(n, dtype=torch.float32, device=scores.device)
        hess = torch.zeros(n, dtype=torch.float32, device=scores.device)
        for start in range(0, G, chunk):
            sl = slice(start, min(start + chunk, G))
            g_doc, h_doc = group_chunk_grads(
                scores, c["lab"][sl], c["gains"][sl], c["valid"][sl],
                c["inv_idcg"][sl], c["safe_idx"][sl])
            flat_idx = c["safe_idx"][sl].reshape(-1)
            mask = c["valid"][sl].reshape(-1)
            grad.index_add_(0, flat_idx,
                            torch.where(mask, g_doc.reshape(-1), 0.0))
            hess.index_add_(0, flat_idx,
                            torch.where(mask, h_doc.reshape(-1), 0.0))
        return grad, hess

    return grad_hess


def ndcg_at_k(scores: np.ndarray, labels: np.ndarray,
              group_ids: np.ndarray, k: int = 10) -> float:
    """Mean NDCG@k over query groups (evaluation metric; host numpy, the
    JAX package's code)."""
    total, count = 0.0, 0
    for gid in np.unique(group_ids):
        m = group_ids == gid
        s, l = scores[m], labels[m]
        order = np.argsort(-s)
        gains = (2.0 ** l[order] - 1.0)[:k]
        disc = 1.0 / np.log2(np.arange(len(gains)) + 2.0)
        dcg = float((gains * disc).sum())
        ideal = np.sort(l)[::-1]
        igains = (2.0 ** ideal - 1.0)[:k]
        idisc = 1.0 / np.log2(np.arange(len(igains)) + 2.0)
        idcg = float((igains * idisc).sum())
        if idcg > 0:
            total += dcg / idcg
            count += 1
    return total / max(count, 1)
