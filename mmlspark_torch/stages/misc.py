"""Data-shaping and profiling stages.

Reference ``stages/``: SummarizeData, ClassBalancer, StratifiedRepartition,
EnsembleByKey, TextPreprocessor, UnicodeNormalize (SURVEY §2.9).

The port of ``mmlspark_tpu/stages/misc.py``'s eager paths. The shuffle of
``StratifiedRepartition`` and the group means of ``EnsembleByKey`` run in
torch on the stage's ``device``; profiling, class weights and string
normalization are host work, as there.
"""

from __future__ import annotations

import re
import unicodedata

import numpy as np

import torch

from ..core import DataFrame, Estimator, Model, Transformer, Param, \
    TypeConverters as TC
from ..core.contracts import (HasDevice, HasInputCol, HasLabelCol,
                              HasOutputCol, HasSeed)
from ..core.dataframe import (quantile_host, to_host, to_host_list,
                              unique_host)


class SummarizeData(Transformer):
    """Counts / quantiles / missing-value profile per column (reference
    ``stages/SummarizeData.scala:1-238``)."""

    counts = Param("counts", "include counts block", TC.toBoolean, default=True)
    basic = Param("basic", "include basic stats block", TC.toBoolean,
                  default=True)
    sample = Param("sample", "include quantiles block", TC.toBoolean,
                   default=True)
    percentiles = Param("percentiles", "quantiles to compute", TC.toListFloat,
                        default=[0.005, 0.01, 0.05, 0.25, 0.5, 0.75, 0.95,
                                 0.99, 0.995])
    errorThreshold = Param("errorThreshold",
                           "quantile error (parity; exact here)", TC.toFloat,
                           default=0.0)

    def _transform(self, df):
        rows = []
        for col in df.columns:
            arr = df[col]
            row = {"Feature": col}
            numeric = arr.dtype.kind in "iuf" and arr.ndim == 1
            hostlike = arr.dtype == object or arr.dtype.kind in "MmUS"
            valid = None
            if numeric:
                # profiling output, not device math: stats stay on host
                # in the column's own dtype so float64 columns don't
                # merge distinct values (or degrade mean/quantiles)
                # through the device's 32-bit lattice
                x = to_host(arr)
                nan = x != x
                valid = x[~nan]
            if self.getCounts():
                row["Count"] = float(len(arr))
                if hostlike:
                    row["Unique Value Count"] = float(
                        len({str(v) for v in arr}))
                    row["Missing Value Count"] = float(
                        sum(v is None for v in arr)) \
                        if arr.dtype == object else 0.0
                elif numeric:
                    row["Unique Value Count"] = float(
                        unique_host(valid).size)
                    row["Missing Value Count"] = float(nan.sum())
                else:
                    row["Unique Value Count"] = float(
                        unique_host(to_host(arr)).size)
                    row["Missing Value Count"] = 0.0
            if self.getBasic():
                if numeric and valid.size:
                    row.update({
                        "Mean": float(valid.mean()),
                        "Std": float(valid.std(ddof=1))
                        if valid.size > 1 else np.nan,
                        "Min": float(valid.min()),
                        "Max": float(valid.max())})
                else:
                    row.update({"Mean": np.nan, "Std": np.nan,
                                "Min": np.nan, "Max": np.nan})
            if self.getSample():
                for p in self.getPercentiles():
                    row[f"Quantile_{p}"] = quantile_host(valid, p) \
                        if numeric and valid.size else np.nan
            rows.append(row)
        return DataFrame.from_rows(rows)


class ClassBalancer(Estimator, HasInputCol):
    """Compute per-class weights inversely proportional to frequency
    (reference ``stages/ClassBalancer.scala``)."""

    outputCol = Param("outputCol", "weight column", TC.toString,
                      default="weight")
    broadcastJoin = Param("broadcastJoin", "parity flag", TC.toBoolean,
                          default=True)

    def _fit(self, df):
        col = df[self.getInputCol()]
        if col.dtype == object:
            counts: dict[str, int] = {}
            for v in col:
                counts[str(v)] = counts.get(str(v), 0) + 1
        else:
            # EXACT host uniqueness: weight keys are str(value) and
            # _transform looks up str() of the exact column values — a
            # device round-trip would store float32-rounded keys that
            # the lookup then misses (unique_host's docstring)
            values, cnts = unique_host(col, return_counts=True)
            counts = {str(v): int(c)
                      for v, c in zip(to_host_list(values),
                                      to_host_list(cnts))}
        top = max(counts.values())
        model = ClassBalancerModel().setWeights(
            {k: float(top) / c for k, c in counts.items()})
        self._copy_params_to(model)
        return model


class ClassBalancerModel(Model, HasInputCol):
    weights = Param("weights", "class → weight", TC.toDict)
    outputCol = Param("outputCol", "weight column", TC.toString,
                      default="weight")

    def _transform(self, df):
        w = self.getWeights()
        col = df[self.getInputCol()]
        # look up str() of the same Python values fit stored: str(numpy
        # float32 scalar) is the SHORT repr ('0.1') while fit's keys
        # came from to_host_list (Python floats → '0.10000000149…')
        vals = col if col.dtype == object else to_host_list(col)
        return df.with_column(self.getOutputCol(),
                              [w[str(v)] for v in vals])


class StratifiedRepartition(Transformer, HasLabelCol, HasSeed, HasDevice):
    """Rebalance rows across partitions so every partition sees every label
    (reference ``stages/StratifiedRepartition.scala:1-82``). Matters here for
    the same reason as the reference: distributed GBDT shards must all hold
    examples of each class or their histogram collectives degrade.

    Each label's rows are shuffled by ``torch.randperm`` on the stage's
    ``device`` from one ``torch.Generator`` seeded from ``seed`` (the JAX
    package draws ``jax.random.permutation``: the same invariants, another
    order), then interleaved round-robin."""

    mode = Param("mode", "equal | original | mixed", TC.toString,
                 default="mixed")

    def _transform(self, df):
        dev = self._device()
        labels = df[self.getLabelCol()]
        groups: dict[str, list[int]] = {}
        for i, v in enumerate(labels):
            groups.setdefault(str(v), []).append(i)
        gen = torch.Generator(device=dev).manual_seed(self.getSeed())
        pools = []
        for k in sorted(groups):
            idx = torch.as_tensor(groups[k], dtype=torch.int64, device=dev)
            perm = torch.randperm(len(idx), generator=gen, device=dev)
            pools.append(to_host_list(idx[perm]))
        order: list[int] = []
        # Round-robin interleave per label so contiguous block
        # partitioning gives each partition a balanced label mix.
        while any(pools):
            for pool in pools:
                if pool:
                    order.append(pool.pop())
        return df.take(order)


class EnsembleByKey(Transformer, HasDevice):
    """Group rows by key columns and average vector/score columns (reference
    ``stages/EnsembleByKey.scala``). Groups form on the host by a dict over
    the key tuples; each column's group means are one ``index_add_`` of its
    float32 rows on the stage's ``device``."""

    keys = Param("keys", "grouping key columns", TC.toListString)
    cols = Param("cols", "columns to aggregate", TC.toListString)
    strategy = Param("strategy", "mean (only supported, as in reference)",
                     TC.toString, default="mean")
    collapseGroup = Param("collapseGroup", "one row per group", TC.toBoolean,
                          default=True)

    def _transform(self, df):
        dev = self._device()
        keys, cols = self.getKeys(), self.getCols()
        key_tuples = list(zip(*[list(df[k]) for k in keys]))
        groups: dict = {}
        gid = np.empty(len(key_tuples), np.int64)
        for i, kt in enumerate(key_tuples):
            gid[i] = groups.setdefault(kt, len(groups))
        gid_t = torch.as_tensor(gid, device=dev)
        counts = torch.zeros(len(groups), dtype=torch.float32, device=dev) \
            .index_add_(0, gid_t, torch.ones(len(gid), device=dev))
        means = {}
        for c in cols:
            arr = df[c]
            if arr.dtype == object:
                x = np.stack([np.asarray(to_host(v), np.float32)
                              for v in arr])
            else:
                x = np.asarray(arr, np.float32)
            xt = torch.as_tensor(x).to(dev)
            sums = torch.zeros((len(groups),) + xt.shape[1:],
                               dtype=torch.float32, device=dev) \
                .index_add_(0, gid_t, xt)
            means[c] = to_host(sums / counts.reshape(
                (-1,) + (1,) * (xt.dim() - 1)))
        rows = []
        for kt, g in groups.items():
            row = dict(zip(keys, kt))
            for c in cols:
                mean = means[c][g]
                row[f"mean({c})"] = float(mean) if mean.ndim == 0 else mean
            rows.append(row)
        return DataFrame.from_rows(rows)


class TextPreprocessor(Transformer, HasInputCol, HasOutputCol):
    """Trie-based string normalization map (reference
    ``stages/TextPreprocessor.scala``). Pure host string work, by
    nature."""

    map = Param("map", "substring → replacement", TC.toDict, default={},
                has_default=True)
    normFunc = Param("normFunc", "lower | upper | identity", TC.toString,
                     default="identity")

    def _transform(self, df):
        mapping = self.get("map")
        norm = {"lower": str.lower, "upper": str.upper,
                "identity": lambda s: s}[self.getNormFunc()]
        pattern = None
        if mapping:
            pattern = re.compile("|".join(
                re.escape(k) for k in sorted(mapping, key=len, reverse=True)))
        col = df[self.getInputCol()]
        out = []
        for v in col:
            s = norm(v) if v is not None else v
            if s is not None and pattern is not None:
                s = pattern.sub(lambda m: mapping[m.group(0)], s)
            out.append(s)
        return df.with_column(self.getOutputCol(), out)


class UnicodeNormalize(Transformer, HasInputCol, HasOutputCol):
    """Unicode NFC/NFKC/... normalization (reference
    ``stages/UnicodeNormalize.scala``). Host string work, like
    TextPreprocessor."""

    form = Param("form", "NFC | NFD | NFKC | NFKD", TC.toString,
                 default="NFKC")
    lower = Param("lower", "lowercase after normalizing", TC.toBoolean,
                  default=True)

    def _transform(self, df):
        form, lower = self.getForm(), self.getLower()
        col = df[self.getInputCol()]
        out = []
        for v in col:
            if v is None:
                out.append(None)
            else:
                s = unicodedata.normalize(form, v)
                out.append(s.lower() if lower else s)
        return df.with_column(self.getOutputCol(), out)
