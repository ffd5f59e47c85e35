"""TPUModel — the DL inference transformer, the port of
``mmlspark_tpu/dl/model.py`` (the class keeps its name: saved stages carry
it).

Reference ``cntk/CNTKModel.scala:145-543``: minibatch rows, run the model,
unbatch, coerce to vectors. Here the model is a ``LoadedModel`` from the zoo
(or any ``nn.Module`` returning a dict of named endpoints), on the stage's
``device``:

- ``fetchDict``/``outputNode`` map named endpoints to output columns;
- the column is chunked to ``minibatchSize`` rows and the tail zero-padded
  to the same shape, the padding dropped on output;
- ``transferDtype`` picks the host→device wire dtype: ``auto`` and
  ``uint8`` keep a uint8 column uint8, ``bfloat16`` also narrows floats on
  the host (in torch, round to nearest even), ``float32`` always widens;
- ``pipelineDepth`` (>= 2) batches are dispatched before the oldest is
  drained, so the device computes while the host copies;
- ``last_stats`` times the last transform: ``prep_ms`` (host coercion),
  ``dispatch_ms`` (slicing, padding, the upload and the queued forward),
  ``drain_ms`` (waiting for the device and copying outputs back),
  ``total_ms``;
- the module is moved to the device once per model identity and reused,
  so weight updates arrive by reassigning ``model``.
"""

from __future__ import annotations

import copy
import time

import numpy as np
import torch

from ..core import ComplexParam, Model, Param, TypeConverters as TC
from ..core.contracts import HasDevice, HasInputCol, HasOutputCol
from ..models.zoo import LoadedModel

WIRE_DTYPES = ("auto", "uint8", "bfloat16", "float32")


class TPUModel(Model, HasInputCol, HasOutputCol, HasDevice):
    """Run a model over a feature or image column on the stage's device."""

    model = ComplexParam("model", "LoadedModel or nn.Module")
    fetchDict = Param("fetchDict", "endpoint name -> output column",
                      TC.identity, default=None, has_default=True)
    minibatchSize = Param("minibatchSize", "device batch size", TC.toInt,
                          default=64, has_default=True)
    outputNode = Param("outputNode", "single endpoint to fetch",
                       TC.toString, default="pooled", has_default=True)
    convertOutputToDenseVector = Param(
        "convertOutputToDenseVector",
        "flatten non-vector outputs to 2-D float vectors", TC.toBoolean,
        default=True, has_default=True)
    inputShape = Param("inputShape", "per-row input shape (tuple), e.g. "
                       "(224, 224, 3) for NHWC images", TC.identity,
                       default=None, has_default=True)
    transferDtype = Param(
        "transferDtype",
        "host->device wire dtype: 'auto' keeps uint8 columns as uint8 "
        "(4x fewer bytes than float32; the model's on-device cast "
        "handles widening), 'uint8' ditto (explicit), 'bfloat16' "
        "additionally halves float transfer — lossless when the "
        "model's first op casts to bf16 anyway — and 'float32' always "
        "widens on host", TC.toString, default="auto", has_default=True)
    pipelineDepth = Param(
        "pipelineDepth",
        "max in-flight dispatched batches before draining (>= 2). The "
        "default keeps one batch computing while one drains; raise it "
        "so more transfers overlap each round trip — at the cost of "
        "holding that many batches' outputs in device memory",
        TC.toInt, default=2, has_default=True)

    # class-level fallbacks: load_stage rebuilds stages without __init__
    _run_cache = None
    last_stats: dict | None = None

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self._setDefault(inputCol="features", outputCol="output")

    def _module(self, dev: torch.device) -> torch.nn.Module:
        """The model on ``dev`` in eval mode, once per (model, device): a
        model on another device is copied there, the caller's left as it
        is."""
        m = self.get("model")
        module = m.module if isinstance(m, LoadedModel) else m
        key = (id(module), dev)
        if self._run_cache is None or self._run_cache[0] != key:
            first = next(module.parameters(), None)
            if first is None:
                first = next(module.buffers(), None)
            here = first is None or first.device == dev
            run = (module if here else copy.deepcopy(module).to(dev)).eval()
            # the source stays referenced, so its id cannot be reused
            self._run_cache = (key, run, module)
        return self._run_cache[1]

    def _transform(self, df):
        t_start = time.perf_counter()
        dev = self._device()
        x = self._coerce_input(df[self.getInputCol()])
        prep_ms = (time.perf_counter() - t_start) * 1e3
        n = x.shape[0]
        bs = self.get("minibatchSize")
        module = self._module(dev)
        fetch = self.get("fetchDict") or {
            self.get("outputNode"): self.getOutputCol()}
        depth = int(self.get("pipelineDepth"))
        if depth < 2:
            raise ValueError(
                f"pipelineDepth={depth} must be >= 2 (one batch computing "
                "while one drains); there is no synchronous mode")
        chunks: dict[str, list[np.ndarray]] = {k: [] for k in fetch}
        dispatch_ms = drain_ms = 0.0

        def drain(entry):
            nonlocal drain_ms
            t0 = time.perf_counter()
            real, out = entry
            for endpoint in fetch:
                chunks[endpoint].append(
                    out[endpoint][:real].float().cpu().numpy())
            drain_ms += (time.perf_counter() - t0) * 1e3

        inflight: list[tuple[int, dict]] = []
        with torch.inference_mode():
            for start in range(0, n, bs):
                t0 = time.perf_counter()
                piece = x[start:start + bs]
                real = piece.shape[0]
                if real < bs:                  # pad the tail to the shape
                    piece = torch.cat([piece, piece.new_zeros(
                        (bs - real,) + tuple(piece.shape[1:]))])
                if dev.type == "cuda":
                    piece = piece.pin_memory()
                out = module(piece.to(dev, non_blocking=True), False)
                if not isinstance(out, dict):
                    out = {self.get("outputNode"): out}
                for endpoint in fetch:
                    if endpoint not in out:
                        raise KeyError(
                            f"endpoint {endpoint!r} not in model outputs "
                            f"{sorted(out)}")
                inflight.append((real, out))
                dispatch_ms += (time.perf_counter() - t0) * 1e3
                if len(inflight) >= depth:
                    drain(inflight.pop(0))
            for entry in inflight:
                drain(entry)

        for endpoint, out_col in fetch.items():
            val = np.concatenate(chunks[endpoint]) if chunks[endpoint] \
                else np.zeros((0,), np.float32)
            if self.get("convertOutputToDenseVector") and val.ndim > 2:
                val = val.reshape(val.shape[0], -1)
            df = df.with_column(out_col, val.astype(np.float32))
        self.last_stats = {
            "prep_ms": round(prep_ms, 3),
            "dispatch_ms": round(dispatch_ms, 3),
            "drain_ms": round(drain_ms, 3),
            "total_ms": round((time.perf_counter() - t_start) * 1e3, 3),
        }
        return df

    def _coerce_input(self, col) -> torch.Tensor:
        """The column as one host tensor in the wire dtype."""
        mode = self.get("transferDtype")
        if mode not in WIRE_DTYPES:
            raise ValueError(f"unknown transferDtype {mode!r}; expected "
                             f"{'|'.join(WIRE_DTYPES)}")
        if isinstance(col, np.ndarray) and col.dtype != object:
            # uint8 survives every narrowing mode: bfloat16 would double a
            # uint8 column's wire bytes if it forced the float path
            keep_u8 = mode != "float32" and col.dtype == np.uint8
            x = col if keep_u8 else np.asarray(col, np.float32)
        else:
            x = np.stack([np.asarray(a, np.float32) for a in col])
        x = torch.from_numpy(np.ascontiguousarray(x))
        if mode == "bfloat16" and x.dtype == torch.float32:
            x = x.to(torch.bfloat16)
        shape = self.get("inputShape")
        if shape is not None and x.ndim == 2:
            # unrolled CHW vectors → NHWC images (undo UnrollImage)
            H, W, C = shape
            x = x.reshape(x.shape[0], C, H, W).permute(0, 2, 3, 1) \
                .contiguous()
        return x
