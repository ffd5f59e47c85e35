"""Masked-LM and causal-LM pretraining of the text encoder.

The port of ``mmlspark_tpu/dl/pretrain.py``: BERT-style masked-token
prediction (``pretrain_masked_lm``) or next-token prediction
(``pretrain_causal_lm``) over token-id rows produces encoder weights in the
framework, which ``TextEncoderFeaturizer(model=LoadedModel(...))`` or
``dl.generate`` then serve. Batches are host-side numpy, drawn from the same
``np.random.default_rng(seed)`` in the same order as the JAX package, so
both packages train on identical batches; batches stream through
``train_epoch``'s overlapped copy loop.

With an encoder built on ``make_attention_fn("pallas")``, every block's
forward runs the flash forward that saves the lse (K2b) and its backward
the fused backward kernels (K2d, K2e); with ``make_attention_fn("pallas",
causal=True)`` their causal branches (K2c-lse, causal K2d and K2e).

Idiom: flax keeps parameters apart from the module, and
``pretrain_masked_lm`` there draws them from ``PRNGKey(seed)`` and returns
them in a new train state. A torch module carries its parameters: here a
``MaskedLMModel`` is built with weights drawn from a ``torch.Generator``
seeded from ``seed`` (flax's distributions, not its bits), or passed in
ready-made (``models.masked_lm_from_flax`` carries the JAX package's
weights across), and training updates it in place.

``MaskedLMModel`` also carries the cached-decoding entry points
(``decode_step``, ``prefill``, ``decode_window``) that ``dl.generate`` and
the paged engine run, and :func:`assert_causal` is the causality probe that
guards them.

Not ported yet: ``mesh`` and ``dtype_policy`` (the parallel slice, item
10).
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from .text_encoder import Dense, TextEncoder
from .train import TrainState, make_train_step, train_epoch

LATER_MESH = ("pretraining over a mesh (mesh, dtype_policy) comes with the "
              "parallel slice (ROADMAP.md §1 item 10)")


class MaskedLMModel(nn.Module):
    """Encoder trunk + token-level LM head: ids ``[N, T]`` →
    ``{"logits": [N, T, V] f32, "tokens", "pooled"}``. The head is flax's
    ``nn.Dense(vocab, dtype=float32)``: an f32 ``[V, W]`` weight drawn
    truncated lecun-normal from ``generator``, and a zero bias; the trunk
    keeps the weights it was built with. Parameters are named
    ``encoder.*`` and ``lm_head.*``, so the trunk lifts out whole
    (:func:`encoder_variables`)."""

    def __init__(self, encoder: TextEncoder,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.encoder = encoder
        self.lm_head = Dense(encoder.width, encoder.vocab, torch.float32)
        self.lm_head.reset_parameters(generator)
        self.lm_head.to(next(encoder.parameters()).device)

    def forward(self, ids, train: bool = False):
        out = self.encoder(ids, train)
        return {"logits": self.lm_head(out["tokens"]), **out}

    def decode_step(self, tok, caches, pos: int):
        """One cached step: [B] token ids at position ``pos`` → [B, V]
        logits; the per-block caches are written in place."""
        x = self.encoder.embed_token(tok, pos)
        return self.lm_head(self.encoder.decode_blocks(x, caches, pos))[:, 0]

    def prefill(self, ids_prefix, caches):
        """Seed the caches for positions ``[0, P)`` in one causal forward
        (``TextEncoder.prefill_caches``); returns them."""
        return self.encoder.prefill_caches(ids_prefix, caches)

    def decode_window(self, toks, caches, pos):
        """[B, w] token ids at positions ``[pos, pos + w)`` → [B, w, V]
        logits, the caches written in place (speculative verification).
        ``pos``: an int, or a [B] tensor of per-row starts (the engine's
        dense re-gather mode)."""
        x = self.encoder.embed_window(toks, pos)
        return self.lm_head(self.encoder.decode_window_blocks(x, caches, pos))


def masked_xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Cross-entropy over positions with ``labels >= 0`` (−1 = ignore:
    unmasked or pad), in f32. Mean over the masked positions only."""
    valid = labels >= 0
    logp = F.log_softmax(logits.float(), dim=-1)
    ll = logp.gather(-1, labels.clamp_min(0).long()[..., None])[..., 0]
    return -(ll * valid).sum() / valid.sum().clamp_min(1)


def mask_batch(ids: np.ndarray, rng: np.random.Generator, *,
               mask_id: int, mask_frac: float = 0.15,
               pad_id: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """BERT-style corruption: ``mask_frac`` of non-pad positions are
    replaced by ``mask_id``; labels carry the original id there and −1
    everywhere else. The JAX package's function, draw for draw."""
    maskable = ids != pad_id
    pick = (rng.random(ids.shape) < mask_frac) & maskable
    x = np.where(pick, mask_id, ids).astype(np.int32)
    y = np.where(pick, ids, -1).astype(np.int32)
    return x, y


def default_optimizer(learning_rate: float) -> Callable:
    """The counterpart of ``optax.adamw(learning_rate)``: b1 0.9, b2 0.999,
    eps 1e-8 and weight decay 1e-4 on every parameter, decoupled and applied
    with the pre-update parameter, as optax does. (torch's AdamW defaults to
    a decay of 1e-2.)"""
    def make(params):
        return torch.optim.AdamW(params, lr=learning_rate,
                                 betas=(0.9, 0.999), eps=1e-8,
                                 weight_decay=1e-4)
    return make


def pretrain_masked_lm(encoder: TextEncoder | MaskedLMModel,
                       ids: np.ndarray, *, steps: int = 200,
                       batch_size: int = 32, learning_rate: float = 1e-3,
                       mask_frac: float = 0.15, mask_id: int | None = None,
                       seed: int = 0, optimizer: Callable | None = None,
                       device: str | torch.device | None = None,
                       mesh=None, dtype_policy=None
                       ) -> tuple[TrainState, list[float]]:
    """Pretrain ``encoder`` on token-id rows ``ids`` ``[N, T]`` (pad id 0).

    ``encoder``: a ``TextEncoder`` (with the weights it was built with), to
    which an LM head is added with weights drawn from
    ``torch.Generator().manual_seed(seed)``, or a ready ``MaskedLMModel``.
    It moves to ``device`` (CUDA unless ``"cpu"`` is asked for; without a
    GPU the default raises) and is trained in place.

    Each step draws ``batch_size`` rows with
    ``rng.integers(0, len(ids), size=batch_size)`` and masks them with
    :func:`mask_batch`, ``rng = np.random.default_rng(seed)``: the JAX
    package's batches, bit for bit. ``mask_id`` defaults to the encoder's
    top vocab slot, which the corpus must leave free.

    ``optimizer``: a function from the parameters to a
    ``torch.optim.Optimizer`` (the JAX ``tx``); the default is
    :func:`default_optimizer`, optax's ``adamw(learning_rate)``.

    Returns the train state (the model, the optimizer, the step count) and
    the per-batch losses; :func:`encoder_variables` lifts the trunk."""
    model, dev, ids = _lm_setup(encoder, ids, seed, device, mesh,
                                dtype_policy)
    vocab = model.encoder.vocab
    if mask_id is None:
        mask_id = vocab - 1
    if ids.max(initial=0) >= mask_id:
        raise ValueError(
            f"corpus uses id {ids.max()} but mask_id={mask_id}; give the "
            "encoder a spare top slot (vocab >= tokenizer vocab + 1)")
    rng = np.random.default_rng(seed)

    def batches():
        for _ in range(steps):
            rows = ids[rng.integers(0, len(ids), size=batch_size)]
            yield mask_batch(rows, rng, mask_id=mask_id,
                             mask_frac=mask_frac)

    return _train(model, dev, batches(), optimizer, learning_rate)


def _lm_setup(encoder, ids, seed, device, mesh, dtype_policy):
    """What both pretraining entry points start with: the refusals, the
    device, the token rows as int32 and the LM (``encoder`` itself when it
    is a ``MaskedLMModel``, else a new head drawn from ``seed``) on the
    device."""
    if mesh is not None or dtype_policy is not None:
        raise NotImplementedError(LATER_MESH)
    dev = resolve_device(device)
    model = encoder if isinstance(encoder, MaskedLMModel) else \
        MaskedLMModel(encoder, torch.Generator().manual_seed(seed))
    return model.to(dev), dev, np.asarray(ids, np.int32)


def _train(model, dev, batches, optimizer, learning_rate):
    """Train ``model`` in place over host batches with ``masked_xent``."""
    opt = (optimizer or default_optimizer(learning_rate))(
        list(model.parameters()))
    state = TrainState(model=model, optimizer=opt)
    step = make_train_step(model, opt, loss_fn=masked_xent, fetch="logits")
    return train_epoch(step, state, batches, device=dev)


def encoder_variables(state: TrainState) -> TextEncoder:
    """The trained encoder trunk of an LM train state: a ``TextEncoder``
    that carries its weights (the JAX function returns the trunk's
    ``{"params": ...}``; a torch module holds its own), ready for
    ``models.LoadedModel`` and ``TextEncoderFeaturizer(model=...)``."""
    return state.model.encoder


def pretrain_causal_lm(encoder: TextEncoder | MaskedLMModel,
                       ids: np.ndarray, *, steps: int = 200,
                       batch_size: int = 32, learning_rate: float = 1e-3,
                       seed: int = 0, optimizer: Callable | None = None,
                       device: str | torch.device | None = None,
                       mesh=None, dtype_policy=None
                       ) -> tuple[TrainState, list[float]]:
    """Next-token pretraining on token-id rows ``ids`` ``[N, T + 1]`` (pad
    id 0), the decoder-side twin of :func:`pretrain_masked_lm` and the port
    of the JAX function: the logits at position t predict token t + 1, and
    pad targets are ignored. ``encoder``, ``optimizer``, ``device`` and the
    return value are as for :func:`pretrain_masked_lm`.

    The encoder must run causal attention (``make_attention_fn(impl,
    causal=True)``): :func:`assert_causal` probes the first row before
    training and raises for a model that sees future positions, where the
    objective is trivially cheatable by copying the next token.

    Each step draws ``batch_size`` rows with ``rng.integers(0, len(ids),
    size=batch_size)``, ``rng = np.random.default_rng(seed)``, and trains on
    ``x = rows[:, :-1]`` against ``y = rows[:, 1:]`` with pad set to -1:
    the JAX package's batches, bit for bit. With ``pallas`` attention every
    block's forward runs K2c-lse and its backward causal K2d and K2e."""
    model, dev, ids = _lm_setup(encoder, ids, seed, device, mesh,
                                dtype_policy)
    assert_causal(model, ids[:1], model.encoder.vocab)
    rng = np.random.default_rng(seed)

    def batches():
        for _ in range(steps):
            rows = ids[rng.integers(0, len(ids), size=batch_size)]
            y = np.where(rows[:, 1:] != 0, rows[:, 1:], -1).astype(np.int32)
            yield rows[:, :-1], y

    return _train(model, dev, batches(), optimizer, learning_rate)


CAUSAL_DRIFT_MAX = 1e-4


def assert_causal(module: MaskedLMModel, sample_ids, vocab: int) -> float:
    """Causality probe: perturb the LAST position of ``sample_ids`` [1, T];
    logits at earlier positions must not move by more than 1e-4 (the JAX
    package's probe and limit). Catches a bidirectional encoder passed
    where causality is required (generation), which would otherwise
    condition on its own padding silently. Runs two forwards on the
    module's device under ``torch.inference_mode()``; returns the drift
    (0.0 when ``sample_ids`` has fewer than two positions)."""
    probe = np.asarray(sample_ids, np.int32)[:1].copy()
    if probe.shape[1] < 2:
        return 0.0
    probe2 = probe.copy()
    probe2[0, -1] = (probe2[0, -1] % (vocab - 2)) + 1
    dev = next(module.parameters()).device
    with torch.inference_mode():
        base = module(torch.from_numpy(probe).to(dev))["logits"]
        alt = module(torch.from_numpy(probe2).to(dev))["logits"]
        drift = float((base[0, :-1] - alt[0, :-1]).abs().max())
    if drift > CAUSAL_DRIFT_MAX:
        raise ValueError(
            "encoder attends to FUTURE positions (logit drift "
            f"{drift:.2e} after perturbing the last token) — build it "
            "with make_attention_fn(..., causal=True)")
    return drift
