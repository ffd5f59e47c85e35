"""Speculative decoding: a cheap draft proposes, the target verifies.

The port of ``mmlspark_tpu/dl/speculative.py``. Each round a draft model
proposes k tokens by ordinary cached decode steps, and the target scores all
of them in ONE (k + 1)-position cached window (``MaskedLMModel
.decode_window``); the longest agreeing prefix is accepted plus the
target's own next token, so every round advances at least one token and
greedy output is EXACTLY the target's greedy decode, however bad the draft.
Temperature > 0 uses the rejection-sampling correction (:func:`_acceptance`),
which makes each emitted token an exact sample from the target's
distribution whatever the draft.

Batched rows synchronize on the minimum per-row acceptance each round: the
token committed at the sync slot is the limiting row's bonus (or
replacement) and the other rows' already-accepted draft, so each row's
output is unchanged at a tokens-per-pass rate set by the slowest row.

The prefills and the causality probe run through each model's own
attention (K2c with ``make_attention_fn("pallas", causal=True)``); the
decode steps and the verify window use the dense cached formulation, as
``generate``'s cached path does. Where the JAX package runs the rounds as
one ``lax.while_loop``, here each round is eager PyTorch on device tensors
and the host reads the round's acceptance count (one fetch a round) to
place the next window. Random draws come from
``torch.Generator(device).manual_seed(seed)``, a stream other than
``jax.random``'s.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from .generate import _CACHE_LOCK, _CAUSAL_OK, _sample
from .pretrain import MaskedLMModel, assert_causal


def _acceptance(p_d, p_t, d, u):
    """Rejection-sampling acceptance (Leviathan et al.'s rule): accept draft
    token ``d[j] ~ p_d[j]`` when ``u[j] < p_t[j][d_j] / p_d[j][d_j]``; the
    round ends at the first rejection, whose replacement is drawn from the
    RESIDUAL ``norm(relu(p_t[j*] - p_d[j*]))``, the correction that makes
    each emitted token an exact sample from ``p_t``.

    A pure function over leading batch dims: ``p_d [..., k, V]``,
    ``p_t [..., k+1, V]`` (row k the bonus distribution), ``d [..., k]``
    draft tokens (int64), ``u [..., k]`` uniforms. Returns ``(n_acc [...],
    replacement_dist [..., V])``: the residual at the rejection row, or
    ``p_t[k]`` when every draft token was accepted."""
    k, V = d.shape[-1], p_t.shape[-1]
    pd_tok = p_d.gather(-1, d[..., None])[..., 0]
    pt_tok = p_t[..., :k, :].gather(-1, d[..., None])[..., 0]
    ratio = pt_tok / pd_tok.clamp_min(1e-20)
    accept = u < ratio.clamp_max(1.0)
    n_acc = torch.cumprod(accept.long(), -1).sum(-1)
    at = n_acc.clamp_max(k - 1)[..., None, None].expand(*n_acc.shape, 1, V)
    residual = (p_t.gather(-2, at) - p_d.gather(-2, at))[..., 0, :]
    residual = residual.clamp_min(0.0)
    residual = residual / residual.sum(-1, keepdim=True).clamp_min(1e-20)
    replacement = torch.where((n_acc == k)[..., None], p_t[..., k, :],
                              residual)
    return n_acc, replacement


def _caches(module: MaskedLMModel, B: int, L: int, device):
    enc = module.encoder
    hd = enc.width // enc.heads
    return [tuple(torch.zeros(B, enc.heads, L, hd, dtype=enc.dtype,
                              device=device) for _ in range(2))
            for _ in range(enc.depth)]


def _draft_round(draft, tok, caches, pos, k, temperature, pad_id,
                 generator):
    """k cached draft steps from ``tok`` at ``pos``, then one cache-fill
    step (logits discarded): without it d_k's k/v would stay a zero-filled
    hole that the next round's draft attends after a full acceptance, which
    halves the self-draft acceptance rate. Returns the drafts [B, k] and,
    with ``temperature > 0``, their distributions [B, k, V]."""
    drafts, p_d = [], []
    for j in range(k):
        logits = draft.decode_step(tok, caches, pos + j).float()
        logits[:, pad_id] = float("-inf")
        if temperature > 0:
            p_d.append(torch.softmax(logits / temperature, -1))
        tok = _sample(logits, temperature, pad_id, generator)
        drafts.append(tok)
    draft.decode_step(tok, caches, pos + k)
    return torch.stack(drafts, 1).long(), (torch.stack(p_d, 1) if p_d
                                            else None)


def generate_speculative(module: MaskedLMModel, draft_module: MaskedLMModel,
                         prompt_ids, *, max_new_tokens: int, k: int = 4,
                         pad_id: int = 0, temperature: float = 0.0,
                         seed: int = 0,
                         device: str | torch.device | None = None):
    """Speculative decode.

    ``prompt_ids`` [B, Tp] int32 with no pad (rows synchronize on the
    minimum per-row acceptance). Both modules move to ``device`` (CUDA
    unless ``"cpu"`` is asked for) and carry their weights (the JAX function
    takes ``variables`` beside each); they must share a vocabulary and run
    causal attention, which the causality probe checks once per module.
    Returns ``(ids [B, Tp + max_new_tokens] int32 numpy, tokens_per_pass)``,
    ``tokens_per_pass`` being generated tokens / target verify passes (k + 1
    when the draft always agrees, 1 when it never does).

    ``temperature=0`` (default): greedy acceptance, output identical to
    ``generate(module, ..., temperature=0)`` whatever the draft.
    ``temperature > 0``: rejection-sampling acceptance, each emitted token
    an exact sample from the target's distribution at that temperature."""
    prompt_ids = np.asarray(prompt_ids, np.int32)
    if k < 1:
        raise ValueError(f"k={k}: the draft must propose at least one "
                         "token per round")
    if prompt_ids.ndim != 2:
        raise ValueError("prompt_ids must be [B, Tp]")
    if (prompt_ids == pad_id).any():
        raise ValueError("speculative decode needs a dense prompt row "
                         "(no pad)")
    if module.encoder.vocab != draft_module.encoder.vocab:
        raise ValueError("draft and target must share a vocabulary")
    B, Tp = prompt_ids.shape
    if Tp < 1:
        raise ValueError("empty prompt")
    dev = resolve_device(device)
    for mod in (module, draft_module):
        mod.to(dev)
        with _CACHE_LOCK:
            probed = _CAUSAL_OK.get(mod)
        if not probed:
            assert_causal(mod, prompt_ids if Tp >= 2
                          else np.repeat(prompt_ids, 2, axis=1),
                          mod.encoder.vocab)
            with _CACHE_LOCK:
                _CAUSAL_OK[mod] = True
    generator = (torch.Generator(device=dev).manual_seed(seed)
                 if temperature > 0 else None)
    total = Tp + max_new_tokens
    L = total + k + 1          # slack: the window write near the end
    with torch.inference_mode():
        buf = torch.full((B, L), pad_id, dtype=torch.int32, device=dev)
        buf[:, :Tp] = torch.from_numpy(prompt_ids).to(dev)
        caches_t = _caches(module, B, L, dev)
        caches_d = _caches(draft_module, B, L, dev)
        if Tp > 1:
            module.prefill(buf[:, :Tp - 1], caches_t)
            draft_module.prefill(buf[:, :Tp - 1], caches_d)
        ptr, rounds = Tp, 0
        while ptr < total:
            last = buf[:, ptr - 1]
            d, p_d = _draft_round(draft_module, last, caches_d, ptr - 1, k,
                                  temperature, pad_id, generator)
            window = torch.cat([last[:, None].long(), d], 1)     # [B, k+1]
            logits = module.decode_window(window, caches_t, ptr - 1).float()
            logits[..., pad_id] = float("-inf")                  # [B, k+1, V]
            if temperature > 0:
                p_t = torch.softmax(logits / temperature, -1)
                u = torch.rand(B, k, generator=generator, device=dev)
                n_rows, repl = _acceptance(p_d, p_t, d, u)
                n_acc = int(n_rows.min())
                sampled = torch.multinomial(repl, 1, generator=generator)[:, 0]
                # rows past the sync slot commit their accepted d[n_acc];
                # rows at it their replacement (or bonus) sample
                bonus = torch.where(n_rows > n_acc, d[:, min(n_acc, k - 1)],
                                    sampled)
            else:
                t = logits.argmax(-1)
                agree = torch.cumprod((d == t[:, :k]).long(), 1).sum(1)
                n_acc = int(agree.min())
                bonus = t[:, n_acc]
            emit = torch.cat([d, torch.zeros_like(d[:, :1])], 1)
            emit[:, n_acc] = bonus
            n_new = min(n_acc + 1, total - ptr)
            buf[:, ptr:ptr + n_new] = emit[:, :n_new].to(torch.int32)
            ptr += n_new
            rounds += 1
        out = buf[:, :total].cpu().numpy()
    return out, float(ptr - Tp) / max(float(rounds), 1.0)
