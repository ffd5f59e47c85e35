"""Causal-LM training (the causal lse forward K2c-lse, the causal fused
backward K2d/K2e, ``pretrain_causal_lm``, ``remat`` and gradient
accumulation) against the JAX package.

The same seeded inputs (numpy, f32) go through the port's plain versions
and autograd Functions and through the JAX package's Pallas kernels in
interpret mode, as ``tests/test_pallas_attention.py`` runs them, at tiny
shapes (B=2, H=2, T=40, ragged for the blocks of 16, batch row 0 fully
masked), for the global offsets (0, 0), (16, 0), (0, 16) and (5, 23):
- ``flash_lse_torch(causal=True)`` against ``_flash_forward(with_lse=True,
  causal=True)`` on the packed kernel (``:285``) and, with
  ``_PACKED_KV_BYTES`` set to 0, on the streaming kernel (``:320``);
- ``flash_bwd_torch(causal=True)`` against ``_flash_backward(causal=True)``
  from the JAX forward's o and lse, with and without ``dlse``;
- ``flash_attention(causal=True)``'s gradients with ``bwd_impl`` "pallas"
  and "blockwise" against ``jax.grad`` of the JAX function with the same
  ``bwd_impl``;
- ``flash_attention_lse(causal=True)``'s gradients through both outputs
  against the JAX function with its fused backward forced on
  (``_FORCE_FUSED_LSE_BWD``).
Tolerance: f32 at atol 2e-5 (``tests/test_pallas_attention.py``'s), with
an rtol of 1e-5 for the gradients, whose sums run over up to 40 terms of
either sign in other orders.

Then, with a tiny f32 causal LM (vocab 64, width 32, depth 2, heads 2, mlp
64, rows of 33 tokens) whose JAX weights ``masked_lm_from_flax`` carries
across:
- ``pretrain_causal_lm``: the batches bit-equal; three steps with the
  default AdamW (the losses within rtol 1e-4) and with SGD (the losses,
  and the parameters within 1e-5 of each tensor's largest element, as
  ``tests/test_torch_pretrain.py`` holds them); a bidirectional encoder is
  refused;
- ``TextEncoder(remat=True)``: the gradients equal ``remat=False``'s and
  are within 1e-4 of each tensor's largest element of the JAX
  ``nn.remat`` encoder's (``test_torch_pretrain.py``'s gradient limit);
- ``make_train_step(accum_steps=2)``: the loss and the SGD-updated
  parameters against the JAX step's, as above; an indivisible batch
  raises.

On the card, one ``cuda``-marked test holds the causal kernels against
their plain versions; it skips without a GPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import mmlspark_tpu.dl.pallas_attention as jpa
import mmlspark_tpu.dl.pretrain as jpretrain_mod
import mmlspark_torch.dl.flash_attention as k2
import mmlspark_torch.dl.pretrain as pretrain_mod
from mmlspark_tpu.dl.pretrain import MaskedLMModel as JMaskedLMModel
from mmlspark_tpu.dl.pretrain import masked_xent as jmasked_xent
from mmlspark_tpu.dl.pretrain import pretrain_causal_lm as jpretrain_causal
from mmlspark_tpu.dl.text_encoder import TextEncoder as JTextEncoder
from mmlspark_tpu.dl.text_encoder import make_attention_fn as jmake_attention
from mmlspark_tpu.dl.train import init_train_state as jinit_train_state
from mmlspark_tpu.dl.train import make_train_step as jmake_train_step
from mmlspark_torch.dl import (TextEncoder, TrainState, make_attention_fn,
                               make_train_step, masked_xent,
                               pretrain_causal_lm)
from mmlspark_torch.models import masked_lm_from_flax

ATOL = 2e-5           # tests/test_pallas_attention.py's f32 tolerance
GRAD_RTOL = 1e-5
BLOCK = 16
T_ATTN = 40           # ragged for the 16-wide blocks
OFFSETS = {"aligned": (0, 0), "q_ahead": (16, 0), "k_ahead": (0, 16),
           "unaligned": (5, 23)}
BF16_ULP = 2.0 ** -7


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Single-threaded torch for this module: tier-1 runs in several
    worker processes at once, and torch's intra-op threads in each of
    them oversubscribe the cores (small ops then wait on spinning
    threads, ~20x slower)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_inputs(T=T_ATTN, D=16, seed=0, B=2, H=2):
    """q, k, v, g [B, H, T, D] f32, dlse [B, H, T] f32 and a [B, T] key
    mask whose batch row 0 is fully masked."""
    rng = np.random.default_rng(seed)
    q, k, v, g = (rng.normal(size=(B, H, T, D)).astype(np.float32)
                  for _ in range(4))
    dlse = rng.normal(size=(B, H, T)).astype(np.float32)
    mask = rng.random((B, T)) > 0.3
    mask[0] = False
    return q, k, v, g, dlse, mask


def t(*xs):
    return [torch.from_numpy(np.array(x)) for x in xs]   # writable copies


def jx(*xs):
    return [jnp.asarray(x) for x in xs]


def offs(case):
    return jnp.asarray([OFFSETS[case]], jnp.int32)


def close(got, want, rtol=0.0):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=ATOL)


def pos(case):
    q_off, k_off = OFFSETS[case]
    return dict(causal=True, q_offset=q_off, k_offset=k_off)


def no_allowed_key(mask, case):
    """[B, T] bool: the rows of a causal call with no allowed key."""
    q_off, k_off = OFFSETS[case]
    r = np.arange(mask.shape[1])
    allowed = (k_off + r)[None, None, :] <= (q_off + r)[None, :, None]
    return ~(allowed & mask[:, None, :]).any(-1)


@pytest.fixture(scope="module")
def jax_forward():
    """The JAX packed causal forward with the lse (o, lse) per case."""
    out = {}
    for case in OFFSETS:
        q, k, v, _, _, mask = make_inputs(seed=len(case))
        o, lse = jpa._flash_forward(*jx(q, k, v, mask), offs(case),
                                    block_q=BLOCK, block_k=BLOCK,
                                    interpret=True, with_lse=True,
                                    causal=True)
        out[case] = (np.asarray(o), np.asarray(lse))
    return out


class TestCausalLseForward:
    @pytest.mark.parametrize("case", sorted(OFFSETS))
    def test_packed_kernel(self, case, jax_forward):
        q, k, v, _, _, mask = make_inputs(seed=len(case))
        want_o, want_lse = jax_forward[case]
        o, lse = k2.flash_lse_torch(*t(q, k, v, mask), **pos(case))
        assert lse.dtype == torch.float32 and lse.shape == (2, 2, T_ATTN)
        close(o, want_o)
        close(lse, want_lse, rtol=1e-6)
        empty = no_allowed_key(mask, case)
        assert empty[0].all() and (o.numpy().transpose(0, 2, 1, 3)[empty]
                                   == 0).all()
        assert (lse.numpy().transpose(0, 2, 1)[empty] <= -1e29).all()
        assert (want_lse.transpose(0, 2, 1)[empty] <= -1e29).all()

    @pytest.mark.parametrize("case", sorted(OFFSETS))
    def test_streaming_kernel(self, case, monkeypatch):
        # K/V over the packed budget take the streaming grid (causal K2b,
        # `_flash_kernel_lse`); unjitted, so the constant is read here
        monkeypatch.setattr(jpa, "_PACKED_KV_BYTES", 0)
        q, k, v, _, _, mask = make_inputs(seed=len(case) + 1)
        want_o, want_lse = jpa._flash_forward.__wrapped__(
            *jx(q, k, v, mask), offs(case), block_q=BLOCK, block_k=BLOCK,
            interpret=True, with_lse=True, causal=True)
        o, lse = k2.flash_lse_torch(*t(q, k, v, mask), **pos(case))
        close(o, want_o)
        close(lse, want_lse, rtol=1e-6)


class TestCausalBackwardPlain:
    @pytest.mark.parametrize("case", sorted(OFFSETS))
    @pytest.mark.parametrize("with_dlse", [False, True])
    def test_matches_jax_interpret(self, case, with_dlse, jax_forward):
        q, k, v, g, dlse, mask = make_inputs(seed=len(case))
        o, lse = jax_forward[case]
        dl = dlse if with_dlse else None
        want = jpa._flash_backward(*jx(q, k, v, mask, o, lse, g),
                                   dlse=None if dl is None
                                   else jnp.asarray(dl), offs=offs(case),
                                   block_q=BLOCK, block_k=BLOCK,
                                   interpret=True, causal=True)
        got = k2.flash_bwd_torch(*t(q, k, v, mask, o, lse, g),
                                 None if dl is None else t(dl)[0],
                                 **pos(case))
        for a, b in zip(got, want):
            close(a, b, rtol=GRAD_RTOL)
        # rows with no allowed key and keys no row may see: exactly 0
        dq, dk, dv = (x.numpy().transpose(0, 2, 1, 3) for x in got)
        assert (dq[no_allowed_key(mask, case)] == 0).all()
        q_off, k_off = OFFSETS[case]
        unseen = ~mask | (k_off + np.arange(T_ATTN) > q_off + T_ATTN - 1)
        assert (dk[unseen] == 0).all() and (dv[unseen] == 0).all()

    def test_dq_dkv_split_and_causal_differs(self):
        q, k, v, g, dlse, mask = make_inputs(seed=9)
        tq, tk, tv, tg, tdl, tm = t(q, k, v, g, dlse, mask)
        o, lse = k2.flash_lse_torch(tq, tk, tv, tm, **pos("unaligned"))
        dsum = k2.flash_dsum(o, tg, tdl)
        dq, dk, dv = k2.flash_bwd_torch(tq, tk, tv, tm, o, lse, tg, tdl,
                                        **pos("unaligned"))
        assert torch.equal(dq, k2.flash_dq_torch(
            tq, tk, tv, tm, tg, lse, dsum, **pos("unaligned")))
        got_dk, got_dv = k2.flash_dkv_torch(tq, tk, tv, tm, tg, lse, dsum,
                                            **pos("unaligned"))
        assert torch.equal(dk, got_dk) and torch.equal(dv, got_dv)
        full = k2.flash_dq_torch(tq, tk, tv, tm, tg, lse, dsum)
        assert not torch.allclose(dq, full)


def port_grads(fn, q, k, v, mask, g, **kw):
    leaves = [x.requires_grad_() for x in t(q, k, v)]
    out = fn(*leaves, t(mask)[0], **kw)
    return [x.numpy() for x in torch.autograd.grad(out, leaves, t(g)[0])]


class TestCausalAutograd:
    @pytest.mark.parametrize("case", sorted(OFFSETS))
    @pytest.mark.parametrize("bwd_impl", ["pallas", "blockwise"])
    def test_flash_attention_grads_match_jax(self, case, bwd_impl):
        q, k, v, g, _, mask = make_inputs(seed=len(case) + 2)
        q_off, k_off = OFFSETS[case]

        def loss(q, k, v):
            o = jpa.flash_attention(q, k, v, key_mask=jnp.asarray(mask),
                                    block_q=BLOCK, block_k=BLOCK,
                                    interpret=True, bwd_impl=bwd_impl,
                                    causal=True, q_offset=q_off,
                                    k_offset=k_off)
            return jnp.sum(o * g)
        want = jax.grad(loss, argnums=(0, 1, 2))(*jx(q, k, v))
        got = port_grads(k2.flash_attention, q, k, v, mask, g,
                         bwd_impl=bwd_impl, **pos(case))
        for a, b in zip(got, want):
            close(a, b, rtol=GRAD_RTOL)

    @pytest.mark.parametrize("case", sorted(OFFSETS))
    def test_flash_attention_lse_grads_match_jax(self, case, monkeypatch):
        monkeypatch.setattr(jpa, "_FORCE_FUSED_LSE_BWD", True)
        q, k, v, g, dlse, mask = make_inputs(seed=len(case) + 3)
        q_off, k_off = OFFSETS[case]

        def f(q, k, v):
            return jpa.flash_attention_lse(
                q, k, v, key_mask=jnp.asarray(mask), block_q=BLOCK,
                block_k=BLOCK, interpret=True, causal=True, q_offset=q_off,
                k_offset=k_off)
        (jo, jlse), vjp = jax.vjp(f, *jx(q, k, v))
        want = vjp((jnp.asarray(g), jnp.asarray(dlse)))
        leaves = [x.requires_grad_() for x in t(q, k, v)]
        o, lse = k2.flash_attention_lse(*leaves, t(mask)[0], **pos(case))
        close(o.detach(), jo)
        close(lse.detach(), jlse, rtol=1e-6)
        got = torch.autograd.grad((o, lse), leaves, t(g, dlse))
        for a, b in zip(got, want):
            close(a, b, rtol=GRAD_RTOL)

    def test_switch_routes_and_offsets_without_causal(self):
        q, k, v, g, _, mask = make_inputs(seed=21)
        leaves = [x.requires_grad_() for x in t(q, k, v)]
        tm = t(mask)[0]
        out = k2.flash_attention(*leaves, tm, **pos("unaligned"))
        assert type(out.grad_fn).__name__ == "_FlashBackward"
        torch.testing.assert_close(
            out.detach(), k2.flash_torch(*t(q, k, v), tm,
                                         **pos("unaligned")),
            rtol=0, atol=0)
        # offsets without causal are ignored, as in the JAX package
        o1, l1 = k2.flash_attention_lse(*leaves, tm, q_offset=5,
                                        k_offset=23)
        o2, l2 = k2.flash_attention_lse(*leaves, tm)
        assert torch.equal(o1, o2) and torch.equal(l1, l2)
        # CPU tensors: no kernel launched, causal or not
        assert k2.flash_lse_cuda.causal_launches == 0
        assert k2.flash_dq_cuda.causal_launches == 0
        assert k2.flash_dkv_cuda.causal_launches == 0


# ---------------------------------------------------------- causal LM

ARCH = dict(vocab=64, width=32, depth=2, heads=2, mlp_dim=64)
ROW = 33                   # rows of T + 1 tokens: x and y are T = 32 long
BATCH, STEPS = 3, 3


def corpus(n=6, seed=0):
    """Token-id rows [n, ROW] in [1, vocab) with a pad (0) tail of seeded
    length; row 0 is full."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, ARCH["vocab"], size=(n, ROW)).astype(np.int32)
    lengths = rng.integers(4, ROW + 1, size=n)
    lengths[0] = ROW
    ids[np.arange(ROW)[None, :] >= lengths[:, None]] = 0
    return ids


def jencoder(attention_fn, remat=False):
    return JTextEncoder(**ARCH, dtype=jnp.float32, attention_fn=attention_fn,
                        remat=remat)


@pytest.fixture(scope="module")
def init_params():
    """The params the JAX ``pretrain_causal_lm`` starts from at seed 0 (its
    own ``init_train_state`` call), as numpy."""
    ids = corpus()
    variables = jax.jit(
        JMaskedLMModel(jencoder(jmake_attention("dense", causal=True)))
        .init, static_argnums=2)(jax.random.PRNGKey(0),
                                 jnp.asarray(ids[:1]), True)
    return jax.tree_util.tree_map(np.asarray, variables["params"])


def port_model(params, impl="pallas"):
    return masked_lm_from_flax(params, heads=ARCH["heads"],
                               dtype=torch.float32,
                               attention_fn=make_attention_fn(impl,
                                                              causal=True))


def flax_leaf(params, name):
    """The flax leaf behind a port parameter name, in the port's layout."""
    *path, leaf = name.split(".")
    node = params
    for p in path:
        node = node[p]
    if leaf == "weight":
        key = next(k for k in ("kernel", "scale", "embedding") if k in node)
        x = np.asarray(node[key])
        return x.T if key == "kernel" else x
    return np.asarray(node[leaf])


def assert_params_match(model, jparams, of_max=1e-5):
    for name, p in model.named_parameters():
        want = flax_leaf(jparams, name)
        np.testing.assert_allclose(p.detach().numpy(), want, rtol=0,
                                   atol=of_max * np.abs(want).max(),
                                   err_msg=name)


def assert_grads_match(model, jgrads, of_max=1e-4):
    names = [n for n, _ in model.named_parameters()]
    assert len(names) == len(jax.tree_util.tree_leaves(jgrads))
    for name, p in model.named_parameters():
        want = flax_leaf(jgrads, name)
        np.testing.assert_allclose(p.grad.numpy(), want, rtol=0,
                                   atol=of_max * np.abs(want).max(),
                                   err_msg=name)


class TestPretrainCausalLM:
    def test_batches_bit_equal(self, monkeypatch, init_params):
        ids = corpus()
        seen = {}

        def capture(name):
            def train_epoch(step, state, batches, **kw):
                seen[name] = [tuple(np.asarray(a) for a in b)
                              for b in batches]
                return state, []
            return train_epoch
        monkeypatch.setattr(jpretrain_mod, "train_epoch", capture("jax"))
        monkeypatch.setattr(pretrain_mod, "train_epoch", capture("port"))
        jpretrain_causal(jencoder(jmake_attention("dense", causal=True)),
                         ids, steps=4, batch_size=BATCH, seed=3)
        pretrain_causal_lm(port_model(init_params, "dense"), ids, steps=4,
                           batch_size=BATCH, seed=3, device="cpu")
        assert len(seen["port"]) == len(seen["jax"]) == 4
        for (x, y), (jx_, jy) in zip(seen["port"], seen["jax"]):
            assert x.dtype == y.dtype == np.int32
            assert x.shape == y.shape == (BATCH, ROW - 1)
            np.testing.assert_array_equal(x, jx_)
            np.testing.assert_array_equal(y, jy)
        assert (y == -1).any() and (y[y >= 0] > 0).all()

    def test_adamw_trajectory_matches_jax(self, init_params):
        ids = corpus()
        _, jlosses = jpretrain_causal(
            jencoder(jmake_attention("pallas", BLOCK, causal=True)), ids,
            steps=STEPS, batch_size=BATCH, seed=0)
        state, losses = pretrain_causal_lm(port_model(init_params), ids,
                                           steps=STEPS, batch_size=BATCH,
                                           seed=0, device="cpu")
        assert state.step == STEPS and len(losses) == STEPS
        np.testing.assert_allclose(losses, jlosses, rtol=1e-4)

    def test_sgd_parameters_match_jax(self, init_params):
        ids = corpus()
        lr = 0.5
        jstate, jlosses = jpretrain_causal(
            jencoder(jmake_attention("dense", causal=True)), ids,
            steps=STEPS, batch_size=BATCH, seed=0, tx=optax.sgd(lr))
        state, losses = pretrain_causal_lm(
            port_model(init_params), ids, steps=STEPS, batch_size=BATCH,
            seed=0, device="cpu",
            optimizer=lambda p: torch.optim.SGD(p, lr=lr))
        np.testing.assert_allclose(losses, jlosses, rtol=1e-4)
        assert_params_match(state.model, jstate.params)
        moved = max(float(np.abs(flax_leaf(jstate.params, n)
                                 - flax_leaf(init_params, n)).max())
                    for n, _ in state.model.named_parameters())
        assert moved > 1e-3          # the steps did move the weights

    def test_refuses_a_bidirectional_encoder(self, monkeypatch):
        ids = corpus()
        enc = TextEncoder(**ARCH, dtype=torch.float32,
                          attention_fn=make_attention_fn("pallas"))
        with pytest.raises(ValueError, match="FUTURE"):
            pretrain_causal_lm(enc, ids, steps=1, batch_size=2,
                               device="cpu")
        with pytest.raises(NotImplementedError, match="item 10"):
            pretrain_causal_lm(enc, ids, mesh=object(), device="cpu")
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            pretrain_causal_lm(enc, ids, steps=1)


def first_causal_batch(ids):
    rng = np.random.default_rng(0)
    rows = ids[rng.integers(0, len(ids), size=4)]
    return rows[:, :-1], np.where(rows[:, 1:] != 0, rows[:, 1:],
                                  -1).astype(np.int32)


class TestRematAndAccumulation:
    def test_remat_gradients(self, init_params):
        x, y = first_causal_batch(corpus())
        jm = JMaskedLMModel(jencoder(jmake_attention("dense", causal=True),
                                     remat=True))

        def jloss(params):
            out = jm.apply({"params": params}, jnp.asarray(x), True)
            return jmasked_xent(out["logits"], jnp.asarray(y))
        want_loss, want_grads = jax.jit(jax.value_and_grad(jloss))(
            init_params)
        losses, grads = [], []
        for remat in (False, True):
            model = port_model(init_params)
            model.encoder.remat = remat
            loss = masked_xent(model(torch.from_numpy(x), train=True)
                               ["logits"], torch.from_numpy(y))
            loss.backward()
            losses.append(float(loss.detach()))
            grads.append({n: p.grad for n, p in model.named_parameters()})
            assert_grads_match(model, want_grads)
        assert losses[0] == losses[1] == pytest.approx(float(want_loss),
                                                       rel=1e-5)
        for n, g in grads[0].items():
            torch.testing.assert_close(grads[1][n], g, rtol=0, atol=0,
                                       msg=n)

    def test_remat_flag_and_inference(self):
        enc = TextEncoder(**ARCH, dtype=torch.float32, remat=True,
                          attention_fn=make_attention_fn("pallas",
                                                         causal=True))
        ids = torch.from_numpy(corpus()[:2, :-1])
        with torch.inference_mode():
            a = enc(ids)["tokens"]
        enc.remat = False
        with torch.inference_mode():
            b = enc(ids)["tokens"]
        assert torch.equal(a, b)

    def test_accum_steps_matches_jax(self, init_params):
        x, y = first_causal_batch(corpus())
        lr = 0.5
        jm = JMaskedLMModel(jencoder(jmake_attention("dense", causal=True)))
        tx = optax.sgd(lr)
        jstate = jinit_train_state(jm, jax.random.PRNGKey(0), x[:1], tx)
        jstate = jstate.__class__(
            params=jax.tree_util.tree_map(jnp.asarray, init_params),
            batch_stats=jstate.batch_stats, opt_state=tx.init(init_params),
            step=jstate.step)
        jstep = jmake_train_step(jm, tx, loss_fn=jmasked_xent,
                                 accum_steps=2)
        jstate, jloss = jstep(jstate, jnp.asarray(x), jnp.asarray(y))
        model = port_model(init_params, "dense")
        opt = torch.optim.SGD(model.parameters(), lr=lr)
        step = make_train_step(model, opt, loss_fn=masked_xent,
                               accum_steps=2)
        state, loss = step(TrainState(model, opt), torch.from_numpy(x),
                           torch.from_numpy(y))
        assert state.step == 1
        assert float(loss) == pytest.approx(float(jloss), rel=1e-5)
        assert_params_match(model, jstate.params)
        with pytest.raises(ValueError, match="must divide by accum_steps=3"):
            make_train_step(model, opt, loss_fn=masked_xent, accum_steps=3)(
                state, torch.from_numpy(x), torch.from_numpy(y))
        with pytest.raises(ValueError, match="must divide by accum_steps=3"):
            jmake_train_step(jm, tx, loss_fn=jmasked_xent, accum_steps=3)(
                jstate, jnp.asarray(x), jnp.asarray(y))


@pytest.mark.cuda
class TestCudaCausalKernels:
    def test_causal_kernels_match_plain_on_card(self):
        if not torch.cuda.is_available():
            pytest.skip("needs an NVIDIA GPU (K2c-lse and the causal K2d "
                        "and K2e are CUDA-only; their plain versions are "
                        "tested above)")
        dev = torch.device("cuda")
        for dtype in (torch.bfloat16, torch.float32):
            for D in (32, 64, 128):
                for T, case in ((64, "aligned"), (200, "unaligned"),
                                (130, "k_ahead")):
                    x = make_inputs(T, D, seed=D + T, H=3)
                    q, k, v, g, dl = (torch.from_numpy(a).to(dev, dtype)
                                      for a in x[:5])
                    m = torch.from_numpy(x[5]).to(dev)
                    dl = dl.float()
                    o, lse = k2.flash_lse_cuda(q, k, v, m, **pos(case))
                    want_o, want_lse = k2.flash_lse_torch(q, k, v, m,
                                                          **pos(case))
                    got = k2.flash_bwd_cuda(q, k, v, m, o, lse, g, dl,
                                            **pos(case))
                    want = k2.flash_bwd_torch(q, k, v, m, o, lse, g, dl,
                                              **pos(case))
                    torch.cuda.synchronize()
                    assert torch.equal(o[0], torch.zeros_like(o[0]))
                    assert torch.equal(got[0][0],
                                       torch.zeros_like(got[0][0]))
                    live = want_lse[1] > -1e29
                    torch.testing.assert_close(lse[1][live],
                                               want_lse[1][live],
                                               rtol=0, atol=1e-4)
                    bf16 = dtype == torch.bfloat16
                    for a, b in zip((o, *got), (want_o, *want)):
                        scale = float(b.float().abs().max())
                        torch.testing.assert_close(
                            a.float(), b.float(),
                            rtol=2 * BF16_ULP if bf16 else 1e-4,
                            atol=(BF16_ULP if bf16 else 1e-4) * scale
                            + (4e-3 if bf16 else ATOL))
