"""Masked-LM pretraining (slice 3) against the JAX package: strings →
``TokenIdEncoder`` → ``pretrain_masked_lm`` → trunk → ``TextEncoderFeaturizer``.

Held, on seeded inputs and the same weights (carried across by
``masked_lm_from_flax``), with a tiny f32 encoder (vocab 64, width 32,
depth 2, heads 2, mlp 64, T=32):
- ``mask_batch`` and the sequence of batches: bit-equal;
- ``masked_xent`` and ``softmax_xent``: atol 1e-6;
- ``MaskedLMModel`` logits: atol 1e-4 (the text encoder tests' f32
  tolerance);
- one step's loss and every parameter's gradient through the port's
  ``pallas`` attention (the plain fused backward on the CPU) against
  ``jax.value_and_grad`` with the JAX flash kernel in interpret mode and its
  fused backward (``bwd_impl="pallas"``): loss rtol 1e-5, gradients within
  1e-4 of each tensor's largest element (f32 sums in other orders through
  two blocks);
- two AdamW updates against ``optax.adamw``: within two f32 ulps of the
  parameter or 1e-4 of the step size (the libraries order the bias
  corrections and the decay differently);
- three ``pretrain_masked_lm`` steps with the default optimizer: the losses
  within rtol 1e-4; three steps with SGD on both sides: the parameters
  within 1e-5 of each tensor's largest element (Adam's first updates are
  ±lr for any gradient well above eps, so its parameters would turn
  summation-order noise in gradients near 0 into differences of lr);
- the slice end to end from strings: pooled embeddings of the trained
  trunks at atol 1e-4;
- what is not ported yet raises ``NotImplementedError`` naming its item.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mmlspark_tpu.core import DataFrame as JDataFrame
from mmlspark_tpu.dl.pallas_attention import flash_attention as jflash
from mmlspark_tpu.dl.pretrain import MaskedLMModel as JMaskedLMModel
from mmlspark_tpu.dl.pretrain import encoder_variables as jencoder_variables
from mmlspark_tpu.dl.pretrain import mask_batch as jmask_batch
from mmlspark_tpu.dl.pretrain import masked_xent as jmasked_xent
from mmlspark_tpu.dl.pretrain import pretrain_masked_lm as jpretrain
from mmlspark_tpu.dl.text_encoder import TextEncoder as JTextEncoder
from mmlspark_tpu.dl.text_encoder import \
    TextEncoderFeaturizer as JTextEncoderFeaturizer
from mmlspark_tpu.dl.text_encoder import make_attention_fn as jmake_attention
from mmlspark_tpu.dl.train import softmax_xent as jsoftmax_xent
from mmlspark_tpu.featurize import TokenIdEncoder as JTokenIdEncoder
from mmlspark_tpu.models.zoo import LoadedModel as JLoadedModel
from mmlspark_tpu.models.zoo import ModelSchema as JModelSchema
from mmlspark_torch.core import DataFrame
from mmlspark_torch.dl import (MaskedLMModel, TextEncoder,
                               TextEncoderFeaturizer, TrainState,
                               assert_causal, encoder_variables,
                               make_attention_fn, make_train_step,
                               mask_batch, masked_xent, pretrain_causal_lm,
                               pretrain_masked_lm, softmax_xent, train_epoch)
from mmlspark_torch.dl import train as port_train
from mmlspark_torch.dl.checkpoint import CheckpointManager
from mmlspark_torch.dl.pretrain import default_optimizer
from mmlspark_torch.featurize import TokenIdEncoder
from mmlspark_torch.models import (LoadedModel, get_model,
                                   masked_lm_from_flax,
                                   register_text_encoder)

ARCH = dict(vocab=64, width=32, depth=2, heads=2, mlp_dim=64)
T, BATCH, STEPS = 32, 3, 3
F32_ATOL = 1e-4
WORDS = ("pretrained text representations are produced in the framework "
         "from any corpus of token rows").split()


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


def jfused(q, k, v, m=None):
    """The JAX flash kernel in interpret mode with its fused backward."""
    return jflash(q, k, v, key_mask=m, block_q=16, block_k=16,
                  interpret=True, bwd_impl="pallas")


def docs(n=6, seed=0):
    rng = np.random.default_rng(seed)
    out = [" ".join(rng.choice(WORDS, size=rng.integers(3, 40)))
           for _ in range(n)]
    return np.asarray(out, object)


@pytest.fixture(scope="module")
def corpus():
    """Token ids from seeded strings in both packages (vocabSize 63 leaves
    id 63, the encoder's top slot, for the mask token)."""
    d = docs()
    jids = np.asarray(JTokenIdEncoder(maxLength=T, vocabSize=63)
                      .transform(JDataFrame({"text": d}))["tokens"])
    ids = TokenIdEncoder(maxLength=T, vocabSize=63) \
        .transform(DataFrame({"text": d}))["tokens"]
    return d, jids, np.asarray(ids)


def jencoder(attention_fn):
    return JTextEncoder(**ARCH, dtype=jnp.float32, attention_fn=attention_fn)


@pytest.fixture(scope="module")
def init_params(corpus):
    """The params the JAX ``pretrain_masked_lm`` starts from at seed 0 (its
    own ``init_train_state`` call), as numpy."""
    ids = corpus[1]
    variables = jax.jit(
        JMaskedLMModel(jencoder(jmake_attention("dense"))).init,
        static_argnums=2)(jax.random.PRNGKey(0), jnp.asarray(ids[:1]), True)
    return jax.tree_util.tree_map(np.asarray, variables["params"])


def port_model(params, impl="pallas"):
    return masked_lm_from_flax(params, heads=ARCH["heads"],
                               dtype=torch.float32,
                               attention_fn=make_attention_fn(impl))


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


def first_batch(ids, seed=0):
    rng = np.random.default_rng(seed)
    rows = ids[rng.integers(0, len(ids), size=BATCH)]
    return mask_batch(rows, rng, mask_id=ARCH["vocab"] - 1)


@pytest.fixture(scope="module")
def trained(corpus, init_params):
    """Three steps of ``pretrain_masked_lm`` with the default optimizer in
    both packages, from the same weights on the same corpus: the JAX
    encoder on its flash kernel (interpret mode), the port's on its
    ``pallas`` path."""
    _, jids, ids = corpus
    jstate, jlosses = jpretrain(jencoder(jmake_attention("pallas", 16)),
                                jids, steps=STEPS, batch_size=BATCH, seed=0)
    state, losses = pretrain_masked_lm(port_model(init_params), ids,
                                       steps=STEPS, batch_size=BATCH, seed=0,
                                       device="cpu")
    return jstate, jlosses, state, losses


class TestBatchesAndLosses:
    def test_mask_batch_and_batch_sequence_bit_equal(self, corpus):
        _, jids, ids = corpus
        np.testing.assert_array_equal(ids, jids)
        jrng, rng = np.random.default_rng(5), np.random.default_rng(5)
        for _ in range(4):
            jrows = jids[jrng.integers(0, len(jids), size=BATCH)]
            rows = ids[rng.integers(0, len(ids), size=BATCH)]
            jx, jy = jmask_batch(jrows, jrng, mask_id=63, mask_frac=0.3)
            x, y = mask_batch(rows, rng, mask_id=63, mask_frac=0.3)
            for a, b in ((x, jx), (y, jy)):
                assert a.dtype == np.int32
                np.testing.assert_array_equal(a, b)
        assert (y[x == 63] > 0).all() and (y[x != 63] == -1).all()

    @pytest.mark.parametrize("all_ignored", [False, True])
    def test_masked_xent_matches_jax(self, all_ignored):
        rng = np.random.default_rng(6)
        logits = rng.normal(size=(2, 5, 7)).astype(np.float32) * 3
        labels = np.where(rng.random((2, 5)) < 0.5,
                          rng.integers(0, 7, size=(2, 5)), -1)
        if all_ignored:
            labels[:] = -1
        want = float(jmasked_xent(jnp.asarray(logits), jnp.asarray(labels)))
        got = float(masked_xent(torch.from_numpy(logits),
                                torch.from_numpy(labels)))
        assert got == pytest.approx(want, rel=0, abs=1e-6)
        full = rng.integers(0, 7, size=(2, 5))
        assert float(softmax_xent(torch.from_numpy(logits),
                                  torch.from_numpy(full))) == pytest.approx(
            float(jsoftmax_xent(jnp.asarray(logits), jnp.asarray(full))),
            abs=1e-6)


class TestModel:
    def test_logits_match_on_shared_weights(self, corpus, init_params):
        ids = corpus[1]
        jm = JMaskedLMModel(jencoder(jmake_attention("dense")))
        want = jax.jit(jm.apply)({"params": init_params}, jnp.asarray(ids))
        model = port_model(init_params, "dense")
        assert [n for n, _ in model.named_parameters()][-2:] == [
            "lm_head.weight", "lm_head.bias"]
        with torch.inference_mode():
            got = model(torch.from_numpy(ids))
        assert got["logits"].shape == (len(ids), T, ARCH["vocab"])
        for key in ("logits", "pooled"):
            np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                       rtol=0, atol=F32_ATOL)

    def test_first_step_loss_and_grads_match_jax_fused(self, corpus,
                                                       init_params):
        ids = corpus[1]
        x, y = first_batch(ids)
        jm = JMaskedLMModel(jencoder(jfused))

        def jloss(params):
            out = jm.apply({"params": params}, jnp.asarray(x), True)
            return jmasked_xent(out["logits"], jnp.asarray(y))
        want_loss, want_grads = jax.jit(jax.value_and_grad(jloss))(
            init_params)
        model = port_model(init_params)
        loss = masked_xent(model(torch.from_numpy(x), train=True)["logits"],
                           torch.from_numpy(y))
        loss.backward()
        assert float(loss.detach()) == pytest.approx(float(want_loss),
                                                     rel=1e-5)
        names = [n for n, _ in model.named_parameters()]
        assert len(names) == len(jax.tree_util.tree_leaves(want_grads))
        for name, p in model.named_parameters():
            want = flax_leaf(want_grads, name)
            np.testing.assert_allclose(
                p.grad.numpy(), want, rtol=0,
                atol=1e-4 * np.abs(want).max(), err_msg=name)

    def test_new_model_draws_its_head_from_the_generator(self):
        enc = TextEncoder(**ARCH, dtype=torch.float32,
                          generator=torch.Generator().manual_seed(0))
        a = MaskedLMModel(enc, torch.Generator().manual_seed(1))
        b = MaskedLMModel(enc, torch.Generator().manual_seed(1))
        assert torch.equal(a.lm_head.weight, b.lm_head.weight)
        assert torch.equal(a.lm_head.bias, torch.zeros(ARCH["vocab"]))
        std = ARCH["width"] ** -0.5       # lecun normal before truncation
        w = a.lm_head.weight.detach()
        assert float(w.std()) == pytest.approx(std, rel=0.1)
        assert float(w.abs().max()) <= 2 * std / 0.8796 + 1e-6


class TestTraining:
    def test_adamw_update_matches_optax(self):
        rng = np.random.default_rng(7)
        params = {"w": rng.normal(size=(4, 3)).astype(np.float32),
                  "b": rng.normal(size=(3,)).astype(np.float32)}
        grads = [{k: rng.normal(size=v.shape).astype(np.float32)
                  for k, v in params.items()} for _ in range(2)]
        tx = optax.adamw(1e-3)
        jp = {k: jnp.asarray(v) for k, v in params.items()}
        opt_state = tx.init(jp)
        tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
              for k, v in params.items()}
        opt = default_optimizer(1e-3)(list(tp.values()))
        for g in grads:
            updates, opt_state = tx.update(
                {k: jnp.asarray(v) for k, v in g.items()}, opt_state, jp)
            jp = optax.apply_updates(jp, updates)
            for k, p in tp.items():
                p.grad = torch.from_numpy(g[k])
            opt.step()
            for k in params:
                np.testing.assert_allclose(tp[k].detach().numpy(),
                                           np.asarray(jp[k]), rtol=2.4e-7,
                                           atol=1e-7)

    def test_three_step_losses_match_jax(self, trained):
        _, jlosses, state, losses = trained
        assert state.step == STEPS and len(losses) == STEPS
        assert all(isinstance(v, float) for v in losses)
        np.testing.assert_allclose(losses, jlosses, rtol=1e-4)

    def test_sgd_parameters_after_three_steps_match_jax(self, corpus,
                                                        init_params):
        _, jids, ids = corpus
        lr = 0.5
        jstate, jlosses = jpretrain(jencoder(jmake_attention("dense")), jids,
                                    steps=STEPS, batch_size=BATCH, seed=0,
                                    tx=optax.sgd(lr))
        state, losses = pretrain_masked_lm(
            port_model(init_params), ids, steps=STEPS, batch_size=BATCH,
            seed=0, device="cpu",
            optimizer=lambda p: torch.optim.SGD(p, lr=lr))
        np.testing.assert_allclose(losses, jlosses, rtol=1e-4)
        moved = 0.0
        for name, p in state.model.named_parameters():
            want = flax_leaf(jstate.params, name)
            np.testing.assert_allclose(
                p.detach().numpy(), want, rtol=0,
                atol=1e-5 * np.abs(want).max(), err_msg=name)
            moved = max(moved, float(np.abs(
                want - flax_leaf(init_params, name)).max()))
        assert moved > 1e-3          # the steps did move the weights

    def test_slice_end_to_end_matches_jax(self, corpus, trained):
        d = corpus[0]
        jstate, _, state, _ = trained
        trunk = encoder_variables(state)
        assert isinstance(trunk, TextEncoder)
        jloaded = JLoadedModel(JModelSchema(name="pretrained",
                                            model_type="text"),
                               jencoder(jmake_attention("dense")),
                               jencoder_variables(jstate))
        jdf = JTokenIdEncoder(maxLength=T, vocabSize=63).transform(
            JDataFrame({"text": d}))
        want = np.asarray(JTextEncoderFeaturizer(
            attentionImpl="pallas", model=jloaded, seqChunk=T)
            .transform(jdf)["features"])
        schema = register_text_encoder("PretrainedTiny", **ARCH)
        df = TokenIdEncoder(maxLength=T, vocabSize=63).transform(
            DataFrame({"text": d}))
        got = TextEncoderFeaturizer(attentionImpl="pallas", seqChunk=T,
                                    device="cpu",
                                    model=LoadedModel(schema, trunk)) \
            .transform(df)["features"]
        assert got.shape == (len(d), ARCH["width"])
        np.testing.assert_allclose(got, want, rtol=0, atol=F32_ATOL)

    def test_train_epoch_fetches_losses_at_the_end(self):
        class Tiny(torch.nn.Module):
            def __init__(self):
                super().__init__()
                self.lin = torch.nn.Linear(3, 4)

            def forward(self, x, train=False):
                return self.lin(x)

        model = Tiny()
        opt = torch.optim.SGD(model.parameters(), lr=0.1)
        step = make_train_step(model, opt)
        with pytest.raises(ValueError, match="another model"):
            step(TrainState(Tiny(), opt), None, None)
        state = TrainState(model, opt)
        rng = np.random.default_rng(8)
        batches = [(rng.normal(size=(5, 3)).astype(np.float32),
                    rng.integers(0, 4, size=5)) for _ in range(3)]
        state, losses = train_epoch(step, state, batches, device="cpu")
        assert state.step == 3 and len(losses) == 3
        assert all(np.isfinite(losses))
        assert train_epoch(step, state, [], device="cpu") == (state, [])


class TestRaises:
    def test_not_ported_yet(self, monkeypatch, tmp_path):
        ids = np.ones((2, 8), np.int32)
        enc = TextEncoder(**ARCH, dtype=torch.float32)
        for fn, item in ((port_train.partition_train_state, "item 10"),
                         (port_train.make_partitioned_train_step, "item 10"),
                         (port_train.shard_train_state, "item 10")):
            with pytest.raises(NotImplementedError, match=item):
                fn(enc, ids)
        # checkpoints are ported (tests/test_torch_checkpoint.py)
        assert CheckpointManager(str(tmp_path)).latest_step() is None
        with pytest.raises(NotImplementedError, match="item 10"):
            pretrain_masked_lm(enc, ids, mesh=object(), device="cpu")
        model = MaskedLMModel(enc)
        # the causality probe is ported (the LLM slice): this bidirectional
        # model fails it, its causal twin passes
        with pytest.raises(ValueError, match="FUTURE"):
            assert_causal(model, ids, ARCH["vocab"])
        causal = MaskedLMModel(enc.with_attention(
            make_attention_fn("dense", causal=True)))
        assert assert_causal(causal, ids, ARCH["vocab"]) <= 1e-4
        # causal-LM pretraining is ported (the causal-training slice): it
        # refuses the bidirectional encoder and trains its causal twin
        with pytest.raises(ValueError, match="FUTURE"):
            pretrain_causal_lm(enc, ids, steps=1, device="cpu")
        _, losses = pretrain_causal_lm(causal, ids, steps=1, batch_size=2,
                                       device="cpu")
        assert len(losses) == 1 and np.isfinite(losses).all()
        opt = torch.optim.SGD(model.parameters(), lr=0.1)
        # gradient accumulation and remat are ported: a step over two
        # microbatches, and an encoder whose blocks recompute
        step = make_train_step(model, opt, accum_steps=2)
        with pytest.raises(ValueError, match="must divide by accum_steps"):
            step(TrainState(model, opt), torch.from_numpy(ids[:1]),
                 torch.from_numpy(ids[:1]))
        with pytest.raises(NotImplementedError, match="item 10"):
            make_train_step(model, opt, mesh=object())
        assert TextEncoder(**ARCH, remat=True).remat
        with pytest.raises(ValueError, match="mask_id"):
            pretrain_masked_lm(enc, np.full((2, 8), 63, np.int32),
                               device="cpu")
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            pretrain_masked_lm(enc, ids, steps=1)
        assert get_model("TextEncoderBase").model_type == "text"
