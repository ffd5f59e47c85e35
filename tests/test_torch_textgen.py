"""The rest of the generation slice against the JAX package:
``ContinuousGenerator``, ``generate_speculative`` (with ``_acceptance``) and
``TextGenerator``.

The same weights (carried across by ``masked_lm_from_flax``) run in both
packages: a causal LM of vocab 64, width 32, depth 2, heads 2, mlp 64, f32
(``tests/test_speculative.py``'s target) and a depth-1 draft of other
weights; the JAX side uses dense causal attention, the port ``pallas``
(K2c's plain version on the CPU). Held exactly:
- greedy ``ContinuousGenerator`` rows equal the JAX package's
  ``generate(use_cache=False)`` and the port's, with admission mid-flight
  too. That equality is the JAX ``ContinuousGenerator``'s own contract;
  its rows are not compared directly, because its host loop is flaky under
  load (``tests/test_sched.py``'s continuous-batching test fails in some
  tier-1 runs, and in one run of this file its rows dropped a sequence's
  last token);
- greedy ``generate_speculative`` ids and ``tokens_per_pass`` equal JAX's
  for the self-draft, a bad draft, k = 1 and batched rows, and the ids equal
  ``generate``'s; padded prompts and other bad inputs raise;
- greedy ``TextGenerator`` text equals JAX's with and without ``draftLm``,
  a blank prompt included, over a ``BpeTokenizer`` fitted the same way in
  both packages.
Sampled decoding draws from ``torch.Generator``, not ``jax.random``: it is
held by ``_acceptance`` reproducing the target distribution (total variation
<= 0.02 over 20,000 draws) and by runs being reproducible by seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmlspark_tpu.core import DataFrame as JDataFrame
from mmlspark_tpu.dl import MaskedLMModel as JMaskedLMModel
from mmlspark_tpu.dl import TextEncoder as JTextEncoder
from mmlspark_tpu.dl import generate as jgenerate
from mmlspark_tpu.dl.generate import TextGenerator as JTextGenerator
from mmlspark_tpu.dl.speculative import \
    generate_speculative as jgenerate_speculative
from mmlspark_tpu.dl.text_encoder import make_attention_fn as jmake_attention
from mmlspark_tpu.featurize import BpeTokenizer as JBpeTokenizer
from mmlspark_torch.core import DataFrame
from mmlspark_torch.dl import (ContinuousGenerator, MaskedLMModel,
                               TextEncoder, TextGenerator, generate,
                               generate_speculative, make_attention_fn)
from mmlspark_torch.dl.speculative import _acceptance
from mmlspark_torch.featurize import BpeTokenizer
from mmlspark_torch.models import masked_lm_from_flax
from mmlspark_torch.obs import MetricsRegistry

VOCAB = 64
ARCH = dict(vocab=VOCAB, width=32, heads=2, mlp_dim=64)


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


def _lm(depth, seed):
    jm = JMaskedLMModel(JTextEncoder(**ARCH, depth=depth, dtype=jnp.float32,
                                     attention_fn=jmake_attention(
                                         "dense", causal=True)))
    variables = jax.jit(jm.init)(jax.random.PRNGKey(seed),
                                 np.ones((1, 8), np.int32))
    port = masked_lm_from_flax(jax.tree.map(np.asarray, variables),
                               heads=ARCH["heads"], dtype=torch.float32,
                               attention_fn=make_attention_fn(
                                   "pallas", causal=True))
    return jm, {"params": variables["params"]}, port


@pytest.fixture(scope="module")
def target():
    return _lm(2, 0)


@pytest.fixture(scope="module")
def draft():
    return _lm(1, 9)


def _prompts(seed=0, sizes=(3, 5, 2, 6, 4)):
    rng = np.random.default_rng(seed)
    return [rng.integers(2, VOCAB, size=n).astype(np.int32) for n in sizes]


def _reference(model, prompt, budget, max_len):
    return generate(model, prompt[None], max_new_tokens=budget,
                    max_len=max_len, use_cache=False, device="cpu")[0]


class TestContinuousGenerator:
    BUDGETS = (4, 3, 5, 2, 4)

    def test_greedy_matches_jax_and_generate(self, target):
        jm, variables, port = target
        prompts = _prompts()
        pgen = ContinuousGenerator(port, slots=2, max_len=16,
                                   registry=MetricsRegistry(), device="cpu")
        for i, (p, n) in enumerate(zip(prompts, self.BUDGETS)):
            pgen.submit(i, p, n)
        got = pgen.run_until_drained()
        assert sorted(got) == list(range(len(prompts)))
        for i, (p, n) in enumerate(zip(prompts, self.BUDGETS)):
            want = jgenerate(jm, variables, p[None], max_new_tokens=n,
                             max_len=16, use_cache=False)[0]
            np.testing.assert_array_equal(got[i], want)
            np.testing.assert_array_equal(got[i],
                                          _reference(port, p, n, 16))
            assert got[i].dtype == np.int32
        # 5 sequences through 2 slots: fewer steps than one at a time
        assert pgen.steps < sum(self.BUDGETS)

    def test_mid_flight_admission(self, target):
        port = target[2]
        prompts = _prompts(seed=4, sizes=(4, 2, 5))
        reg = MetricsRegistry()
        gen = ContinuousGenerator(port, slots=2, max_len=12, registry=reg,
                                  device="cpu")
        gen.submit("a", prompts[0], 6)
        gen.submit("b", prompts[1], 2)
        done = {}
        for _ in range(2):
            done.update(gen.step())
        assert list(done) == ["b"]               # b's slot is free now
        gen.submit("c", prompts[2], 3)           # admitted mid-flight
        done.update(gen.run_until_drained())
        for sid, p, n in (("a", prompts[0], 6), ("b", prompts[1], 2),
                          ("c", prompts[2], 3)):
            np.testing.assert_array_equal(done[sid],
                                          _reference(port, p, n, 12))
        # c ran beside a: 6 steps in all, not 6 + 3
        assert gen.steps == 6

    def test_sampled_reproducible_and_refusals(self, target):
        port = target[2]
        prompts = _prompts(seed=8, sizes=(3, 4))
        runs = []
        for seed in (3, 3, 4):
            gen = ContinuousGenerator(port, slots=2, max_len=14,
                                      temperature=0.9, seed=seed,
                                      registry=MetricsRegistry(),
                                      device="cpu")
            for i, p in enumerate(prompts):
                gen.submit(i, p, 8)
            runs.append(gen.run_until_drained())
        for i, p in enumerate(prompts):
            np.testing.assert_array_equal(runs[0][i], runs[1][i])
            assert (runs[0][i][len(p):len(p) + 8] != 0).all()
        assert any(not np.array_equal(runs[0][i], runs[2][i])
                   for i in range(len(prompts)))
        gen = ContinuousGenerator(port, slots=1, max_len=8,
                                  registry=MetricsRegistry(), device="cpu")
        with pytest.raises(ValueError, match="empty"):
            gen.submit(0, [], 2)
        with pytest.raises(ValueError, match="pad_id"):
            gen.submit(0, [3, 0, 4], 2)
        with pytest.raises(ValueError, match="max_len"):
            gen.submit(0, [3, 4, 5], 6)
        bidirectional = MaskedLMModel(TextEncoder(
            **ARCH, depth=1, dtype=torch.float32,
            generator=torch.Generator().manual_seed(0)))
        with pytest.raises(ValueError, match="FUTURE"):
            ContinuousGenerator(bidirectional, device="cpu",
                                registry=MetricsRegistry()).submit(0, [3, 4],
                                                                   2)


# name -> (self-draft?, k, rows, prompt length, new tokens)
SPEC_CASES = {"self_draft": (True, 3, 1, 7, 12),
              "bad_draft": (False, 4, 1, 7, 10),
              "k1": (True, 1, 1, 7, 17),
              "batched": (False, 3, 3, 6, 9),
              "batched_self_draft": (True, 2, 3, 6, 9)}


class TestSpeculative:
    @pytest.mark.parametrize("case", sorted(SPEC_CASES))
    def test_greedy_ids_and_rate_equal_jax(self, target, draft, case):
        own, k, B, Tp, new = SPEC_CASES[case]
        jm, jv, port = target
        jd, jdv, pdraft = target if own else draft
        ids = np.random.default_rng(B * 100 + Tp + k).integers(
            2, VOCAB, size=(B, Tp)).astype(np.int32)
        want, want_rate = jgenerate_speculative(jm, jv, jd, jdv, ids,
                                                max_new_tokens=new, k=k)
        got, rate = generate_speculative(port, pdraft, ids,
                                         max_new_tokens=new, k=k,
                                         device="cpu")
        np.testing.assert_array_equal(got, np.asarray(want))
        assert rate == want_rate
        np.testing.assert_array_equal(
            got, generate(port, ids, max_new_tokens=new, device="cpu"))
        if own:                                  # every proposal accepted
            assert rate == new / -(-new // (k + 1))

    def test_refusals(self, target, draft):
        port, pdraft = target[2], draft[2]
        with pytest.raises(ValueError, match="dense prompt"):
            generate_speculative(port, port, np.array([[5, 0, 7]], np.int32),
                                 max_new_tokens=4, device="cpu")
        with pytest.raises(ValueError, match="at least one"):
            generate_speculative(port, pdraft, np.array([[5, 7]]),
                                 max_new_tokens=4, k=0, device="cpu")
        with pytest.raises(ValueError, match=r"\[B, Tp\]"):
            generate_speculative(port, pdraft, np.array([5, 7]),
                                 max_new_tokens=4, device="cpu")
        other = MaskedLMModel(TextEncoder(
            vocab=32, width=32, depth=1, heads=2, mlp_dim=64,
            dtype=torch.float32, attention_fn=make_attention_fn(
                "dense", causal=True)))
        with pytest.raises(ValueError, match="vocabulary"):
            generate_speculative(port, other, np.array([[5, 7]]),
                                 max_new_tokens=4, device="cpu")

    def test_acceptance_reproduces_target_distribution(self):
        """For k = 1 the emitted token (the accepted draft or a draw from
        the residual) is distributed as p_t whatever p_d is: 20,000 draws
        at once through the batched rule."""
        V, N = 5, 20_000
        rng = np.random.default_rng(0)
        p_d = torch.tensor(rng.dirichlet(np.ones(V)), dtype=torch.float32)
        p_t = torch.tensor(rng.dirichlet(np.ones(V)), dtype=torch.float32)
        g = torch.Generator().manual_seed(1)
        d = torch.multinomial(p_d, N, replacement=True, generator=g)
        u = torch.rand(N, generator=g)
        n_acc, repl = _acceptance(p_d.expand(N, 1, V),
                                  torch.stack([p_t, p_t]).expand(N, 2, V),
                                  d[:, None], u[:, None])
        alt = torch.multinomial(repl, 1, generator=g)[:, 0]
        emitted = torch.where(n_acc == 1, d, alt)
        freq = np.bincount(emitted.numpy(), minlength=V) / N
        assert 0.5 * np.abs(freq - p_t.numpy()).sum() <= 0.02, (freq, p_t)
        # full acceptance hands back the bonus row unchanged
        one, bonus = _acceptance(p_t[None], torch.stack([p_t, p_d]),
                                 torch.tensor([int(p_t.argmax())]),
                                 torch.zeros(1))
        assert int(one) == 1 and torch.equal(bonus, p_d)

    def test_sampled_reproducible_by_seed(self, target, draft):
        port, pdraft = target[2], draft[2]
        ids = np.random.default_rng(2).integers(2, VOCAB, size=(2, 5))
        runs = [generate_speculative(port, pdraft, ids, max_new_tokens=10,
                                     k=3, temperature=0.8, seed=s,
                                     device="cpu") for s in (5, 5, 6)]
        np.testing.assert_array_equal(runs[0][0], runs[1][0])
        assert runs[0][1] == runs[1][1] and runs[0][1] >= 1.0
        assert (runs[0][0][:, 5:] != 0).all()
        assert not np.array_equal(runs[0][0], runs[2][0])


class TestTextGenerator:
    CORPUS = ["abc abd", "bcd bce", "abc bcd", "abd bce"]
    PROMPTS = ["abc", "", "bcd bce", "abd"]

    @pytest.fixture(scope="class")
    def tokenizers(self):
        corpus = np.asarray(self.CORPUS, object)
        kw = dict(vocabSize=VOCAB, maxLength=8, inputCol="text",
                  outputCol="tokens")
        jtok = JBpeTokenizer(**kw).fit(JDataFrame({"text": corpus}))
        tok = BpeTokenizer(**kw).fit(DataFrame({"text": corpus}))
        assert list(tok.get("vocabulary")) == list(jtok.get("vocabulary"))
        return jtok, tok

    @pytest.mark.parametrize("draft_kind", [None, "self", "other"])
    def test_greedy_text_equals_jax(self, target, draft, tokenizers,
                                    draft_kind):
        jtok, tok = tokenizers
        jm, jv, port = target
        jd, jdv, pdraft = {None: (None, None, None), "self": target,
                           "other": draft}[draft_kind]
        prompts = np.asarray(self.PROMPTS, object)
        want = JTextGenerator(
            tokenizer=jtok, lm=(jm, jv), maxNewTokens=3,
            draftLm=None if jd is None else (jd, jdv),
            speculativeK=2).transform(JDataFrame({"text": prompts}))
        got = TextGenerator(tokenizer=tok, lm=port, maxNewTokens=3,
                            draftLm=pdraft, speculativeK=2,
                            device="cpu").transform(
            DataFrame({"text": prompts}))
        assert list(got["generated"]) == list(want["generated"])
        assert all(isinstance(g, str) and g for g in got["generated"])
        empty = TextGenerator(tokenizer=tok, lm=port, device="cpu") \
            .transform(DataFrame({"text": np.empty(0, object)}))
        assert len(empty["generated"]) == 0
