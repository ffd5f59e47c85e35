"""The port's ``CheckpointManager``: the counterpart of
``tests/test_checkpoint_profiling.py::TestCheckpoint``.

The port keeps its own on-disk format (``torch.save`` of the model's and
optimizer's state dicts and the step), so nothing is compared with orbax
files. The JAX package's ``CheckpointManager`` and the port's are driven
through one sequence in sibling directories (saves with retention, an empty
step dir, a step dir with a stray file, a garbled step, resume-latest and
explicit restores): ``all_steps``, ``latest_step``, the step and weights a
restore lands on, which restores raise and the skip counter's deltas are
equal after every operation. A masked-LM run saved at step 3 and resumed in
a fresh model gives, at steps 4-6, the JAX package's uninterrupted losses
from the same weights (rtol 1e-4, the pretraining tests' tolerance). The
other contracts are the reference's:
- save, restore and resume: a run restored at step 3 and trained 3 more
  steps gives the uninterrupted run's losses and parameters exactly (the
  plain versions of K2b/K2d/K2e on the CPU are deterministic), for a small
  network and for a masked-LM model with ``pallas`` attention;
- AdamW's moments and step come back exactly;
- retention (``max_to_keep``), ``all_steps``, ``latest_step``;
- partial (empty) and corrupt step dirs are skipped and counted in
  ``resilience_checkpoint_skipped_total`` once each; an explicit corrupt step
  raises;
- a save that raises mid-write leaves no ``step_*`` dir and no temp dir.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mmlspark_tpu.dl.checkpoint as jckpt
import mmlspark_torch.dl.checkpoint as ckpt
from mmlspark_tpu.dl.pretrain import MaskedLMModel as JMaskedLMModel
from mmlspark_tpu.dl.pretrain import pretrain_masked_lm as jpretrain
from mmlspark_tpu.dl.text_encoder import TextEncoder as JTextEncoder
from mmlspark_tpu.dl.text_encoder import make_attention_fn as jmake_attention
from mmlspark_tpu.dl.train import TrainState as JTrainState
from mmlspark_torch.dl import (MaskedLMModel, TextEncoder, TrainState,
                               make_attention_fn, make_train_step,
                               mask_batch, masked_xent)
from mmlspark_torch.dl.checkpoint import CheckpointManager
from mmlspark_torch.dl.pretrain import default_optimizer
from mmlspark_torch.models import masked_lm_from_flax


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


class Tiny(torch.nn.Module):
    def __init__(self, seed=0):
        super().__init__()
        with torch.random.fork_rng():
            torch.manual_seed(seed)
            self.body = torch.nn.Sequential(torch.nn.Linear(6, 16),
                                            torch.nn.ReLU(),
                                            torch.nn.Linear(16, 3))

    def forward(self, x, train=False):
        return {"logits": self.body(x)}


def tiny_state(seed=0):
    model = Tiny(seed)
    opt = torch.optim.AdamW(model.parameters(), lr=1e-2)
    return TrainState(model, opt), make_train_step(model, opt)


def tiny_batches(n=6):
    rng = np.random.default_rng(0)
    return [(torch.from_numpy(rng.normal(size=(8, 6)).astype(np.float32)),
             torch.from_numpy(rng.integers(0, 3, size=8)))
            for _ in range(n)]


def skipped(reason):
    return ckpt._m_skipped.value(reason=reason)


def run_interrupted(make, batches, tmp_path, save_at=3):
    """An uninterrupted run over ``batches``, saved at ``save_at``; then a
    fresh state restored from that save and run over the rest."""
    state, step = make(0)
    mgr = CheckpointManager(str(tmp_path / "ckpt"), max_to_keep=2)
    losses = []
    for i, (x, y) in enumerate(batches):
        state, loss = step(state, x, y)
        losses.append(loss)
        if i + 1 == save_at:
            mgr.save(state)
    fresh, fresh_step = make(1)                    # other initial weights
    restored = mgr.restore(target=fresh)
    assert restored is fresh and restored.step == save_at
    resumed = []
    for x, y in batches[save_at:]:
        restored, loss = fresh_step(restored, x, y)
        resumed.append(loss)
    return state, losses, restored, resumed, mgr


class TestCheckpoint:
    def test_save_restore_resume(self, tmp_path):
        state, losses, restored, resumed, mgr = run_interrupted(
            tiny_state, tiny_batches(), tmp_path)
        assert mgr.latest_step() == 3 and mgr.all_steps() == [3]
        assert restored.step == state.step == 6
        for a, b in zip(losses[3:], resumed):
            assert torch.equal(a, b)
        for (n, a), (_, b) in zip(state.model.state_dict().items(),
                                  restored.model.state_dict().items()):
            assert torch.equal(a, b), n

    def test_masked_lm_resume_through_pallas(self, tmp_path):
        vocab = 64
        rng = np.random.default_rng(3)
        ids = rng.integers(1, vocab - 1, size=(16, 24)).astype(np.int32)
        ids[::3, 17:] = 0
        batches = []
        for _ in range(6):
            rows = ids[rng.integers(0, len(ids), size=4)]
            x, y = mask_batch(rows, rng, mask_id=vocab - 1)
            batches.append((torch.from_numpy(x), torch.from_numpy(y)))

        def make(seed):
            gen = torch.Generator().manual_seed(seed)
            model = MaskedLMModel(TextEncoder(
                vocab=vocab, width=32, depth=2, heads=2, mlp_dim=64,
                dtype=torch.float32, generator=gen,
                attention_fn=make_attention_fn("pallas")), gen)
            opt = default_optimizer(1e-3)(list(model.parameters()))
            return TrainState(model, opt), make_train_step(
                model, opt, loss_fn=masked_xent, fetch="logits")

        state, losses, restored, resumed, _ = run_interrupted(
            make, batches, tmp_path)
        assert all(torch.equal(a, b) for a, b in zip(losses[3:], resumed))
        for (n, a), (_, b) in zip(state.model.state_dict().items(),
                                  restored.model.state_dict().items()):
            assert torch.equal(a, b), n

    def test_adamw_moments_restored(self, tmp_path):
        state, step = tiny_state(0)
        for x, y in tiny_batches(2):
            state, _ = step(state, x, y)
        mgr = CheckpointManager(str(tmp_path / "ckpt"))
        mgr.save(state)
        fresh, _ = tiny_state(5)
        restored = mgr.restore(target=fresh)
        live = state.optimizer.state_dict()
        back = restored.optimizer.state_dict()
        assert live["param_groups"] == back["param_groups"]
        assert sorted(live["state"]) == sorted(back["state"])
        for i, moments in live["state"].items():
            assert sorted(moments) == ["exp_avg", "exp_avg_sq", "step"]
            for name, t in moments.items():
                assert torch.equal(t, back["state"][i][name]), (i, name)
        with pytest.raises(ValueError, match="target"):
            mgr.restore()

    def test_retention(self, tmp_path):
        state, _ = tiny_state()
        mgr = CheckpointManager(str(tmp_path / "ckpt"), max_to_keep=2)
        for s in (1, 2, 3, 4):
            path = mgr.save(state, step=s)
        assert os.path.basename(path) == "step_0000000004"
        assert mgr.all_steps() == [3, 4] and mgr.latest_step() == 4

    def test_partial_and_corrupt_dirs_skipped_and_counted(self, tmp_path):
        state, _ = tiny_state()
        mgr = CheckpointManager(str(tmp_path / "ckpt"), max_to_keep=5)
        mgr.save(state, step=2)
        os.makedirs(os.path.join(mgr.directory, "step_0000000007"))
        partial0, corrupt0 = skipped("partial"), skipped("corrupt")
        assert mgr.all_steps() == [2]
        assert mgr.all_steps() == [2]                 # listed twice
        assert skipped("partial") == partial0 + 1     # counted once
        bad = os.path.join(mgr.directory, "step_0000000009")
        os.makedirs(bad)
        with open(os.path.join(bad, ckpt.STATE_FILE), "wb") as f:
            f.write(b"not a checkpoint")
        assert mgr.all_steps() == [2, 9]
        fresh, _ = tiny_state(3)
        assert mgr.restore(target=fresh).step == 2    # fell back
        assert skipped("corrupt") == corrupt0 + 1
        with pytest.raises(Exception):
            mgr.restore(step=9, target=fresh)         # asked for that one
        assert skipped("partial") == partial0 + 1

    def test_crash_mid_write_leaves_no_step(self, tmp_path, monkeypatch):
        state, _ = tiny_state()
        mgr = CheckpointManager(str(tmp_path / "ckpt"))

        def torn(payload, path):
            with open(path, "wb") as f:
                f.write(b"half")
            raise OSError("disk full")

        monkeypatch.setattr(ckpt, "_write", torn)
        with pytest.raises(OSError, match="disk full"):
            mgr.save(state, step=1)
        assert os.listdir(mgr.directory) == []
        assert mgr.all_steps() == [] and mgr.latest_step() is None
        with pytest.raises(FileNotFoundError):
            mgr.restore(target=state)


class Weights(torch.nn.Module):
    """One [2, 3] parameter: the port's counterpart of the JAX state below."""

    def __init__(self, value):
        super().__init__()
        self.w = torch.nn.Parameter(torch.as_tensor(value))


def w_of(step):
    """Step-distinct weights, so a restore shows which step it landed on."""
    return np.arange(6, dtype=np.float32).reshape(2, 3) * step


def jax_state(step):
    return JTrainState(params={"w": w_of(step)},
                       batch_stats={"m": np.zeros(3, np.float32)},
                       opt_state={"mu": np.ones(3, np.float32)},
                       step=np.asarray(step, np.int32))


def port_state(step):
    model = Weights(w_of(step))
    return TrainState(model, torch.optim.SGD(model.parameters(), lr=0.1),
                      step)


def garble(step_dir):
    """Overwrite every file of a step dir (a torn copy from a non-atomic
    writer), as the reference's resilience tests do."""
    for root, _, files in os.walk(step_dir):
        for f in files:
            with open(os.path.join(root, f), "wb") as fh:
                fh.write(b"\x00garbage\x00")


class TestAgainstJaxManager:
    def test_same_sequence_same_listing_restores_and_counts(self, tmp_path):
        jmgr = jckpt.CheckpointManager(str(tmp_path / "jax"), max_to_keep=2)
        mgr = CheckpointManager(str(tmp_path / "port"), max_to_keep=2)

        def skips():
            return [(m.value(reason="partial"), m.value(reason="corrupt"))
                    for m in (jckpt._m_skipped, ckpt._m_skipped)]

        def plant(name, content=None):
            for m in (jmgr, mgr):
                os.makedirs(os.path.join(m.directory, name))
                if content is not None:
                    with open(os.path.join(m.directory, name, content),
                              "w") as f:
                        f.write("stray")

        def restore(step=None):
            """(step, w) each manager lands on, or the exception type's
            name where it raises."""
            out = []
            for m, target in ((jmgr, None), (mgr, port_state(0))):
                try:
                    r = m.restore(step=step, target=target)
                except Exception as e:
                    out.append(type(e).__name__)
                    continue
                w = (np.asarray(r.params["w"]) if target is None
                     else r.model.w.detach().numpy())
                out.append((int(r.step), w.tolist()))
            return out

        before = skips()

        def same(want_steps, want_delta):
            got = [(m.all_steps(), m.latest_step()) for m in (jmgr, mgr)]
            assert got[0] == got[1] == (want_steps, want_steps[-1])
            (jp, jc), (pp, pc) = skips()
            (jp0, jc0), (pp0, pc0) = before
            assert (jp - jp0, jc - jc0) == (pp - pp0, pc - pc0) == want_delta

        for s in (1, 2, 3, 4):
            jmgr.save(jax_state(s), step=s)
            mgr.save(port_state(s), step=s)
        same([3, 4], (0, 0))                          # retention
        plant("step_0000000007")                      # empty: partial
        same([3, 4], (1, 0))
        same([3, 4], (1, 0))                          # counted once
        jmgr.save(jax_state(9), step=9)
        mgr.save(port_state(9), step=9)
        same([4, 9], (1, 0))
        garble(jmgr._step_dir(9))
        garble(mgr._step_dir(9))
        plant("step_0000000008", content="stray.txt")  # listed, unloadable
        same([4, 8, 9], (1, 0))
        j, p = restore()                              # falls back twice
        assert j == p == (4, w_of(4).tolist())
        same([4, 8, 9], (1, 2))
        for step in (9, 8, 7):                        # asked for that one
            j, p = restore(step)
            assert isinstance(j, str) and isinstance(p, str), step
        same([4, 8, 9], (1, 2))
        j, p = restore(4)
        assert j == p == (4, w_of(4).tolist())

    def test_masked_lm_resume_gives_jax_uninterrupted_losses(self, tmp_path):
        arch = dict(vocab=64, width=32, depth=2, heads=2, mlp_dim=64)
        batch, steps, save_at = 3, 6, 3
        rng = np.random.default_rng(11)
        ids = rng.integers(1, 63, size=(12, 24)).astype(np.int32)
        ids[::4, 15:] = 0
        jenc = JTextEncoder(**arch, dtype=jnp.float32,
                            attention_fn=jmake_attention("dense"))
        _, jlosses = jpretrain(jenc, ids, steps=steps, batch_size=batch,
                               seed=0)
        # the weights the JAX run started from (its init at seed 0)
        params = jax.tree_util.tree_map(np.asarray, jax.jit(
            JMaskedLMModel(jenc).init, static_argnums=2)(
            jax.random.PRNGKey(0), jnp.asarray(ids[:1]), True)["params"])

        def make(p):
            model = masked_lm_from_flax(p, heads=arch["heads"],
                                        dtype=torch.float32,
                                        attention_fn=make_attention_fn(
                                            "pallas"))
            opt = default_optimizer(1e-3)(list(model.parameters()))
            return TrainState(model, opt), make_train_step(
                model, opt, loss_fn=masked_xent, fetch="logits")

        # the JAX run's batches, bit for bit (seeded as pretrain_masked_lm)
        brng = np.random.default_rng(0)
        batches = []
        for _ in range(steps):
            rows = ids[brng.integers(0, len(ids), size=batch)]
            x, y = mask_batch(rows, brng, mask_id=arch["vocab"] - 1)
            batches.append((torch.from_numpy(x), torch.from_numpy(y)))
        state, step = make(params)
        for x, y in batches[:save_at]:
            state, _ = step(state, x, y)
        mgr = CheckpointManager(str(tmp_path / "ckpt"))
        mgr.save(state)
        fresh, fresh_step = make(jax.tree_util.tree_map(np.zeros_like,
                                                        params))
        restored = mgr.restore(target=fresh)
        assert restored.step == save_at
        resumed = []
        for x, y in batches[save_at:]:
            restored, loss = fresh_step(restored, x, y)
            resumed.append(float(loss))
        np.testing.assert_allclose(resumed, jlosses[save_at:], rtol=1e-4)
