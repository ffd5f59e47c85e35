"""The port's kernel autotuner (``mmlspark_torch/perf/autotune.py``) and the
kernels' tile resolution, on the CPU.

``test_torch_costmodel.py`` runs the reference's autotuner scenarios that
read no TPU kernel's tiles against the port unchanged. Here are the port
versions of the others, on the CUDA kernels' own cuts and limits:
``test_perf.py``'s ``test_attention_candidates_respect_vmem_budget``,
``TestPagedAutotune`` and ``TestKernelsConsultRegistry``, and
``test_paged_attention.py``'s ``TestKernelTuned``. Then both packages'
searches write the same registry bytes for the same grid and timings and
their key functions agree; every grid starts at the kernel's untuned plan
and stays within the kernel's limits, and the forward's instance list
equals the instantiations in ``csrc/flash_tuned.cu``; the wrappers' CUDA
route, through stand-ins of the compiled libraries, launches the tiles an
explicit argument, else a winner, else the plan names, with a new winner
taking effect at the next call. The numbers a tile changes are held
through the plain partial versions at the tuned cut against the default
cut (f32, within 1e-5: only the order of the float sums moves).
"""

import json
import os
import re
import types

import numpy as np
import pytest
import torch

import mmlspark_torch.dl.flash_attention as k2
import mmlspark_torch.dl.paged_attention as k3
import mmlspark_torch.lightgbm.hist as k1
import mmlspark_tpu.perf.autotune as jautotune
from mmlspark_torch.obs.metrics import MetricsRegistry
from mmlspark_torch.parallel.ring_attention import blockwise_attention
from mmlspark_torch.perf import autotune
from test_torch_paged import decode_route, paged_inputs  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(REPO, "mmlspark_torch", "dl", "csrc")
SMS = autotune.H100_SMS
ATOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Single-threaded torch for this module: tier-1 runs in several
    worker processes at once, and torch's intra-op threads in each of
    them oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def empty_table():
    """Every test starts and ends with no winner in the process."""
    autotune.clear()
    yield
    autotune.clear()


def win(kernel, key, **tiles):
    autotune._WINNERS[f"{kernel}|{key}|{autotune.CUDA}"] = {**tiles,
                                                           "ms": 1.0}


def hits(kernel):
    return autotune.lookup_stats()["hits"].get(kernel, 0)


def hist_smem(plan, F, B, bin_bytes):
    """``csrc/hist.cu``'s ``smem_bytes`` for a plan."""
    return plan.fb * B * 16 + k1.STAGES * (
        plan.stage_rows * (F * bin_bytes + 12) + 8)


def tuned_tiles_in_source():
    with open(os.path.join(CSRC, "flash_tuned.cu")) as f:
        src = f.read()
    return tuple((int(a), int(b))
                 for a, b in re.findall(r"^\s*TILE\((\d+), (\d+)\)$", src,
                                        re.M))


# ------------------------------------- port versions of the reference tests

def test_attention_candidates_respect_vmem_budget():
    """The forward's grid at D = 64: the default instance first, then
    every tuned instance of ``flash_tuned.cu``, each within ``Tile``'s
    232,448 bytes of shared memory; other head dims, f32 and the wide
    route have their default alone."""
    cands = autotune.attention_candidates(2048, 64)
    built = ((128, 4),) + tuned_tiles_in_source()
    assert [(c["block_k"], c["stages"]) for c in cands] == list(built)
    for c in cands:
        assert c["block_q"] == k2.BLOCK_Q == 128
        assert k2.forward_smem(64, c["block_k"], c["stages"]) <= 232448
        assert c["block_k"] in (32, 64, 128) and c["stages"] >= 2
    for D in (32, 128, 256):
        bk, st = k2.default_tile(D)
        assert autotune.attention_candidates(2048, D) == [
            {"block_q": 128, "block_k": bk, "stages": st}]
        assert k2.forward_smem(D, bk, st) <= 232448
    for D, itemsize in ((64, 4), (512, 2), (1024, 2)):
        assert autotune.attention_candidates(300, D, itemsize=itemsize) \
            == [{"block_q": None, "block_k": None, "stages": None}]


class TestPagedAutotune:
    """The ``paged_attn`` kernel entry in the port's names: ``chunk`` x
    ``stage_positions`` over K3's split-KV decode kernel, each chunk with
    the grid target ``ctas_per_sm`` it comes from."""

    CTX, BL, HEADS, HD = 4096, 128, 8, 64

    def _fake_measure(self, timings):
        def measure(cfg):
            v = timings[(cfg["chunk"], cfg["stage_positions"])]
            if isinstance(v, Exception):
                raise v
            return v
        return measure

    def _cands(self):
        return autotune.paged_candidates(self.CTX, self.BL, self.HEADS,
                                         self.HD)

    def test_candidates_default_first_unique_and_block_bounded(self):
        cands = self._cands()
        MB = self.CTX // self.BL
        plan = k3.decode_plan(4, self.HEADS, 1, self.HD, self.BL, MB, 2,
                              SMS)
        # the kernel's untuned plan is always representable
        assert cands[0] == {"chunk": plan.L, "stage_positions": plan.P,
                            "ctas_per_sm": 2}
        pairs = [(c["chunk"], c["stage_positions"]) for c in cands]
        assert len(pairs) == len(set(pairs)) >= 3
        for L, P in pairs:
            # whole stages a chunk, at most 16 positions a stage, and a
            # plan the kernel takes (shared memory, the combine's chunks)
            assert L % 16 == 0 and L % P == 0 and 1 <= P <= 16
            got = k3.decode_plan(4, self.HEADS, 1, self.HD, self.BL, MB, 2,
                                 SMS, L, P)
            assert got.L * got.n_chunks >= MB * self.BL

    def test_deterministic_registry(self, tmp_path):
        cands = self._cands()
        timings = {(c["chunk"], c["stage_positions"]): 4.0 + 0.1 * i
                   for i, c in enumerate(cands)}
        paths = []
        for name in ("a.json", "b.json"):
            autotune.clear()
            p = str(tmp_path / name)
            rec = autotune.tune_paged_attention(
                self.CTX, self.BL, self.HEADS, self.HD, platform="testpf",
                measure=self._fake_measure(timings), path=p,
                registry=MetricsRegistry())
            assert rec["winner"] is not None
            paths.append(p)
        a, b = (open(p, "rb").read() for p in paths)
        assert a == b

    def test_all_invalid_persists_nothing(self, tmp_path):
        timings = {(c["chunk"], c["stage_positions"]):
                   RuntimeError("launch failed") for c in self._cands()}
        p = str(tmp_path / "t.json")
        rec = autotune.tune_paged_attention(
            self.CTX, self.BL, self.HEADS, self.HD, platform="testpf",
            measure=self._fake_measure(timings), path=p,
            registry=MetricsRegistry())
        assert rec["winner"] is None
        assert not os.path.exists(p)
        assert autotune.kernel_winner(
            "paged_attn", autotune.paged_key(self.CTX, self.HD),
            "testpf") is None

    def test_roundtrip_lookup_and_bucketing(self, tmp_path):
        cands = self._cands()
        best = cands[-1]
        timings = {(c["chunk"], c["stage_positions"]): 9.0 for c in cands}
        timings[(best["chunk"], best["stage_positions"])] = 1.0
        p = str(tmp_path / "t.json")
        autotune.tune_paged_attention(
            self.CTX, self.BL, self.HEADS, self.HD, platform="testpf",
            measure=self._fake_measure(timings), path=p,
            registry=MetricsRegistry())
        autotune.clear()
        assert autotune.load(p) == 1
        w = autotune.kernel_winner(
            "paged_attn", autotune.paged_key(self.CTX, self.HD), "testpf")
        assert w is not None
        assert (w["chunk"], w["stage_positions"]) == \
            (best["chunk"], best["stage_positions"])
        assert autotune.paged_key(3000, self.HD) == \
            autotune.paged_key(self.CTX, self.HD)
        assert autotune.paged_key(self.CTX, self.HD, w=3) != \
            autotune.paged_key(self.CTX, self.HD)
        assert autotune.kernel_winner(
            "paged_attn", autotune.paged_key(self.CTX, self.HD),
            "tpu") is None


def partial_sums(bins, vals, B, plan):
    return k1.hist_partials_torch(bins, vals, num_bins=B,
                                  rows_per_cta=plan.rows_per_cta).sum(0)


def hist_case(n, F, B, seed):
    """Seeded bins and vals on a 2^-10 grid: every f32 sum of them is
    exact, so any two cuts of the rows must give the same histogram."""
    rng = np.random.default_rng(seed)
    bins = torch.from_numpy(rng.integers(0, B, size=(n, F)).astype(
        np.int32))
    vals = np.round(rng.normal(size=(n, 3)) * 1024) / 1024
    return bins, torch.from_numpy(vals.astype(np.float32))


class TestKernelsConsultRegistry:
    def test_hist_uses_winner_and_matches_default(self):
        """A registered winner changes K1's cut (lookup hit observed) and
        the plain first pass at that cut sums to the default cut's
        histogram."""
        n, F, B = 4096, 16, 32
        bins, vals = hist_case(n, F, B, 3)
        default = k1.hist_tiles(n, F, B, 4, SMS)
        tuned_cfg = autotune.hist_candidates(n, F, B, bin_bytes=4)[-1]
        win("hist", autotune.hist_key(n, F, B), **tuned_cfg)
        h0 = hits("hist")
        tuned = k1.hist_tiles(n, F, B, 4, SMS)
        assert hits("hist") > h0
        assert (tuned.fb, tuned.stage_rows) == (tuned_cfg["feat_block"],
                                                tuned_cfg["block_rows"])
        assert tuned.rows_per_cta != default.rows_per_cta
        want = partial_sums(bins, vals, B, default)
        np.testing.assert_allclose(partial_sums(bins, vals, B, tuned), want,
                                   rtol=0, atol=ATOL)
        np.testing.assert_allclose(k1.hist_torch(bins, vals, num_bins=B),
                                   want, rtol=0, atol=ATOL)
        # explicit args always beat the winner
        explicit = k1.hist_tiles(n, F, B, 4, SMS,
                                 feat_block=default.fb,
                                 block_rows=default.stage_rows)
        assert explicit == default

    def test_hist_feat_block_16_matches_default(self):
        n, F, B = 4096, 20, 8
        bins, vals = hist_case(n, F, B, 4)
        default = k1.hist_plan(n, F, B, 4, SMS)
        wide = k1.hist_plan(n, F, B, 4, SMS, 16, 64)
        assert (default.n_fb, wide.n_fb) == (1, 2)
        assert wide.rows_per_cta != default.rows_per_cta
        np.testing.assert_allclose(partial_sums(bins, vals, B, wide),
                                   partial_sums(bins, vals, B, default),
                                   rtol=0, atol=ATOL)

    def test_flash_uses_winner_and_matches_default(self):
        """A winner picks the forward's instance; the key-tiled online
        softmax at its key tile equals it at the default's and the dense
        plain version."""
        rng = np.random.default_rng(5)
        B, H, T, D = 1, 2, 200, 64
        q, k, v = (torch.from_numpy(rng.normal(size=(B, H, T, D)).astype(
            np.float32)) for _ in range(3))
        assert k2.forward_tiles(T, D) == k2.default_tile(D) == (128, 4)
        win("flash_attention", autotune.attn_key(T, D, False), block_q=128,
            block_k=64, stages=3)
        h0 = hits("flash_attention")
        bk, st = k2.forward_tiles(T, D)
        assert (bk, st) == (64, 3) and hits("flash_attention") > h0
        default = blockwise_attention(q, k, v, block_size=128)
        tuned = blockwise_attention(q, k, v, block_size=bk)
        np.testing.assert_allclose(tuned, default, rtol=0, atol=ATOL)
        np.testing.assert_allclose(tuned, k2.flash_torch(q, k, v), rtol=0,
                                   atol=ATOL)
        assert k2.forward_tiles(T, D, block_k=128, stages=2) == (128, 2)

    def test_resolve_blocks_precedence(self):
        key = autotune.attn_key(256, 64, False)
        # untuned: the default instance
        assert k2.forward_tiles(256, 64) == (128, 4)
        # tuned: the winner fills whatever the caller left None
        win("flash_attention", key, block_q=128, block_k=64, stages=3)
        assert k2.forward_tiles(256, 64) == (64, 3)
        assert k2.forward_tiles(256, 64, block_k=128) == (128, 3)
        # explicit always wins over the winner
        assert k2.forward_tiles(256, 64, block_k=128, stages=2) == (128, 2)
        # the causal forward keys apart
        assert k2.forward_tiles(256, 64, causal=True) == (128, 4)
        # a corrupt or unknown winner entry degrades to the default, never
        # raises
        for bad in ({"block_q": "garbage"}, {"block_k": 64},
                    {"block_q": 128, "block_k": 96, "stages": 4},
                    {"block_q": 64, "block_k": 64, "stages": 3},
                    {"block_q": 128, "block_k": 64.0, "stages": 3}):
            autotune._WINNERS[f"flash_attention|{key}|cuda"] = bad
            assert k2.forward_tiles(256, 64) == (128, 4), bad
        # an explicit tile that is not built raises
        with pytest.raises(ValueError, match="no bf16 forward instance"):
            k2.forward_tiles(256, 64, block_k=32, stages=4)
        with pytest.raises(ValueError, match="no bf16 forward instance"):
            k2.forward_tiles(256, 128, block_k=128, stages=4)


class TestKernelTuned:
    """``test_paged_attention.py``'s scenarios on the split-KV decode
    kernel: the winner reaches the launch, the tuned cut equals the
    default one within the float order of the chunk merge."""

    def test_tuned_winner_consulted_and_equal(self, decode_route):
        S, hd, BL, MB = 4, 32, 8, 256
        q, kp, vp, rows, pos = (torch.from_numpy(a) for a in paged_inputs(
            S=S, hd=hd, w=1, BL=BL, MB=MB, seed=21))
        plan = k3.decode_plan(S, q.shape[1], 1, hd, BL, MB, 4, SMS)
        cands = autotune.paged_candidates(MB * BL, BL, q.shape[1], hd,
                                          slots=S, itemsize=4)
        target = next(c for c in cands if c["chunk"] != plan.L)
        timed = {(target["chunk"], target["stage_positions"]): 0.5}
        autotune.tune_paged_attention(
            MB * BL, BL, q.shape[1], hd, slots=S, platform=autotune.CUDA,
            persist=False, registry=MetricsRegistry(),
            measure=lambda c: timed.get(
                (c["chunk"], c["stage_positions"]), 2.0))
        got = k3.decode_tiles(S, q.shape[1], 1, hd, BL, MB, 4, SMS)
        assert (got.L, got.P) == (target["chunk"],
                                  target["stage_positions"])
        tuned = k3.paged_window_attention(q, kp, vp, rows, pos)
        default = k3.paged_decode_cuda(q, kp, vp, rows, pos,
                                       chunk=plan.L,
                                       stage_positions=plan.P)
        (_, _, c_tuned), (_, _, c_default) = decode_route.calls
        assert (c_tuned, c_default) == (got.n_chunks, plan.n_chunks)
        assert c_tuned != c_default
        np.testing.assert_allclose(tuned, default, rtol=0, atol=ATOL)
        np.testing.assert_allclose(tuned, k3.paged_torch(q, kp, vp, rows,
                                                         pos),
                                   rtol=0, atol=ATOL)

    def test_untuned_falls_back_to_defaults(self):
        args = (4, 8, 1, 16, 8, 8, 4, SMS)
        default = k3.decode_plan(*args)
        assert k3.decode_tiles(*args) == default
        # explicit caller values win
        got = k3.decode_tiles(*args, chunk=32, stage_positions=8)
        assert (got.L, got.P, got.n_chunks) == (32, 8, 2)
        # ... and raise where the kernel cannot take them
        for bad in (dict(chunk=24), dict(stage_positions=32),
                    dict(chunk=16, stage_positions=3)):
            with pytest.raises(ValueError):
                k3.decode_tiles(*args, **bad)
        # a winner that does not fit gives the default, never raises
        for bad in (dict(ctas_per_sm=0, stage_positions=16),
                    dict(ctas_per_sm=4, stage_positions=32),
                    dict(chunk=32, stage_positions=8)):
            win("paged_attn", autotune.paged_key(64, 16, 1), **bad)
            assert k3.decode_tiles(*args) == default, bad


def test_decode_winner_recuts_at_each_slot_count():
    """One ``paged_key`` serves every slot count, so the winner's chunk is
    its grid target, cut at each call's slots: tuned at 32 slots, where
    four CTAs a SM give 256-position chunks, it gives 128 at 16 slots
    (where the default is already 256) and a grid of four CTAs a SM at 8,
    never the 32-slot length."""
    H, w, D, BL, MB = 8, 1, 64, 16, 256
    cands = autotune.paged_candidates(MB * BL, BL, H, D, slots=32)
    best = next(c for c in cands if c["ctas_per_sm"] == 4)
    assert best["chunk"] == 256
    win("paged_attn", autotune.paged_key(MB * BL, D, w), **best)
    for S, L in ((32, 256), (16, 128), (8, 64)):
        default = k3.decode_plan(S, H, w, D, BL, MB, 2, SMS)
        got = k3.decode_tiles(S, H, w, D, BL, MB, 2, SMS)
        assert got.L == L and got.P == best["stage_positions"]
        assert got == k3.decode_plan(S, H, w, D, BL, MB, 2, SMS, None,
                                     best["stage_positions"], 4)
        assert 3 * SMS < got.ctas and 2 * got.ctas > 3 * default.ctas
    # an explicit chunk beats the winner's target
    assert k3.decode_tiles(16, H, w, D, BL, MB, 2, SMS, chunk=512).L == 512


def test_attention_measure_takes_the_key_lengths():
    """The search can time the ragged rows a padded batch sends: one
    count a batch row, masking each row's keys from it on."""
    cfg = autotune.attention_candidates(72, 64)[0]
    kw = dict(T=72, D=64, batch=2, heads=1, reps=1, interpret=True)
    assert autotune.measure_attention(cfg, key_lengths=[72, 9], **kw) > 0
    with pytest.raises(ValueError, match="3 counts for a batch of 2"):
        autotune.measure_attention(cfg, key_lengths=[72, 9, 1], **kw)


def test_window_kernel_widths_have_no_candidates(tmp_path):
    """The window kernel reads no winner, so the search offers none and
    persists nothing for its widths."""
    assert autotune.paged_candidates(4096, 16, 8, 64, w=17, slots=4) == []
    p = str(tmp_path / "t.json")
    rec = autotune.tune_paged_attention(4096, 16, 8, 64, w=17,
                                        platform="testpf", path=p,
                                        measure=lambda cfg: 1.0,
                                        registry=MetricsRegistry())
    assert rec["winner"] is None and rec["candidates"] == 0
    assert not os.path.exists(p)


# ------------------------------------------------------- across packages

def test_registry_bytes_equal_reference(tmp_path, monkeypatch):
    """The same grid and the same fake timings through both packages'
    searches write byte-identical registry files."""
    cands = jautotune.hist_candidates(4096, 16, 32)
    for mod in (jautotune, autotune):
        monkeypatch.setattr(mod, "hist_candidates",
                            lambda n, F, B, **_: [dict(c) for c in cands])
    timings = {(c["feat_block"], c["block_rows"]): 3.0 - 0.1 * (i % 4)
               for i, c in enumerate(cands)}

    def measure(cfg):
        return timings[(cfg["feat_block"], cfg["block_rows"])]
    blobs = []
    for mod, name in ((jautotune, "jax.json"), (autotune, "port.json")):
        mod.clear()
        path = str(tmp_path / name)
        mod.tune_hist(4096, 16, 32, platform="testpf", measure=measure,
                      path=path, registry=MetricsRegistry())
        mod.clear()
        with open(path, "rb") as f:
            blobs.append(f.read())
    assert blobs[0] == blobs[1]
    assert json.loads(blobs[1])["version"] == jautotune.REGISTRY_VERSION


def test_keys_agree_with_reference():
    for n in (1, 2, 3, 17, 4096, 4097, 500_000):
        for D in (16, 64, 128):
            assert autotune.hist_key(n, D, 256) == jautotune.hist_key(
                n, D, 256)
            for causal in (False, True):
                assert autotune.attn_key(n, D, causal) == \
                    jautotune.attn_key(n, D, causal)
            for w in (1, 5, 128):
                assert autotune.paged_key(n, D, w) == jautotune.paged_key(
                    n, D, w)
    assert autotune.__all__ == jautotune.__all__


# ----------------------------------------------------------------- grids

@pytest.mark.parametrize("n,F,B,bin_bytes", [
    (500_000, 28, 256, 1), (500_000, 28, 256, 4), (4096, 16, 32, 1),
    (1000, 200, 256, 1), (17, 2, 8, 4), (50_000, 28, 64, 1)])
def test_hist_grid_starts_at_the_plan_and_fits(n, F, B, bin_bytes):
    plan0 = k1.hist_plan(n, F, B, bin_bytes, SMS)
    cands = autotune.hist_candidates(n, F, B, bin_bytes=bin_bytes)
    assert cands[0] == {"feat_block": plan0.fb,
                        "block_rows": plan0.stage_rows}
    assert len({tuple(c.values()) for c in cands}) == len(cands)
    for c in cands:
        plan = k1.hist_plan(n, F, B, bin_bytes, SMS, c["feat_block"],
                            c["block_rows"])
        assert (plan.fb, plan.stage_rows) == tuple(c.values())
        assert hist_smem(plan, F, B, bin_bytes) <= k1.SMEM_LIMIT
        assert plan.stage_rows % 16 == 0 and plan.rows_per_cta % 16 == 0
        assert (plan.grid_x - 1) * plan.rows_per_cta < n \
            <= plan.grid_x * plan.rows_per_cta
    if (n, F, B) == (500_000, 28, 256) and bin_bytes == 1:
        assert plan0 == (28, 1, 132, 3792, 400)


@pytest.mark.parametrize("S,H,w,D,BL,MB,elem", [
    (32, 8, 1, 64, 16, 256, 2), (16, 8, 1, 64, 16, 18, 2),
    (4, 8, 5, 64, 16, 64, 4), (1, 8, 1, 64, 128, 32, 2),
    (32, 8, 16, 256, 16, 256, 2), (2, 4, 1, 1024, 16, 64, 4)])
def test_decode_grid_starts_at_the_plan_and_fits(S, H, w, D, BL, MB, elem):
    plan0 = k3.decode_plan(S, H, w, D, BL, MB, elem, SMS)
    cands = autotune.paged_candidates(MB * BL, BL, H, D, w=w, slots=S,
                                      itemsize=elem)
    assert cands[0] == {"chunk": plan0.L, "stage_positions": plan0.P,
                        "ctas_per_sm": 2}
    if (S, MB) == (32, 256):
        assert (plan0.P, plan0.L, plan0.n_chunks, plan0.ctas) == \
            ((16, 464, 9, 288) if D == 64 else plan0[5:])
    for c in cands:
        plan = k3.decode_plan(S, H, w, D, BL, MB, elem, SMS, c["chunk"],
                              c["stage_positions"])
        # the chunk is the one the grid target gives at these slots
        assert plan == k3.decode_plan(S, H, w, D, BL, MB, elem, SMS, None,
                                      c["stage_positions"], c["ctas_per_sm"])
        smem = 128 + 3 * 2 * plan.P * plan.hg * D * elem + 48
        assert smem <= 232448                       # kSmemMax
        assert plan.n_chunks == 1 or (plan.n_chunks + 256) * 4 <= 48 * 1024
        assert plan.L % plan.P == 0 and plan.L * plan.n_chunks >= MB * BL


def test_forward_instances_equal_the_source():
    """The wrapper's D = 64 instance list is the ``TILE(...)`` list that
    ``flash_tuned.cu`` instantiates, and the defaults are
    ``flash_fwd.cuh``'s ``default_bk``/``default_stages``."""
    assert tuned_tiles_in_source() == k2.TUNED_TILES
    with open(os.path.join(CSRC, "flash_fwd.cuh")) as f:
        src = f.read()

    def pick(fn, D):
        body = re.search(rf"constexpr int {fn}\(int D\) \{{ return "
                         r"([^;]*); \}", src).group(1)
        for cond, value in re.findall(r"D == (\d+) \? (\d+) :", body):
            if D == int(cond):
                return int(value)
        return int(body.rsplit(":", 1)[-1])
    for D in k2.HEAD_DIMS:
        assert k2.default_tile(D) == (pick("default_bk", D),
                                      pick("default_stages", D))
    assert k2.forward_instances(64) == [
        (128, 128, 4), *((128, bk, st) for bk, st in k2.TUNED_TILES)]


# --------------------------------------- the wrappers' CUDA route (stand-ins)

class _Recorder:
    """A compiled library's stand-in that records each launch's tiles and
    returns success (the route, not the numbers, is under test here)."""

    def __init__(self):
        self.calls = []

    def mmlspark_hist_launch(self, bins, bin_bytes, vals, part, out, n, F, B,
                             fb, grid_x, rows_per_cta, stage_rows, *_):
        self.calls.append((fb, grid_x, rows_per_cta, stage_rows))
        return 0

    def mmlspark_flash_launch(self, *args):
        self.calls.append(("default", args[10]))            # D
        return 0

    def mmlspark_flash_tuned_launch(self, *args):
        self.calls.append(("tuned", args[9], *args[-4:-2]))  # D, bk, st
        return 0


@pytest.fixture
def card(monkeypatch):
    """CPU tensors on the kernels' CUDA route: the device checks pass,
    an H100's SM count, a stream, and recording libraries."""
    rec = _Recorder()
    monkeypatch.setattr(k1, "_check_card", lambda bins: None)
    monkeypatch.setattr(k1, "_library", lambda: rec)
    monkeypatch.setattr(k2, "_check_kernel_inputs", lambda fn, q, k, v: None)
    monkeypatch.setattr(k2, "_library", lambda: rec)
    monkeypatch.setattr(k2, "_library_tuned", lambda: rec)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda device=None: types.SimpleNamespace(
                            multi_processor_count=SMS))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(
                            cuda_stream=0))
    return rec


def test_hist_cuda_launches_explicit_then_winner_then_plan(card):
    n, F, B = 4096, 16, 32
    bins, vals = hist_case(n, F, B, 7)
    bins = bins.to(torch.uint8)
    before = k1.hist_cuda.launches
    k1.hist_cuda(bins, vals, num_bins=B)
    plan0 = k1.hist_plan(n, F, B, 1, SMS)
    cfg = autotune.hist_candidates(n, F, B)[2]
    # the winner lands after the first call: the cached plan does not
    # freeze it
    win("hist", autotune.hist_key(n, F, B), **cfg)
    k1.hist_cuda(bins, vals, num_bins=B)
    k1.hist_cuda(bins, vals, num_bins=B, feat_block=plan0.fb,
                 block_rows=plan0.stage_rows)
    tuned = k1.hist_plan(n, F, B, 1, SMS, cfg["feat_block"],
                         cfg["block_rows"])
    assert card.calls == [
        (p.fb, p.grid_x, p.rows_per_cta, p.stage_rows)
        for p in (plan0, tuned, plan0)]
    assert k1.hist_cuda.launches == before + 3
    with pytest.raises(ValueError, match="fb=17"):
        k1.hist_cuda(bins, vals, num_bins=B, feat_block=17)
    with pytest.raises(ValueError, match="multiple of 16"):
        k1.hist_cuda(bins, vals, num_bins=B, block_rows=40)
    autotune._WINNERS[f"hist|{autotune.hist_key(n, F, B)}|cuda"] = {
        "feat_block": 999, "block_rows": 32}
    k1.hist_cuda(bins, vals, num_bins=B)
    assert card.calls[-1][0] == plan0.fb
    assert k1.hist_cuda.launches == before + 4


def test_forward_wrappers_pick_their_library(card):
    rng = np.random.default_rng(9)
    q, k, v = (torch.from_numpy(rng.normal(size=(2, 2, 96, 64)).astype(
        np.float32)).to(torch.bfloat16) for _ in range(3))
    k2.flash_cuda(q, k, v)                                   # no winner
    win("flash_attention", autotune.attn_key(96, 64, False), block_q=128,
        block_k=64, stages=3)
    k2.flash_cuda(q, k, v)                                   # the winner
    k2.flash_lse_cuda(q, k, v)
    k2.flash_causal_cuda(q, k, v)                            # keyed apart
    k2.flash_cuda(q, k, v, block_k=128, stages=4)            # explicit
    k2.flash_causal_cuda(q, k, v, block_k=128, stages=2)
    with torch.no_grad(), pytest.MonkeyPatch.context() as mp:
        mp.setattr(k2, "_route", lambda q, impl: True)
        k2.flash_attention(q, k, v)                          # the switch
    assert card.calls == [("default", 64), ("tuned", 64, 64, 3),
                          ("tuned", 64, 64, 3), ("default", 64),
                          ("default", 64), ("tuned", 64, 128, 2),
                          ("tuned", 64, 64, 3)]
    with pytest.raises(ValueError, match="no bf16 forward instance"):
        k2.flash_cuda(q, k, v, block_k=32)
    # f32 and the padded head dims take no tiles but their own
    with pytest.raises(ValueError, match="route's own tiles"):
        k2.flash_cuda(q.float(), k.float(), v.float(), stages=3)
    card.calls.clear()
    k2.flash_cuda(q[..., :48], k[..., :48], v[..., :48])     # padded to 64
    assert card.calls == [("tuned", 64, 64, 3)]


def test_paged_decode_route_takes_the_winner(decode_route):
    S, hd, BL, MB = 3, 32, 8, 400
    args = [torch.from_numpy(a) for a in paged_inputs(
        S=S, hd=hd, w=1, BL=BL, MB=MB, seed=4)]
    want = k3.paged_torch(*args)
    plan0 = k3.decode_plan(S, args[0].shape[1], 1, hd, BL, MB, 4, SMS)
    out0 = k3.paged_window_attention(*args)
    win("paged_attn", autotune.paged_key(MB * BL, hd, 1), ctas_per_sm=1,
        stage_positions=8)
    out1 = k3.paged_window_attention(*args)
    tuned = k3.decode_plan(S, args[0].shape[1], 1, hd, BL, MB, 4, SMS, None,
                           8, 1)
    assert tuned.n_chunks != plan0.n_chunks
    assert [c[2] for c in decode_route.calls] == [plan0.n_chunks,
                                                  tuned.n_chunks]
    for out in (out0, out1):
        np.testing.assert_allclose(out, want, rtol=0, atol=ATOL)


# ------------------------------------------------------------------- CLI

@pytest.mark.parametrize("argv", [
    ["attention", "--t", "72", "--d", "64", "--heads", "2", "--causal"],
    ["paged", "--context", "256", "--block-len", "16", "--heads", "2",
     "--d", "32", "--slots", "3"]])
def test_cli_interpret_tunes_on_the_plain_partial_versions(tmp_path, argv,
                                                           capsys):
    path = str(tmp_path / "reg.json")
    assert autotune._cli([*argv, "--reps", "1", "--interpret",
                          "--path", path]) == 0
    with open(path) as f:
        (key, entry), = json.load(f)["winners"].items()
    assert key.endswith("|cpu") and entry["ms"] > 0
    autotune.clear()
    assert autotune._cli(["list", "--path", path]) == 0
    assert "1 winner(s)" in capsys.readouterr().out


def test_tuned_library_is_a_store_entry_of_its_own():
    """The tuned instances build into a library of their own, which the
    AOT store keeps beside the default forward's: the same headers, its
    own source, so its key differs and neither rebuilds the other."""
    from mmlspark_torch.core import aot
    loaders = {ld.name: ld for ld in aot.kernel_loaders()}
    tuned, default = loaders["mmlspark_flash_tuned"], loaders["mmlspark_flash"]
    assert [os.path.basename(p) for p in tuned.sources] == ["flash_tuned.cu"]
    assert tuned.headers == default.headers
    assert any(h.endswith("flash_dense.cuh") for h in tuned.headers)
    assert aot.library_key(tuned) != aot.library_key(default)
