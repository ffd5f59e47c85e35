"""Head dims the CUDA attention kernels are not built for (16, 96, 192, 320)
run zero-padded to the next kernel head dim (32, 128, 256, 384), scaled by
the true ``hd^-0.5``, and sliced back; 256 and 512 run as they are. A head
dim wider than the widest instance built for its dtype (256 in bf16, 128 in
f32) runs on the wide kernels (``csrc/attn_wide.cu``), split over D as
``wide_plan`` says: units of 128 columns in bf16 and 64 in f32 summed in a
cluster (two a CTA, up to 16 units), and wider heads in chunks of 128
columns.

Held on the CPU, in f32:
- ``kernel_head_dim``: 1-32 → 32, 33-64 → 64, 65-128 → 128, 129-256 →
  256, above the next multiple of 128 (257-384 → 384, 385-512 → 512), with
  no upper limit; f32 above 128 is not refused: it passes the checks and
  reaches the wide instances;
- ``wide_plan`` at every kernel head dim from 384 to 2,048 in bf16 and from
  256 to 1,024 in f32 takes the cluster kernels (two units a CTA, bf16's
  K2e one, at most 16 CTAs), wider ones the split kernels, and refuses
  none;
- ``pad_head_dim`` followed by the plain versions (forward, lse, the fused
  backward, K3) equals the plain versions unpadded, at hd 16 and 96, with
  the key mask and causal at offsets: atol 1e-6 (zero columns add exact
  zeros; the sums may group differently);
- the kernel wrappers' own padding: ``flash_attention`` and
  ``flash_attention_lse`` under grad run ``_launch_forward`` and
  ``_launch_backward`` against a stand-in for the compiled libraries that
  computes each launch with the plain version from the pointers, strides,
  head dim and scale it is handed, and each wide launch unit by unit as
  ``wide_plan`` splits D, the CTAs it is handed checked against the
  plan (S, and dP, over the whole D; each output unit apart; the lse from
  unit 0 only); o, lse and dq/dk/dv equal the
  unpadded plain versions (atol 1e-5), and the stand-in saw only kernel
  head dims, the true scale, and the wide library exactly where the head
  dim is wider than the f32 instances;
- through that route, ``TextEncoderFeaturizer(attentionImpl="pallas")`` at
  every head dim above with 2 heads, depth 2, equals the JAX package's
  stage on the same weights (atol 1e-4, the text encoder tests' f32
  tolerance), and one SGD step of ``pretrain_masked_lm`` and of
  ``pretrain_causal_lm`` equals the JAX package's (loss rtol 1e-4;
  parameters within 1e-5 of each tensor's largest element);
- the paged engine, whose pools are padded to the kernel's head dim on
  every device, gives the JAX engine's greedy tokens exactly at every head
  dim above;
- the engine's block bytes count the pools as allocated (padded, the
  draft's included), so ``num_blocks=None`` keeps the pools within
  ``hbm_fraction`` of the free memory (on the card: a cuda-marked test).
"""

import ctypes
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import mmlspark_torch.dl.flash_attention as k2
from mmlspark_tpu.core import DataFrame as JDataFrame
from mmlspark_tpu.dl.pretrain import MaskedLMModel as JMaskedLMModel
from mmlspark_tpu.dl.pretrain import pretrain_causal_lm as jpretrain_causal
from mmlspark_tpu.dl.pretrain import pretrain_masked_lm as jpretrain
from mmlspark_tpu.dl.text_encoder import TextEncoder as JTextEncoder
from mmlspark_tpu.dl.text_encoder import \
    TextEncoderFeaturizer as JTextEncoderFeaturizer
from mmlspark_tpu.dl.text_encoder import make_attention_fn as jmake_attention
from mmlspark_tpu.models.zoo import LoadedModel as JLoadedModel
from mmlspark_tpu.models.zoo import ModelSchema as JModelSchema
from mmlspark_tpu.obs.metrics import MetricsRegistry as JRegistry
from mmlspark_tpu.serving.llm import LLMEngine as JLLMEngine
from mmlspark_torch.core import DataFrame
from mmlspark_torch.dl import (MaskedLMModel, TextEncoder,
                               TextEncoderFeaturizer, make_attention_fn,
                               pretrain_causal_lm, pretrain_masked_lm)
from mmlspark_torch.dl import paged_kv
from mmlspark_torch.dl.paged_attention import paged_torch
from mmlspark_torch.models import (LoadedModel, masked_lm_from_flax,
                                   register_text_encoder,
                                   text_encoder_from_flax)
from mmlspark_torch.obs import MetricsRegistry
from mmlspark_torch.serving import LLMEngine

HDS = (16, 96, 192, 256, 320, 512)
PAD_ATOL = 1e-6
ROUTE_ATOL = 1e-5
F32_ATOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Single-threaded torch (tier-1 runs several workers at once)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def qkv(hd, B=2, H=2, T=40, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v, dout = (torch.from_numpy(rng.normal(size=(B, H, T, hd))
                                      .astype(np.float32))
                     for _ in range(4))
    mask = torch.from_numpy(rng.random((B, T)) < 0.8)
    mask[1] = False                          # a batch row with no valid key
    mask[0, 3] = True
    return q, k, v, dout, mask


CASES = [dict(causal=False), dict(causal=True, q_offset=5, k_offset=23)]


def test_kernel_head_dim():
    assert [k2.kernel_head_dim(d)
            for d in (1, 16, 32, 33, 64, 65, 96, 128, 129, 192, 256)] \
        == [32, 32, 32, 64, 64, 128, 128, 128, 256, 256, 256]
    assert [k2.kernel_head_dim(d) for d in (257, 320, 384, 385, 512)] \
        == [384, 384, 384, 512, 512]
    assert k2.kernel_head_dim(4000) == 4096     # no upper limit in code
    assert [k2.wide_head_dim(d, torch.float32) for d in (128, 256, 384)] \
        == [False, True, True]
    assert [k2.wide_head_dim(d, torch.bfloat16) for d in (128, 256, 384)] \
        == [False, False, True]


def test_wide_plan_routes_every_head_dim_to_a_hand_written_kernel():
    for dtype, top in ((torch.bfloat16, 2048), (torch.float32, 1024)):
        low = 384 if dtype == torch.bfloat16 else 256
        unit = 128 if dtype == torch.bfloat16 else 64
        for D in range(low, 4096 + 1, k2.WIDE_CHUNK):
            assert k2.wide_head_dim(D, dtype)
            for kernel in ("fwd", "dq", "dkv"):
                plan = k2.wide_plan(D, dtype, kernel)
                if D <= top:      # a cluster of at most 16 units sums S
                    # two units a CTA, bf16's K2e one
                    per_cta = 1 if (kernel, dtype) == ("dkv",
                                                       torch.bfloat16) else 2
                    assert plan == k2.WidePlan("cluster", unit, D // unit,
                                               -(-D // unit // per_cta))
                    assert plan.units <= k2.WIDE_UNITS_MAX
                    assert plan.ctas <= 16          # the H100's largest
                else:             # wider: the split kernels, never a plain
                    assert plan == k2.WidePlan("split", k2.WIDE_CHUNK,
                                               D // k2.WIDE_CHUNK, 0)
    assert k2.wide_plan(512, torch.bfloat16).ctas == 2
    assert k2.wide_plan(384, torch.bfloat16).ctas == 2      # 3 units
    assert k2.wide_plan(512, torch.bfloat16, "dkv").ctas == 4
    assert k2.wide_plan(2048, torch.bfloat16, "dkv").ctas == 16
    assert k2.wide_plan(2048, torch.bfloat16, "dq").ctas == 8
    assert k2.wide_plan(256, torch.float32, "dkv").ctas == 2
    assert k2.wide_plan(2176, torch.bfloat16).route == "split"
    assert k2.wide_plan(1152, torch.float32).route == "split"


def _on_card(*ts):
    """Stand-ins that pass the kernels' device check (layout only)."""
    return [types.SimpleNamespace(
        device=torch.device("cuda"), dtype=t.dtype, shape=t.shape,
        stride=t.stride, element_size=t.element_size, data_ptr=lambda: 0)
        for t in ts]


@pytest.mark.parametrize("hd", [160, 192, 256])
def test_f32_kernels_refuse_head_dims_above_128(kernel_route, hd):
    """The name is that of the refusal this test once pinned; it now checks
    the repair, and does not expect a refusal: f32 above head dim 128
    passes the kernels' checks and reaches the wide instances (four
    64-column units in a cluster of two CTAs at kernel head dim 256),
    equal to the plain version."""
    q, k, v, _, mask = qkv(hd, T=12, seed=hd)
    k2._check_kernel_inputs("flash_cuda", *_on_card(q, k, v))
    k2._check_kernel_inputs("flash_cuda", *_on_card(
        *(t.to(torch.bfloat16) for t in (q, k, v))))
    with torch.no_grad():
        o = k2.flash_attention(q, k, v, mask)
    np.testing.assert_allclose(o, k2.flash_torch(q, k, v, mask), rtol=0,
                               atol=ROUTE_ATOL)
    assert kernel_route.wide == {256} and kernel_route.dims == {256}


@pytest.mark.parametrize("pos", CASES)
@pytest.mark.parametrize("hd", HDS)
def test_padding_then_plain_equals_plain(hd, pos):
    q, k, v, dout, mask = qkv(hd)
    dk_ = k2.kernel_head_dim(hd)
    pq, pk, pv, pdo = (k2.pad_head_dim(t, dk_) for t in (q, k, v, dout))
    assert pq.shape[-1] == dk_ and not pq[..., hd:].any()
    o, lse = k2.flash_lse_torch(q, k, v, mask, **pos)
    po, plse = k2.flash_lse_torch(pq, pk, pv, mask, scale=hd ** -0.5, **pos)
    np.testing.assert_allclose(po[..., :hd], o, rtol=0, atol=PAD_ATOL)
    assert not po[..., hd:].any()
    np.testing.assert_allclose(plse, lse, rtol=0, atol=PAD_ATOL)
    dlse = torch.linspace(-1, 1, lse.numel()).reshape(lse.shape)
    want = k2.flash_bwd_torch(q, k, v, mask, o, lse, dout, dlse, **pos)
    got = k2.flash_bwd_torch(pq, pk, pv, mask, po, plse, pdo, dlse,
                             scale=hd ** -0.5, **pos)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g[..., :hd], w, rtol=0, atol=PAD_ATOL)


@pytest.mark.parametrize("hd", HDS)
def test_paged_plain_reads_padded_pools(hd):
    rng = np.random.default_rng(3)
    S, H, w, BL, MB = 3, 2, 2, 4, 3
    NB = 1 + S * MB
    rows = torch.arange(1, NB, dtype=torch.int32).reshape(S, MB)
    pos = torch.tensor([1, 6, 9], dtype=torch.int32)
    q = torch.from_numpy(rng.normal(size=(S, H, w, hd)).astype(np.float32))
    kp, vp = (torch.from_numpy(rng.normal(size=(NB, BL, H, hd))
                               .astype(np.float32)) for _ in range(2))
    want = paged_torch(q, kp, vp, rows, pos)
    wide = k2.kernel_head_dim(hd)
    kpp, vpp = k2.pad_head_dim(kp, wide), k2.pad_head_dim(vp, wide)
    got = paged_torch(q, kpp, vpp, rows, pos)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=PAD_ATOL)


# ------------------------------------------- the wrappers' route, on the CPU

def _view(ptr, shape, strides, ctype=ctypes.c_float, dtype=np.float32):
    """A numpy view of f32 memory at ``ptr`` with element strides."""
    if ptr is None:
        return None
    n = 1 + sum((s - 1) * st for s, st in zip(shape, strides))
    buf = np.ctypeslib.as_array((ctype * n).from_address(ptr))
    item = np.dtype(dtype).itemsize
    return np.lib.stride_tricks.as_strided(
        buf.view(dtype), shape, [st * item for st in strides])


class _FakeLibrary:
    """Stands in for the compiled K2 libraries on CPU f32 tensors: each
    launch rebuilds its tensors from the pointers and strides it is handed
    and computes with the plain versions at the scale it is handed."""

    def __init__(self):
        self.dims, self.scales, self.wide = set(), set(), set()

    def _mask(self, ptr, B, T, sb):
        if ptr is None:
            return None
        m = _view(ptr, (B, T), (sb, 1), ctypes.c_uint8, np.uint8)
        return torch.from_numpy(m.astype(bool))

    def mmlspark_flash_launch(self, q, k, v, mask, o, lse, dtype, B, H, T, D,
                              *rest):
        strides = [rest[i:i + 3] for i in range(0, 12, 3)]
        mask_sb, scale, causal, q_off, k_off = rest[12:17]
        assert dtype == 1
        self.dims.add(D)
        self.scales.add(scale)
        shape = (B, H, T, D)
        ts = [torch.from_numpy(np.array(_view(p, shape, (*st, 1))))
              for p, st in zip((q, k, v), strides)]
        out, l = k2.flash_lse_torch(*ts, self._mask(mask, B, T, mask_sb),
                                    causal=bool(causal), q_offset=q_off,
                                    k_offset=k_off, scale=scale)
        _view(o, shape, (*strides[3], 1))[...] = out.numpy()
        if lse is not None:
            _view(lse, (B * H * T,), (1,))[...] = l.reshape(-1).numpy()
        return 0

    def mmlspark_flash_bwd_launch(self, dkv, q, k, v, dout, mask, lse, dsum,
                                  dq, dk, dv, dtype, B, H, T, D, strides,
                                  mask_sb, scale, causal, q_off, k_off, *_):
        assert dtype == 1
        self.dims.add(D)
        self.scales.add(scale)
        shape = (B, H, T, D)
        st = [tuple(strides[i:i + 3]) for i in range(0, 21, 3)]
        ins = [torch.from_numpy(np.array(_view(p, shape, (*s, 1))))
               for p, s in zip((q, k, v, dout), st)]
        rows = [torch.from_numpy(np.array(_view(p, (B, H, T), (H * T, T, 1))))
                for p in (lse, dsum)]
        pos = dict(causal=bool(causal), q_offset=q_off, k_offset=k_off,
                   scale=scale)
        m = self._mask(mask, B, T, mask_sb)
        if dkv:
            gk, gv = k2.flash_dkv_torch(*ins[:3], m, ins[3], *rows, **pos)
            _view(dk, shape, (*st[5], 1))[...] = gk.numpy()
            _view(dv, shape, (*st[6], 1))[...] = gv.numpy()
        else:
            gq = k2.flash_dq_torch(*ins[:3], m, ins[3], *rows, **pos)
            _view(dq, shape, (*st[4], 1))[...] = gq.numpy()
        return 0

    # the wide kernels: the same launches split over D as wide_plan says
    # (the CTAs they are handed checked against the plan, and that they
    # cover D's units two a CTA, as the launchers check), the scores (and
    # dP) over the whole D and each output unit from its own columns
    def _units(self, D, ctas, kernel):
        plan = k2.wide_plan(D, torch.float32, kernel)
        assert ctas == plan.ctas
        assert plan.unit * plan.units == D
        if ctas:
            assert 2 * (ctas - 1) < plan.units <= 2 * ctas
        self.wide.add(D)
        self.dims.add(D)
        return [slice(c, c + plan.unit) for c in range(0, D, plan.unit)]

    def mmlspark_wide_flash_launch(self, q, k, v, mask, o, lse, dtype, B, H,
                                   T, D, *rest):
        strides = [rest[i:i + 3] for i in range(0, 12, 3)]
        mask_sb, scale, causal, q_off, k_off, ctas = rest[12:18]
        assert dtype == 1
        units = self._units(D, ctas, "fwd")
        self.scales.add(scale)
        shape = (B, H, T, D)
        q_, k_, v_ = (torch.from_numpy(np.array(_view(p, shape, (*st, 1))))
                      for p, st in zip((q, k, v), strides))
        m = self._mask(mask, B, T, mask_sb)
        out = _view(o, shape, (*strides[3], 1))
        for i, cols in enumerate(units):
            # the unit's output: full-D scores, its own V columns
            n = cols.stop - cols.start
            oc, l = k2.flash_lse_torch(q_, k_, v_[..., cols].contiguous()
                                       .repeat(1, 1, 1, D // n), m,
                                       causal=bool(causal), q_offset=q_off,
                                       k_offset=k_off, scale=scale)
            out[..., cols] = oc[..., :n].numpy()
            if lse is not None and i == 0:
                _view(lse, (B * H * T,), (1,))[...] = l.reshape(-1).numpy()
        return 0

    def mmlspark_wide_bwd_launch(self, dkv, q, k, v, dout, mask, lse, dsum,
                                 dq, dk, dv, dtype, B, H, T, D, strides,
                                 mask_sb, scale, causal, q_off, k_off,
                                 ctas, *_):
        assert dtype == 1
        units = self._units(D, ctas, "dkv" if dkv else "dq")
        self.scales.add(scale)
        shape = (B, H, T, D)
        st = [tuple(strides[i:i + 3]) for i in range(0, 21, 3)]
        ins = [torch.from_numpy(np.array(_view(p, shape, (*s, 1))))
               for p, s in zip((q, k, v, dout), st)]
        rows = [torch.from_numpy(np.array(_view(p, (B, H, T), (H * T, T, 1))))
                for p in (lse, dsum)]
        pos = dict(causal=bool(causal), q_offset=q_off, k_offset=k_off,
                   scale=scale)
        m = self._mask(mask, B, T, mask_sb)
        # p and ds over the whole D, then each output unit from its own
        # columns
        p, ds = k2._plain_grads_of_scores(*ins[:3], m, ins[3], *rows, **pos)
        for cols in units:
            if dkv:
                gk = torch.einsum("bhqk,bhqd->bhkd", ds, ins[0][..., cols])
                gv = torch.einsum("bhqk,bhqd->bhkd", p, ins[3][..., cols])
                _view(dk, shape, (*st[5], 1))[..., cols] = gk.numpy()
                _view(dv, shape, (*st[6], 1))[..., cols] = gv.numpy()
            else:
                gq = torch.einsum("bhqk,bhkd->bhqd", ds, ins[1][..., cols])
                _view(dq, shape, (*st[4], 1))[..., cols] = gq.numpy()
        return 0


@pytest.fixture
def kernel_route(monkeypatch):
    """The CUDA wrappers on CPU f32 tensors: the switch routes to them, the
    device check passes, and the libraries are the stand-in."""
    fake = _FakeLibrary()
    real_check = k2._check_kernel_inputs

    def check(fn, q, k, v):
        real_check(fn, *_on_card(q, k, v))

    monkeypatch.setattr(k2, "_check_kernel_inputs", check)
    monkeypatch.setattr(k2, "_route", lambda q, impl: True)
    monkeypatch.setattr(k2, "_library", lambda: fake)
    monkeypatch.setattr(k2, "_library_bwd", lambda: fake)
    monkeypatch.setattr(k2, "_library_wide", lambda: fake)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(
                            cuda_stream=0))
    return fake


@pytest.mark.parametrize("pos", CASES)
@pytest.mark.parametrize("hd", HDS)
def test_wrappers_pad_and_scale_by_the_true_head_dim(kernel_route, hd, pos):
    q, k, v, dout, mask = qkv(hd, seed=1)
    with torch.no_grad():
        o = k2.flash_attention(q, k, v, mask, **pos)
    np.testing.assert_allclose(o, k2.flash_torch(q, k, v, mask, **pos),
                               rtol=0, atol=ROUTE_ATOL)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    ref = [t.clone().requires_grad_() for t in (q, k, v)]
    o, lse = k2.flash_attention_lse(*leaves, mask, **pos)
    ro, rlse = k2.flash_attention_lse(*ref, mask, impl="torch", **pos)
    assert o.shape == ro.shape and lse.shape == rlse.shape
    np.testing.assert_allclose(o.detach(), ro.detach(), rtol=0,
                               atol=ROUTE_ATOL)
    np.testing.assert_allclose(lse.detach(), rlse.detach(), rtol=0,
                               atol=ROUTE_ATOL)
    dlse = torch.linspace(-1, 1, lse.numel()).reshape(lse.shape)
    got = torch.autograd.grad((o * dout).sum() + (lse * dlse).sum(), leaves)
    want = torch.autograd.grad((ro * dout).sum() + (rlse * dlse).sum(), ref)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=0, atol=ROUTE_ATOL)
    assert kernel_route.dims == {k2.kernel_head_dim(hd)}
    assert kernel_route.scales == {hd ** -0.5}
    assert kernel_route.wide == ({k2.kernel_head_dim(hd)} if hd > 128
                                 else set())


# ------------------------------------------- the slices at every hd vs JAX

WIDTHS = {16: 32, 96: 192, 192: 384, 256: 512, 320: 640, 512: 1024}  # 2 heads
T = 32


def jencoder(width, attention_fn, vocab=64):
    return JTextEncoder(vocab=vocab, width=width, depth=2, heads=2,
                        mlp_dim=2 * width, dtype=jnp.float32,
                        attention_fn=attention_fn)


def ids(n=3, seed=2, vocab=63):
    rng = np.random.default_rng(seed)
    out = rng.integers(1, vocab, size=(n, T)).astype(np.int32)
    out[0, 20:] = 0
    out[2, 9:] = 0
    return out


@pytest.mark.parametrize("hd", HDS)
def test_featurizer_matches_jax(kernel_route, hd):
    width = WIDTHS[hd]
    rows = ids()
    jm = jencoder(width, jmake_attention("dense"))
    variables = jm.init(jax.random.PRNGKey(0), jnp.asarray(rows))
    jloaded = JLoadedModel(JModelSchema(name="tiny", model_type="text"),
                           jm, variables)
    want = np.asarray(JTextEncoderFeaturizer(
        attentionImpl="pallas", model=jloaded, seqChunk=T,
        inputCol="tokens").transform(JDataFrame({"tokens": rows}))
        ["features"])
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    schema = register_text_encoder(f"HeadDim{hd}", vocab=64, width=width,
                                   depth=2, heads=2, mlp_dim=2 * width)
    port = text_encoder_from_flax(params, heads=2, dtype=torch.float32)
    got = TextEncoderFeaturizer(
        attentionImpl="pallas", seqChunk=T, device="cpu", inputCol="tokens",
        model=LoadedModel(schema, port)).transform(
        DataFrame({"tokens": rows}))["features"]
    assert got.shape == (3, width)
    np.testing.assert_allclose(got, want, rtol=0, atol=F32_ATOL)
    assert kernel_route.dims == {k2.kernel_head_dim(hd)}


@pytest.mark.parametrize("hd", HDS)
def test_masked_lm_step_matches_jax(kernel_route, hd):
    width, lr = WIDTHS[hd], 0.5
    rows = ids(n=6, seed=4)
    enc = jencoder(width, jmake_attention("dense"))
    variables = jax.jit(JMaskedLMModel(enc).init, static_argnums=2)(
        jax.random.PRNGKey(0), jnp.asarray(rows[:1]), True)
    init = jax.tree_util.tree_map(np.asarray, variables["params"])
    jstate, jlosses = jpretrain(enc, rows, steps=1, batch_size=3, seed=0,
                                tx=optax.sgd(lr))
    model = masked_lm_from_flax(init, heads=2, dtype=torch.float32,
                                attention_fn=make_attention_fn("pallas"))
    state, losses = pretrain_masked_lm(
        model, rows, steps=1, batch_size=3, seed=0, device="cpu",
        optimizer=lambda p: torch.optim.SGD(p, lr=lr))
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4)
    want = dict(jax.tree_util.tree_flatten_with_path(jstate.params)[0])
    flat = {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(x)
            for path, x in want.items()}
    moved = 0.0
    for name, p in state.model.named_parameters():
        ref = _flax_leaf(flat, name)
        np.testing.assert_allclose(p.detach().numpy(), ref, rtol=0,
                                   atol=1e-5 * np.abs(ref).max(),
                                   err_msg=name)
        moved = max(moved, float(np.abs(ref - _flax_leaf(
            {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(x)
             for path, x in jax.tree_util.tree_flatten_with_path(init)[0]},
            name)).max()))
    assert moved > 1e-4
    assert kernel_route.dims == {k2.kernel_head_dim(hd)}


@pytest.mark.parametrize("hd", HDS)
def test_causal_lm_step_matches_jax(kernel_route, hd):
    width, lr = WIDTHS[hd], 0.5
    rng = np.random.default_rng(5)
    rows = rng.integers(1, 63, size=(6, T + 1)).astype(np.int32)
    rows[2, 20:] = 0
    rows[4, 11:] = 0
    enc = jencoder(width, jmake_attention("dense", causal=True))
    variables = jax.jit(JMaskedLMModel(enc).init, static_argnums=2)(
        jax.random.PRNGKey(0), jnp.asarray(rows[:1, :T]), True)
    init = jax.tree_util.tree_map(np.asarray, variables["params"])
    jstate, jlosses = jpretrain_causal(enc, rows, steps=1, batch_size=3,
                                       seed=0, tx=optax.sgd(lr))
    model = masked_lm_from_flax(
        init, heads=2, dtype=torch.float32,
        attention_fn=make_attention_fn("pallas", causal=True))
    state, losses = pretrain_causal_lm(
        model, rows, steps=1, batch_size=3, seed=0, device="cpu",
        optimizer=lambda p: torch.optim.SGD(p, lr=lr))
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4)
    flat = {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(x)
            for path, x in
            jax.tree_util.tree_flatten_with_path(jstate.params)[0]}
    for name, p in state.model.named_parameters():
        ref = _flax_leaf(flat, name)
        np.testing.assert_allclose(p.detach().numpy(), ref, rtol=0,
                                   atol=1e-5 * np.abs(ref).max(),
                                   err_msg=name)
    assert kernel_route.dims == {k2.kernel_head_dim(hd)}


def _flax_leaf(flat, name):
    """The flax leaf behind a port parameter name, in the port's layout."""
    *path, leaf = name.split(".")
    prefix = "/".join(path)
    if leaf == "weight":
        for key in ("kernel", "scale", "embedding"):
            if f"{prefix}/{key}" in flat:
                x = flat[f"{prefix}/{key}"]
                return x.T if key == "kernel" else x
        raise KeyError(name)
    return flat[f"{prefix}/{leaf}"]


@pytest.mark.parametrize("hd", HDS)
def test_engine_on_padded_pools_matches_jax(hd):
    width = WIDTHS[hd]
    jm = JMaskedLMModel(jencoder(width, jmake_attention("dense", causal=True),
                                 vocab=32))
    variables = jax.jit(jm.init)(jax.random.PRNGKey(0),
                                 np.zeros((1, 8), np.int32))
    model = masked_lm_from_flax(
        jax.tree_util.tree_map(np.asarray, variables), heads=2,
        dtype=torch.float32,
        attention_fn=make_attention_fn("pallas", causal=True))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(2, 32, size=n).astype(np.int32)
               for n in (3, 5, 2)]
    eng = LLMEngine(model, slots=2, block_len=4, max_seq_len=16,
                    registry=MetricsRegistry(), device="cpu")
    jeng = JLLMEngine(jm, variables, slots=2, block_len=4, max_seq_len=16,
                      registry=JRegistry())
    for e in (eng, jeng):
        for i, p in enumerate(prompts):
            e.submit(i, p, 4)
    got, want = eng.run_until_drained(), jeng.run_until_drained()
    assert {t.shape[-1] for layer in eng.pools for t in layer} == \
        {k2.kernel_head_dim(hd)}
    assert set(got) == set(want)
    for i in want:
        np.testing.assert_array_equal(got[i], want[i])


def _hd16_lm(seed=0):
    gen = torch.Generator().manual_seed(seed)
    return MaskedLMModel(TextEncoder(
        vocab=64, width=32, depth=2, heads=2, mlp_dim=64,
        attention_fn=make_attention_fn("pallas", causal=True),
        dtype=torch.float32, generator=gen), gen)


def _pool_bytes(eng):
    pools = eng.pools + (eng.draft_pools or [])
    return sum(t.numel() * t.element_size() for layer in pools
               for t in layer)


@pytest.mark.parametrize("draft", [False, True])
def test_engine_block_bytes_count_padded_pools(draft):
    model = _hd16_lm()
    eng = LLMEngine(model, draft_module=model if draft else None,
                    spec_k=2 if draft else 0, slots=2, block_len=4,
                    max_seq_len=16, registry=MetricsRegistry(),
                    device="cpu")
    per_block = (1 + draft) * paged_kv.pool_block_bytes(model.encoder, 4)
    assert paged_kv.pool_head_dim(model.encoder) == 32
    assert per_block == (1 + draft) * 2 * 2 * 4 * 2 * 32 * 4
    assert _pool_bytes(eng) == eng.kv.num_blocks * per_block


@pytest.mark.cuda
def test_engine_sized_by_free_memory_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (num_blocks=None reads the free "
                    "device memory; the CPU takes a fixed default)")
    dev = torch.device("cuda")
    model = _hd16_lm().to(dev)
    torch.cuda.empty_cache()
    free = torch.cuda.mem_get_info(dev)[0]
    eng = LLMEngine(model, draft_module=model, spec_k=2, slots=2,
                    block_len=16, max_seq_len=64, hbm_fraction=0.25,
                    registry=MetricsRegistry(), device=dev)
    held = _pool_bytes(eng)
    assert held == eng.kv.num_blocks * 2 * paged_kv.pool_block_bytes(
        model.encoder, 16)
    assert 0.2 * free < held <= 0.25 * free
    eng.submit(0, np.arange(2, 12, dtype=np.int32), 4)
    assert len(eng.run_until_drained()[0]) == 14
