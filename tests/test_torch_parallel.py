"""The port's sequence parallelism and collectives against the JAX package:
``tests/test_parallel.py``'s classes (meshes, collectives, padding, ring
and Ulysses attention, 2-D data x sequence parallelism, the encoder step
through the ring), and ``tests/test_sharding_analysis.py``'s ring case as
collective counts.

The port's side runs in one spawn of 4 gloo ranks on the CPU
(``tests/torch_parallel_ranks.py``: collectives over dp = 4, the ring and
Ulysses over sp = 4, 2-D over dp = 2 x sp = 2); the JAX side on 4 of
conftest's 8 virtual CPU devices, the flash kernels in interpret mode, at
the reference tests' tiny shapes. Forward outputs are held within 1e-5,
gradients and parameters after a step within 1e-4 relative (atol 1e-6),
as ``test_parallel.py:474-481`` holds JAX against itself.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from mmlspark_tpu.dl.text_encoder import TextEncoder as JTextEncoder
from mmlspark_tpu.dl.text_encoder import make_attention_fn as jmake_attention
from mmlspark_tpu.dl.train import init_train_state as jinit_train_state
from mmlspark_tpu.dl.train import make_train_step as jmake_train_step
from mmlspark_tpu.parallel import (MeshSpec as JMeshSpec,
                                   allgather as jallgather,
                                   allreduce as jallreduce,
                                   barrier as jbarrier, pad_rows as jpad_rows,
                                   psum_scatter as jpsum_scatter,
                                   ring_permute as jring_permute)
from mmlspark_tpu.parallel.collectives import all_to_all as jall_to_all
from mmlspark_tpu.parallel.collectives import axis_index as jaxis_index
from mmlspark_tpu.parallel.collectives import ppermute as jppermute
from mmlspark_tpu.parallel.compat import shard_map
from mmlspark_tpu.parallel.ring_attention import \
    blockwise_attention as jblockwise
from mmlspark_tpu.parallel.ring_attention import \
    make_ring_attention as jmake_ring
from mmlspark_tpu.parallel.ulysses import \
    make_ulysses_attention as jmake_ulysses
from mmlspark_torch.models.convert import text_encoder_from_flax
from mmlspark_torch.parallel import (MeshSpec, blockwise_attention,
                                     mesh_shape_for, pad_rows, unpad_rows)

from torch_parallel_ranks import spawn

RTOL, ATOL = 1e-4, 1e-6
ENC = dict(vocab=128, width=16, depth=1, heads=2, mlp_dim=32)


def qkv(seed, shape, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=shape).astype(dtype) for _ in range(3))


def weights(shape):
    return np.sin(np.arange(int(np.prod(shape)))).reshape(shape) \
        .astype(np.float32)


@pytest.fixture(scope="module")
def mesh4():
    return Mesh(np.asarray(jax.devices()[:4]), ("sp",))


@pytest.fixture(scope="module")
def payload():
    """The inputs both packages see (the reference tests' shapes)."""
    q, k, v = qkv(11, (1, 2, 64, 16))
    ring = dict(q=q, k=k, v=v, w=weights(q.shape),
                mask=np.random.default_rng(12).random((1, 64)) > 0.2)
    q, k, v = qkv(15, (1, 8, 64, 16))
    uly = dict(q=q, k=k, v=v, w=weights(q.shape),
               mask=np.random.default_rng(16).random((1, 64)) > 0.2)
    two = {}
    for kind, H, seed in (("ring", 2, 0), ("ulysses", 4, 1)):
        rng = np.random.default_rng(seed)
        q, k, v = (rng.normal(size=(4, H, 64, 8)).astype(np.float32)
                   for _ in range(3))
        two[kind] = dict(q=q, k=k, v=v, mask=rng.random((4, 64)) > 0.2)
    jenc = JTextEncoder(**ENC, dtype=jnp.float32)
    ids = np.random.default_rng(40).integers(1, 128, size=(2, 64)) \
        .astype(np.int32)
    params = jax.tree_util.tree_map(np.asarray, jax.jit(
        jenc.init, static_argnums=2)(jax.random.PRNGKey(2),
                                     jnp.asarray(ids), True)["params"])
    encoder = dict(ids=ids, y=np.asarray([0.0, 1.0], np.float32),
                   params=params,
                   model=text_encoder_from_flax(params, heads=ENC["heads"],
                                                dtype=torch.float32))
    rows13 = np.random.default_rng(0).normal(size=(13, 3)).astype(np.float32)
    return {"ring": ring, "ulysses": uly, "2d_ring": two["ring"],
            "2d_ulysses": two["ulysses"], "encoder": encoder,
            "rows13": rows13}


@pytest.fixture(scope="module")
def ranks(payload):
    """The port's side: one spawn of 4 ranks for the whole module."""
    p = dict(payload, encoder={k: v for k, v in payload["encoder"].items()
                               if k != "params"})
    return spawn("attention", 4, p)


def close(got, want, rtol=RTOL, atol=ATOL, err_msg=""):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=rtol,
                               atol=atol, err_msg=err_msg)


def jring(mesh, p, impl, causal, dtype=jnp.float32):
    """The JAX ring's output and (in f32) the q/k/v gradients of
    sum(o * w)."""
    fn = jmake_ring(mesh, causal=causal, local_impl=impl)
    q, k, v = (jnp.asarray(p[n], dtype) for n in "qkv")
    mask, w = jnp.asarray(p["mask"]), jnp.asarray(p["w"])
    out = fn(q, k, v, key_mask=mask)
    if dtype != jnp.float32:
        return np.asarray(out, np.float32), None
    grads = jax.jit(jax.grad(
        lambda q, k, v: (fn(q, k, v, mask).astype(jnp.float32) * w).sum(),
        argnums=(0, 1, 2)))(q, k, v)
    return np.asarray(out, np.float32), [np.asarray(g, np.float32)
                                         for g in grads]


class TestMesh:
    def test_spec_resolution_matches_jax(self):
        for kw in ({"dp": -1, "tp": 2}, {"dp": 2, "sp": 2, "tp": 2},
                   {"dp": 4, "tp": 2}):
            assert MeshSpec(**kw).resolve(8) == JMeshSpec(**kw).resolve(8)
        for bad in ({"dp": 3, "tp": 2}, {"dp": -1, "tp": -1}):
            with pytest.raises(ValueError):
                MeshSpec(**bad).resolve(8)
            with pytest.raises(ValueError):
                JMeshSpec(**bad).resolve(8)
        assert mesh_shape_for(4, tp=2) == MeshSpec(tp=2)

    def test_meshes_over_ranks(self, ranks):
        assert ranks["local_mesh"] == {"dp": 4}
        assert ranks["mesh_2x2"] == {"pp": 1, "dp": 2, "ep": 1, "sp": 1,
                                     "tp": 2}
        assert ranks["mesh_auto"] == dict(ranks["mesh_2x2"])


class TestCollectives:
    """Each collective over dp = 4 against ``shard_map`` over 4 devices;
    the differentiable ones' gradients of sum over ranks of
    sum(y * (rank + 1)) against ``jax.grad`` of the same."""

    @pytest.fixture(scope="class")
    def jax_side(self):
        mesh = Mesh(np.asarray(jax.devices()[:4]), ("dp",))
        x = np.arange(4, dtype=np.float32)
        rep = np.tile(x, 4)                     # each shard its own copy

        def idx():
            return jaxis_index("dp") + 1.0

        # every forward in one shard_map, every gradient in one jax.grad
        fwd_fns = {
            "sum": (lambda s: jallreduce(s, "dp"), 0),
            "max": (lambda s: jallreduce(s, "dp", op="max"), 0),
            "mean": (lambda s: jallreduce(s, "dp", op="mean"), 0),
            "allgather": (lambda s: jallgather(s, "dp"), 0),
            "psum_scatter": (lambda s: jpsum_scatter(s, "dp"), 1),
            "ring_permute": (lambda s: jring_permute(s, "dp", 1), 0),
            "ppermute": (lambda s: jppermute(
                s, "dp", [(0, 2), (2, 0), (1, 3)]), 0),
            "all_to_all": (lambda s: jall_to_all(
                s * idx(), "dp", split_axis=0, concat_axis=0, tiled=True),
                1),
            "axis_index": (lambda s: s * 0 + jaxis_index("dp"), 0),
            "barrier": (lambda s: s + 0 * jbarrier("dp"), 0)}
        names = list(fwd_fns)
        fwd = shard_map(
            lambda a, b: tuple(fwd_fns[n][0]((a, b)[fwd_fns[n][1]])
                               for n in names),
            mesh=mesh, in_specs=(P("dp"), P("dp")),
            out_specs=tuple(P("dp") for _ in names), check_vma=False)(
            x, rep)
        fwd = {n: np.asarray(o) for n, o in zip(names, fwd)}
        bodies = {
            "allgather": (lambda s: jallgather(s, "dp"), x),
            "psum_scatter": (lambda s: jpsum_scatter(s, "dp"), rep),
            "ring_permute": (lambda s: jring_permute(s, "dp", 1), x),
            "all_to_all": (lambda s: jall_to_all(
                s, "dp", split_axis=0, concat_axis=0, tiled=True), rep),
            "psum": (lambda s: jallreduce(s, "dp"), x)}
        gnames = list(bodies)
        both = shard_map(
            lambda *a: tuple(bodies[n][0](s) * idx()
                             for n, s in zip(gnames, a)),
            mesh=mesh, in_specs=tuple(P("dp") for _ in gnames),
            out_specs=tuple(P("dp") for _ in gnames), check_vma=False)
        grads = jax.jit(jax.grad(
            lambda *a: sum(o.sum() for o in both(*a)),
            argnums=tuple(range(len(gnames)))))(
            *(jnp.asarray(bodies[n][1]) for n in gnames))
        return fwd, {n: np.asarray(g) for n, g in zip(gnames, grads)}

    def test_forward_matches_jax(self, ranks, jax_side):
        fwd, _ = jax_side
        got = ranks["collectives"]
        for name in ("sum", "max", "mean", "allgather", "psum_scatter",
                     "ring_permute", "ppermute", "all_to_all", "axis_index"):
            close(got[name], fwd[name], err_msg=name)
        np.testing.assert_allclose(got["sum"], np.full(4, 6.0))
        np.testing.assert_allclose(got["ring_permute"], np.roll(
            np.arange(4.0), 1))

    def test_backward_is_the_transpose(self, ranks, jax_side):
        _, grads = jax_side
        for name, want in grads.items():
            close(ranks["collective_grads"][name], want, err_msg=name)


class TestShardingHelpers:
    def test_pad_rows_matches_jax(self):
        a = np.arange(10, dtype=np.float32).reshape(5, 2)
        padded, mask = pad_rows(a, 8)
        jp, jm = jpad_rows(a, 8)
        np.testing.assert_array_equal(padded, jp)
        np.testing.assert_array_equal(mask, jm)
        np.testing.assert_array_equal(unpad_rows(padded, 5), a)
        (pa, pn, pb), _ = pad_rows([np.ones((5, 2)), None, np.arange(5)], 4)
        assert pa.shape == (8, 2) and pn is None and pb.shape == (8,)

    def test_pad_rows_preserves_int_and_bool_dtypes(self):
        cols = [np.ones((5, 2), np.float32), np.arange(5, dtype=np.int32),
                np.array([True, False, True, False, True]),
                np.arange(5, dtype=np.int64)]
        got, mask = pad_rows(cols, 8, pad_value=1.0)
        want, _ = jpad_rows(cols, 8, pad_value=1.0)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
        assert mask.dtype == np.float32

    def test_shard_batch_masks_its_padding(self, ranks, payload):
        shape, n, total = ranks["shard_batch"]
        assert shape == (4, 3) and n == 13          # 16 rows over 4 ranks
        np.testing.assert_allclose(total, payload["rows13"].sum(),
                                   rtol=1e-5)


class TestRingAttention:
    def test_blockwise_matches_jax(self):
        for seed, shape, kw in ((1, (2, 2, 37, 8), dict(block_size=16)),
                                (2, (1, 2, 33, 8), dict(block_size=8,
                                                        causal=True))):
            q, k, v = qkv(seed, shape)
            got = blockwise_attention(*map(torch.from_numpy, (q, k, v)),
                                      **kw)
            close(got.numpy(), jblockwise(q, k, v, **kw), atol=1e-5)

    def test_fully_masked_rows_backward_finite(self):
        """Every key masked: the backward stays finite (exact l == 0
        guard) and equals the JAX package's."""
        q, k, v = qkv(23, (1, 2, 16, 8))
        for kw in ({"key_mask": np.zeros((1, 16), bool)},
                   {"causal": True, "q_offset": 0, "k_offset": 32},
                   {"key_mask": np.zeros((1, 16), bool),
                    "return_lse": True}):
            def jloss(q, k, v, kw=kw):
                out = jblockwise(q, k, v, block_size=8, **kw)
                return (out[0].sum() + out[1].sum()) if isinstance(
                    out, tuple) else out.sum()
            want = jax.jit(jax.grad(jloss, argnums=(0, 1, 2)))(q, k, v)
            ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
            tkw = {n: torch.from_numpy(a) if isinstance(a, np.ndarray)
                   else a for n, a in kw.items()}
            out = blockwise_attention(*ts, block_size=8, **tkw)
            ((out[0].sum() + out[1].sum()) if isinstance(out, tuple)
             else out.sum()).backward()
            for g, w in zip(ts, want):
                assert torch.isfinite(g.grad).all(), kw
                close(g.grad.numpy(), w, err_msg=str(kw))

    @pytest.mark.parametrize("causal", [False, True])
    @pytest.mark.parametrize("impl", ["blockwise", "flash"])
    def test_ring_matches_jax(self, ranks, payload, mesh4, impl, causal):
        want, wgrads = jring(mesh4, payload["ring"], impl, causal)
        got = ranks["ring", impl, causal]
        close(got["o"], want, atol=1e-5)
        for g, w, n in zip(got["grads"], wgrads, "qkv"):
            close(g, w, err_msg=f"d{n}")

    def test_ring_flash_bf16_carry(self, ranks, payload, mesh4):
        """The flash ring carries o in f32 and returns q's dtype."""
        got, ref = ranks["ring_bf16"], ranks["ring_bf16_blockwise"]
        assert got["dtype"] == "torch.bfloat16"
        want, _ = jring(mesh4, payload["ring"], "flash", False,
                        jnp.bfloat16)
        np.testing.assert_allclose(got["o"], ref["o"], atol=5e-2)
        np.testing.assert_allclose(got["o"], want, atol=5e-2)

    def test_rotation_moves_kv_and_the_key_mask(self, ranks, payload):
        """test_sharding_analysis's collective-permute, as counts: n - 1
        rotations of the stacked K/V and of the key mask, and nothing
        else."""
        moved = ranks["ring", "flash", False]["moved"]
        q = payload["ring"]["q"]
        kv = 2 * q[:, :, :16].size * 4              # f32 K and V blocks
        mask = q.shape[0] * 16                       # uint8 mask block
        calls = {k: v for k, v in moved.items()
                 if k.startswith("collective_calls_total")}
        nbytes = {k: v for k, v in moved.items()
                  if k.startswith("collective_bytes_total")}
        assert sum(calls.values()) == 2 * 3 + 1        # + the axis index
        assert sum(v for k, v in calls.items() if "ppermute" in k) == 6
        assert sum(v for k, v in nbytes.items() if "ppermute" in k) == \
            3 * (kv + mask)


class TestUlyssesAttention:
    @pytest.fixture(scope="class")
    def jax_side(self, payload, mesh4):
        """The JAX Ulysses outputs; the q gradients of its one-device
        equivalent, ``blockwise_attention`` (JAX's shard_map all-to-all
        does not transpose here)."""
        u = payload["ulysses"]
        q, k, v = (jnp.asarray(u[n]) for n in "qkv")
        mask, w = jnp.asarray(u["mask"]), jnp.asarray(u["w"])
        out = {}
        for causal in (False, True):
            dq = np.asarray(jax.jit(jax.grad(lambda q: (jblockwise(
                q, k, v, causal=causal, block_size=16, key_mask=mask) * w)
                .sum()))(q))
            for impl in ("blockwise", "flash"):
                fn = jmake_ulysses(mesh4, causal=causal, block_size=16,
                                   local_impl=impl)
                out[impl, causal] = (np.asarray(fn(q, k, v, key_mask=mask)),
                                     dq)
        return out

    @pytest.mark.parametrize("causal", [False, True])
    @pytest.mark.parametrize("impl", ["blockwise", "flash"])
    def test_matches_jax(self, ranks, jax_side, impl, causal):
        want, dq = jax_side[impl, causal]
        got = ranks["ulysses", impl, causal]
        close(got["o"], want, atol=1e-5)
        close(got["dq"], dq)

    def test_errors_are_loud(self, ranks, mesh4):
        errors = dict(ranks["ulysses_errors"])
        assert "divisible" in errors["heads"]
        assert "scale" in errors["scale"]
        with pytest.raises(NotImplementedError):
            jmake_ulysses(mesh4, scale=0.5, local_impl="flash")


class TestTwoDimensionalAttention:
    """Rows over dp = 2, the sequence over sp = 2: each row block's ring
    (or all-to-all) runs on its own and matches the JAX package's 2 x 2
    mesh."""

    @pytest.mark.parametrize("impl", ["blockwise", "flash"])
    @pytest.mark.parametrize("kind", ["ring", "ulysses"])
    def test_dp_sp_matches_jax(self, ranks, payload, kind, impl):
        d = payload["2d_" + kind]
        mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2),
                    ("dp", "sp"))
        make = jmake_ring if kind == "ring" else jmake_ulysses
        fn = make(mesh, batch_axis="dp", local_impl=impl)
        sh = NamedSharding(mesh, P("dp", None, "sp", None))
        q, k, v = (jax.device_put(jnp.asarray(d[n]), sh) for n in "qkv")
        m = jax.device_put(jnp.asarray(d["mask"]),
                           NamedSharding(mesh, P("dp", "sp")))
        want = np.asarray(fn(q, k, v, m))
        close(ranks["2d", kind, impl], want, atol=1e-5)
        close(want, jblockwise(*(jnp.asarray(d[n]) for n in "qkv"),
                               key_mask=jnp.asarray(d["mask"])), atol=2e-5)


def test_encoder_trains_through_ring_attention(ranks, payload):
    """The reference's slow test at its tiny shapes: one SGD step of the
    encoder whose attention is the ring over sp = 4 against the JAX
    package's dense step on the same weights and batch; gradients flow
    back through the rotations, and the step all-reduces them over sp."""
    e = payload["encoder"]
    jm = JTextEncoder(**ENC, dtype=jnp.float32,
                      attention_fn=jmake_attention("dense"))
    tx = optax.sgd(1e-2)
    state = jinit_train_state(jm, jax.random.PRNGKey(2), e["ids"], tx)
    np.testing.assert_array_equal(
        np.asarray(state.params["embed"]["embedding"]),
        e["params"]["embed"]["embedding"])
    step = jmake_train_step(jm, tx, fetch="pooled", loss_fn=lambda pooled, t:
                            jnp.mean((pooled.mean(-1) - t) ** 2))
    new, loss = step(state, jnp.asarray(e["ids"]), jnp.asarray(e["y"]))
    got = ranks["encoder_ring"]
    np.testing.assert_allclose(got["loss"], float(loss), rtol=1e-5)
    want = text_encoder_from_flax(jax.tree_util.tree_map(
        np.asarray, new.params), heads=ENC["heads"], dtype=torch.float32)
    for n, w in want.named_parameters():
        close(got["params"][n], w.detach().numpy(), err_msg=n)
    assert got["allreduce_calls"] >= 1           # the sp gradient sum
    assert any("ppermute" in k for k in got["moved"])

