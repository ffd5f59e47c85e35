"""The port's vision backbones against the JAX package: ``ResNet`` (both
block types) and ``ViT``, carried from the same flax variables.

Held, at small shapes (ResNet stages ``(1, 1, 1, 1)``, width 8, at 32²; ViT
patch 4, width 32, depth 2, 4 heads, at 16²), on variables made non-zero
everywhere (flax's init zeroes each block's last BatchNorm scale and the
class token, which would hide a fault in the convs behind them):
- every endpoint against flax: f32 within 1e-4 of the largest value, bf16
  within two bf16 ulps of it (``BF16_RTOL``);
- the stage endpoints in NHWC order;
- ``train=True``: outputs and the BatchNorm running statistics against
  flax's mutable ``batch_stats`` (momentum 0.9, biased batch variance);
- ``remat=True`` against the plain forward: outputs, gradients and running
  statistics equal.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmlspark_tpu.models.resnet import BasicBlock as JBasic
from mmlspark_tpu.models.resnet import BottleneckBlock as JBottleneck
from mmlspark_tpu.models.resnet import ResNet as JResNet
from mmlspark_tpu.models.vit import ViT as JViT
from mmlspark_torch.models import (ResNet, ViT, resnet_from_flax,
                                   vit_from_flax)
from mmlspark_torch.models.resnet import BottleneckBlock

F32_RTOL = 1e-4
BF16_RTOL = 2 * 2.0 ** -7       # two bf16 ulps of the largest value
RESNET = dict(stage_sizes=(1, 1, 1, 1), width=8, num_classes=10)
VIT = dict(patch=4, width=32, depth=2, heads=4, mlp_dim=64, num_classes=7)
BLOCKS = {"basic": JBasic, "bottleneck": JBottleneck}
JDTYPES = {"f32": (jnp.float32, torch.float32),
           "bf16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Single-threaded torch (tier-1 runs several workers at once)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def nonzero(variables, seed):
    """Every leaf non-zero: BatchNorm scales and running variances in
    [0.5, 1.5], means, biases and the class token ~0.1, kernels jittered."""
    rng = np.random.default_rng(seed)

    def f(path, a):
        a = np.asarray(a, np.float32)
        leaf = getattr(path[-1], "key", "")
        if leaf in ("scale", "var"):
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        if leaf in ("mean", "bias", "class_token"):
            return (0.1 * rng.normal(size=a.shape)).astype(np.float32)
        return (a + 0.01 * rng.normal(size=a.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(f, jax.device_get(variables))


def images(n, size, seed=0):
    return np.random.default_rng(seed).uniform(
        0, 255, (n, size, size, 3)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _variables(kind: str, seed: int):
    """The f32 init (parameters are f32 whatever the compute dtype),
    jitted, made non-zero."""
    if kind == "vit":
        m, x = JViT(**VIT), images(1, 16)
    else:
        m, x = JResNet(block=BLOCKS[kind], **RESNET), images(1, 32)
    v = jax.jit(m.init, static_argnums=2)(jax.random.PRNGKey(0), x, False)
    return nonzero(v, seed)


def jax_resnet(block, dtype=jnp.float32, seed=1):
    return (JResNet(block=BLOCKS[block], dtype=dtype, **RESNET),
            _variables(block, seed))


def jax_vit(dtype=jnp.float32, seed=2):
    return JViT(dtype=dtype, **VIT), _variables("vit", seed)


def assert_close(got, want, rtol, what):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= rtol * np.abs(want).max(), (what, err, np.abs(want).max())


@pytest.mark.parametrize("dtype", sorted(JDTYPES))
@pytest.mark.parametrize("block", sorted(BLOCKS))
def test_resnet_endpoints_against_flax(block, dtype):
    jdt, tdt = JDTYPES[dtype]
    m, v = jax_resnet(block, jdt)
    x = images(3, 32, seed=3)
    want = jax.jit(lambda v, x: m.apply(v, x, False))(v, x)
    port = resnet_from_flax(v, dtype=tdt)
    assert isinstance(port, ResNet) and port.layer_names == m.layer_names
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert sorted(got) == sorted(want)
    rtol = F32_RTOL if dtype == "f32" else BF16_RTOL
    for name in want:
        assert_close(got[name].float(), want[name], rtol, name)
    expansion = 4 if block == "bottleneck" else 1
    for i in range(4):                         # NHWC: channels last
        stage = got[f"stage{i + 1}"]
        assert stage.shape[-1] == RESNET["width"] * 2 ** i * expansion
        assert stage.is_contiguous()


@pytest.mark.parametrize("dtype", sorted(JDTYPES))
def test_vit_endpoints_against_flax(dtype):
    jdt, tdt = JDTYPES[dtype]
    m, v = jax_vit(jdt)
    x = images(3, 16, seed=4)
    want = jax.jit(lambda v, x: m.apply(v, x, False))(v, x)
    port = vit_from_flax(v, heads=VIT["heads"], dtype=tdt)
    assert isinstance(port, ViT) and port.layer_names == m.layer_names
    assert tuple(port.pos_embedding.shape) == (1, 17, VIT["width"])
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    rtol = F32_RTOL if dtype == "f32" else BF16_RTOL
    for name in want:
        assert_close(got[name].float(), want[name], rtol, name)


@pytest.mark.parametrize("block", sorted(BLOCKS))
def test_resnet_train_batch_stats_against_flax(block):
    """flax's BatchNorm rule under ``train=True``: batch mean and biased
    variance normalise; the running stats move to 0.9 old + 0.1 batch."""
    m, v = jax_resnet(block)
    x = images(4, 32, seed=5)
    want, new = jax.jit(lambda v, x: m.apply(
        v, x, True, mutable=["batch_stats"]))(v, x)
    port = resnet_from_flax(v, dtype=torch.float32)
    got = port(torch.from_numpy(x), train=True)
    for name in want:
        assert_close(got[name].detach(), want[name], F32_RTOL, name)
    state = port.state_dict()
    flat = jax.tree_util.tree_flatten_with_path(new["batch_stats"])[0]
    assert len(flat) == sum(1 for k in state if k.endswith((".mean", ".var")))
    for path, leaf in flat:
        # the fast variance E[x²] - E[x]² cancels on the stem's 0-255
        # scale, so two f32 summation orders move it by ~1e-5 relative
        key = ".".join(p.key for p in path)
        np.testing.assert_allclose(state[key].numpy(), np.asarray(leaf),
                                   rtol=1e-4, atol=1e-6, err_msg=key)
    # eval mode does not move them
    before = {k: t.clone() for k, t in port.state_dict().items()}
    with torch.no_grad():
        port(torch.from_numpy(x))
    for k, t in port.state_dict().items():
        assert torch.equal(t, before[k]), k


def _train_step(module, x):
    out = module(x, train=True) if isinstance(module, ResNet) else module(x)
    loss = out["logits"].square().mean() + out["pooled"].mean()
    loss.backward()
    grads = {n: p.grad.clone() for n, p in module.named_parameters()}
    return out, grads


@pytest.mark.parametrize("kind", ["resnet-basic", "resnet-bottleneck", "vit"])
def test_remat_equals_plain(kind):
    """``remat=True`` (torch.utils.checkpoint per block) computes the same
    outputs and gradients, and moves the running statistics once."""
    if kind == "vit":
        m, v = jax_vit()
        build = lambda remat: vit_from_flax(  # noqa: E731
            v, heads=VIT["heads"], dtype=torch.float32, remat=remat)
        x = torch.from_numpy(images(2, 16, seed=6))
    else:
        m, v = jax_resnet(kind.split("-")[1])
        build = lambda remat: resnet_from_flax(  # noqa: E731
            v, dtype=torch.float32, remat=remat)
        x = torch.from_numpy(images(2, 32, seed=6))
    plain, remat = build(False), build(True)
    out_p, g_p = _train_step(plain, x)
    out_r, g_r = _train_step(remat, x)
    for name in out_p:
        torch.testing.assert_close(out_r[name], out_p[name], rtol=0, atol=0)
    for name in g_p:
        torch.testing.assert_close(g_r[name], g_p[name], rtol=1e-6,
                                   atol=1e-7)
    for (k, a), (_, b) in zip(plain.state_dict().items(),
                              remat.state_dict().items()):
        torch.testing.assert_close(b, a, rtol=0, atol=0, msg=k)


def test_resnet_seeded_init_follows_flax():
    """A fresh module: each block's last BatchNorm scale 0, the others 1,
    running stats 0/1, kernels with std ~ fan_in^-1/2; the same seed gives
    the same weights."""
    a, b = (ResNet(block=BottleneckBlock, generator=torch.Generator()
                   .manual_seed(3), **RESNET) for _ in range(2))
    for (k, x), (_, y) in zip(a.state_dict().items(),
                              b.state_dict().items()):
        assert torch.equal(x, y), k
    blk = a.blocks[0]
    assert torch.all(blk.BatchNorm_2.scale == 0)
    assert torch.all(blk.BatchNorm_0.scale == 1)
    assert torch.all(blk.BatchNorm_0.var == 1) and \
        torch.all(blk.BatchNorm_0.mean == 0)
    w = a.BottleneckBlock_3.Conv_1.weight
    assert 0.5 < float(w.detach().std()) * (w[0].numel() ** 0.5) < 1.5
