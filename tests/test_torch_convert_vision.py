"""The port's vision converters and its model store against the JAX
package.

Held:
- torchvision-layout state dicts (the modules of ``tests/test_convert.py``,
  the torch oracle there) give the same features through the port's
  ``resnet_from_torch``/``vit_from_torch`` as through the JAX
  ``torch_resnet_to_flax``/``torch_vit_to_flax`` path, every endpoint
  within 1e-4 of the largest value (f32), logits within 1e-4 of torch's;
- the flax carry-over (``resnet_from_flax``, ``vit_from_flax``) is
  bit-equal on every parameter and running statistic;
- a mismatched state dict fails loudly (a leftover key ``ValueError``, a
  missing one ``KeyError``), as the JAX converters do;
- ``save_converted`` → ``verify_checkpoint`` → ``ModelDownloader`` by name
  round-trips bit for bit; a manifest or weights that do not match are
  rejected; random init is refused when disallowed; the seeded init is
  deterministic by name; an orbax directory raises naming its format;
- a BERT ingested by ``bert_encoder_from_torch`` is saved and reloaded by
  name into ``TextEncoderFeaturizer(modelName=...)``;
- ``convert_torch_checkpoint`` and the CLI.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mmlspark_tpu.models.convert as jconvert
from mmlspark_tpu.dl.text_encoder import \
    TextEncoderFeaturizer as JTextEncoderFeaturizer
from mmlspark_tpu.models.resnet import BasicBlock as JBasic
from mmlspark_tpu.models.resnet import BottleneckBlock as JBottleneck
from mmlspark_tpu.models.resnet import ResNet as JResNet
from mmlspark_tpu.models.vit import ViT as JViT
from mmlspark_tpu.models.zoo import LoadedModel as JLoadedModel
from mmlspark_tpu.models.zoo import ModelSchema as JModelSchema
from mmlspark_torch.core import DataFrame
from mmlspark_torch.dl import TextEncoderFeaturizer
from mmlspark_torch.models import (LoadedModel, ModelDownloader,
                                   bert_encoder_from_torch, get_model,
                                   module_from_torch, register_bert_encoder,
                                   resnet_from_flax, resnet_from_torch,
                                   save_converted, verify_checkpoint,
                                   vit_from_flax, vit_from_torch)
from mmlspark_torch.models import convert
from test_bert_convert import HEADS, make_bert_state_dict
from test_convert import (TorchBasic, TorchBottleneck, TorchResNet,
                          TorchViT, _randomize_bn_stats)

ATOL = 1e-4
ARCHS = {"ResNet18": (TorchBasic, JBasic, (2, 2, 2, 2)),
         "ResNet50": (TorchBottleneck, JBottleneck, (3, 4, 6, 3))}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Single-threaded torch (tier-1 runs several workers at once)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def no_model_dir(monkeypatch):
    monkeypatch.delenv("MMLSPARK_TPU_MODEL_DIR", raising=False)
    monkeypatch.delenv("MMLSPARK_TPU_ALLOW_RANDOM_INIT", raising=False)


def torchvision_resnet(name, width=8, classes=8, seed=0):
    block, _, layers = ARCHS[name]
    torch.manual_seed(seed)
    t = TorchResNet(block, layers, width=width, num_classes=classes).eval()
    _randomize_bn_stats(t, seed)
    return t


def close(got, want, what):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    assert np.abs(got - want).max() <= ATOL * max(np.abs(want).max(), 1.0), \
        (what, np.abs(got - want).max())


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_torchvision_resnet_same_features_as_jax_path(name):
    t = torchvision_resnet(name)
    sd = t.state_dict()
    x = np.random.default_rng(1).normal(size=(2, 48, 48, 3)).astype(
        np.float32)
    with torch.no_grad():
        oracle = t(torch.from_numpy(x.transpose(0, 3, 1, 2))).numpy()
    _, jblock, layers = ARCHS[name]
    jm = JResNet(stage_sizes=layers, width=8, num_classes=8,
                 dtype=jnp.float32, block=jblock)
    want = jax.jit(lambda v, x: jm.apply(v, x, False))(
        jconvert.torch_resnet_to_flax(sd, name), x)
    port = resnet_from_torch(sd, name, dtype=torch.float32)
    assert port.stage_sizes == layers and port.width == 8
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    for k in want:
        close(got[k], want[k], k)
    close(got["logits"], oracle, "torch oracle")
    assert type(module_from_torch(sd, name)) is type(port)


def test_torchvision_vit_same_features_as_jax_path(monkeypatch):
    torch.manual_seed(0)
    t = TorchViT().eval()                  # w 32, depth 2, 4 heads, patch 8
    sd = t.state_dict()
    monkeypatch.setitem(jconvert._VIT_ARCHS, "_tiny", (32, 2))
    variables = jconvert.torch_vit_to_flax(sd, "_tiny")
    jm = JViT(patch=8, width=32, depth=2, heads=4, mlp_dim=64,
              num_classes=7, dtype=jnp.float32)
    x = np.random.default_rng(0).normal(size=(2, 16, 16, 3)).astype(
        np.float32)
    want = jax.jit(lambda v, x: jm.apply(v, x, False))(variables, x)
    port = vit_from_torch(sd, heads=4, dtype=torch.float32)
    assert (port.patch, port.image_size, port.mlp_dim) == (8, 16, 64)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
        oracle = t(torch.from_numpy(x.transpose(0, 3, 1, 2))).numpy()
    for k in want:
        close(got[k], want[k], k)
    close(got["logits"], oracle, "torch oracle")
    with pytest.raises(ValueError, match="heads="):
        vit_from_torch(sd)
    with pytest.raises(ValueError, match="width, depth"):
        vit_from_torch(sd, "ViT_B_16")


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(v)


def test_flax_carry_over_bit_equal():
    """Every flax leaf lands in the port's state dict unchanged (kernels
    transposed to the torch layouts)."""
    rj = JResNet(stage_sizes=(1, 2), width=8, num_classes=5,
                 block=JBottleneck)
    variables = jax.device_get(jax.jit(rj.init, static_argnums=2)(
        jax.random.PRNGKey(3), jnp.zeros((1, 32, 32, 3)), False))
    port = resnet_from_flax(variables).state_dict()
    leaves = dict(_flat(variables["params"])) | {
        k: v for k, v in _flat(variables["batch_stats"])}
    assert len(leaves) == len(port)
    for path, leaf in leaves.items():
        key = path.replace("/", ".").replace(".kernel", ".weight")
        got = port[key].numpy()
        if leaf.ndim == 4:
            got = got.transpose(2, 3, 1, 0)
        elif leaf.ndim == 2:
            got = got.T
        assert np.array_equal(got, leaf), path
    vj = JViT(patch=4, width=16, depth=2, heads=2, mlp_dim=32, num_classes=3)
    pv = jax.device_get(jax.jit(vj.init, static_argnums=2)(
        jax.random.PRNGKey(4), jnp.zeros((1, 8, 8, 3)), False))
    port = vit_from_flax(pv, heads=2).state_dict()
    leaves = dict(_flat(pv["params"]))
    assert len(leaves) == len(port)
    for path, leaf in leaves.items():
        key = path.replace("/", ".").replace(".kernel", ".weight") \
            .replace(".scale", ".weight")
        got = port[key].numpy()
        if leaf.ndim == 4 and path.startswith("conv_proj"):
            got = got.transpose(2, 3, 1, 0)
        elif leaf.ndim == 2:
            got = got.T
        assert np.array_equal(got, leaf), path


def test_mismatched_state_dict_fails_loudly():
    t = torchvision_resnet("ResNet18", width=16)
    sd = t.state_dict()
    sd["layer5.0.conv1.weight"] = torch.zeros(1)
    with pytest.raises(ValueError, match="unconverted"):
        resnet_from_torch(sd, "ResNet18")
    sd2 = t.state_dict()
    del sd2["layer2.0.conv1.weight"]
    with pytest.raises(KeyError):
        resnet_from_torch(sd2, "ResNet18")
    with pytest.raises(KeyError, match="no torchvision mapping"):
        resnet_from_torch(t.state_dict(), "ResNet19")
    vsd = TorchViT().state_dict()
    vsd["encoder.extra.weight"] = torch.zeros(1)
    with pytest.raises(ValueError, match="unconverted"):
        vit_from_torch(vsd, heads=4)


def _features(module, x):
    with torch.no_grad():
        return module(torch.from_numpy(x))["pooled"].float().numpy()


def test_save_verify_download_round_trip(tmp_path):
    t = torchvision_resnet("ResNet18", width=64, classes=1000, seed=3)
    module = resnet_from_torch(t.state_dict(), "ResNet18",
                               dtype=torch.float32)
    path = save_converted(module, "ResNet18", str(tmp_path))
    assert path == str(tmp_path / "ResNet18.pt")
    manifest = str(tmp_path / "ResNet18.pt.manifest.json")
    verify_checkpoint(module.state_dict(), manifest)
    loaded = ModelDownloader(local_dir=str(tmp_path)).download_by_name(
        "ResNet18", dtype="float32")
    assert loaded.layer_names == list(get_model("ResNet18").layer_names)
    for k, v in module.state_dict().items():
        assert torch.equal(loaded.module.state_dict()[k], v), k
    x = np.random.default_rng(4).uniform(0, 255, (2, 32, 32, 3)).astype(
        np.float32)
    np.testing.assert_array_equal(_features(loaded.module, x),
                                  _features(module, x))


def test_corrupted_checkpoint_rejected(tmp_path):
    t = torchvision_resnet("ResNet18", width=64, classes=1000, seed=5)
    module = resnet_from_torch(t.state_dict(), "ResNet18")
    save_converted(module, "ResNet18", str(tmp_path))
    mpath = tmp_path / "ResNet18.pt.manifest.json"
    manifest = json.loads(mpath.read_text())
    mpath.write_text(json.dumps(dict(manifest, sha256="0" * 64)))
    with pytest.raises(IOError, match="hash mismatch"):
        ModelDownloader(local_dir=str(tmp_path)).download_by_name("ResNet18")
    mpath.write_text(json.dumps(manifest))              # weights changed
    sd = torch.load(tmp_path / "ResNet18.pt", weights_only=True)
    sd["head.bias"][0] += 1.0
    torch.save(sd, tmp_path / "ResNet18.pt")
    with pytest.raises(IOError, match="hash mismatch"):
        ModelDownloader(local_dir=str(tmp_path)).download_by_name("ResNet18")


def test_random_init_refused_when_disallowed(tmp_path, monkeypatch):
    dl = ModelDownloader(local_dir=str(tmp_path))
    with pytest.raises(FileNotFoundError, match="allow_random_init"):
        dl.download_by_name("ResNet34", allow_random_init=False)
    monkeypatch.setenv("MMLSPARK_TPU_ALLOW_RANDOM_INIT", "0")
    with pytest.raises(FileNotFoundError):
        dl.download_by_name("ResNet34")


def test_seeded_init_deterministic_by_name(tmp_path):
    dl = ModelDownloader(local_dir=str(tmp_path))
    with pytest.warns(UserWarning, match="RANDOM weights"):
        a = dl.download_by_name("ResNet18")
    b = ModelDownloader().download_by_name("ResNet18",
                                           allow_random_init=True)
    for k, v in a.module.state_dict().items():
        assert torch.equal(b.module.state_dict()[k], v), k
    assert a.module.dtype == torch.bfloat16
    c = dl.download_by_name("ResNet34", allow_random_init=True,
                            num_classes=10, dtype=torch.float32)
    assert not torch.equal(c.module.conv_init.weight,
                           a.module.conv_init.weight)
    assert c.module.head.weight.shape == (10, 512)


def test_orbax_directory_raises_naming_its_format(tmp_path):
    os.makedirs(tmp_path / "ResNet50")
    with pytest.raises(ValueError, match="orbax"):
        ModelDownloader(local_dir=str(tmp_path)).download_by_name("ResNet50")


def test_ingested_bert_reloads_by_name(tmp_path, monkeypatch):
    """PR 14's ingestion, saved and reloaded by name: the featurizer's
    ``modelName`` gives the ``model=`` features bit for bit, and the JAX
    featurizer's over the same checkpoint within 1e-4."""
    sd = make_bert_state_dict(seed=0, prefix="bert.", lm_head=True)
    module = bert_encoder_from_torch(sd, heads=HEADS)
    arch = dict(vocab=module.vocab, width=module.width, depth=module.depth,
                heads=module.heads, mlp_dim=module.mlp_dim,
                max_len=module.max_len, type_vocab=module.type_vocab)
    schema = register_bert_encoder("SavedBertMini", **arch)
    save_converted(module, "SavedBertMini", str(tmp_path))
    monkeypatch.setenv("MMLSPARK_TPU_MODEL_DIR", str(tmp_path))
    ids = np.random.default_rng(2).integers(5, arch["vocab"], (3, 24))
    ids[1, 10:] = 0
    df = DataFrame({"tokens": ids.astype(np.int32)})
    by_name = TextEncoderFeaturizer(modelName="SavedBertMini", device="cpu",
                                    seqChunk=8).transform(df)["features"]
    direct = TextEncoderFeaturizer(model=LoadedModel(schema, module),
                                   device="cpu", seqChunk=8).transform(
        df)["features"]
    np.testing.assert_array_equal(by_name, direct)
    jmodule, variables = jconvert.bert_encoder_from_torch(sd, heads=HEADS)
    from mmlspark_tpu.core import DataFrame as JDataFrame
    want = JTextEncoderFeaturizer(
        model=JLoadedModel(JModelSchema(name="SavedBertMini"), jmodule,
                           variables), seqChunk=8).transform(
        JDataFrame({"tokens": ids.astype(np.int32)}))["features"]
    np.testing.assert_allclose(by_name, np.asarray(want), atol=ATOL)


def test_convert_torch_checkpoint_and_cli(tmp_path, capsys):
    t = torchvision_resnet("ResNet18", width=64, classes=1000, seed=6)
    src = tmp_path / "resnet18.pth"
    torch.save({"state_dict": t.state_dict()}, src)
    out = tmp_path / "zoo"
    assert convert._main([str(src), "ResNet18", str(out)]) == 0
    assert "converted ResNet18" in capsys.readouterr().out
    assert convert._main([]) == 2
    loaded = ModelDownloader(local_dir=str(out)).download_by_name(
        "ResNet18", dtype=torch.float32)
    want = resnet_from_torch(t.state_dict(), "ResNet18",
                             dtype=torch.float32)
    x = np.random.default_rng(7).uniform(0, 255, (2, 32, 32, 3)).astype(
        np.float32)
    np.testing.assert_array_equal(_features(loaded.module, x),
                                  _features(want, x))
