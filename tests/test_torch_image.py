"""The port's image path against the JAX package: ``image/ops.py``,
``ImageTransformer``, the four image stages, ``TPUModel``,
``ImageFeaturizer`` and the readers of ``io/``.

Held:
- ``resize`` against ``jax.image.resize(method="linear")`` on downscales,
  upscales, mixed scales and identity, within 5e-3 absolute on 0-255 data
  (the port computes the JAX weight formula in f32; XLA's fused weights
  differ from the formula by up to ~8e-6); a bilinear resize without
  antialiasing differs on a downscale by tens, so the hold sees one;
- every other op exactly or within 1e-4 (the blurs' f32 sums);
- ``ImageTransformer`` on a uniform and a ragged column, and the stages,
  against the JAX stages; ``UnrollImage`` in CHW order;
- ``TPUModel``: the zero-padded tail dropped, ``fetchDict``,
  ``inputShape``, each ``transferDtype`` (uint8 stays uint8, bfloat16
  narrowed on the host), ``pipelineDepth`` and ``last_stats``;
- ``ImageFeaturizer`` at every ``cutOutputLayers`` of a small ResNet and
  ViT against the JAX featurizer (f32 within 1e-4 of the largest value;
  the bf16 model's wire narrowing too);
- ``BinaryFileReader`` with zip expansion and subsampling, ``read_images``
  and the stream sources against the JAX package's (PIL is here).
"""

import io
import os
import sys
import time
import zipfile

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmlspark_tpu.core import DataFrame as JDataFrame
from mmlspark_tpu.dl.model import TPUModel as JTPUModel
from mmlspark_tpu.image import ImageFeaturizer as JImageFeaturizer
from mmlspark_tpu.image import ImageSetAugmenter as JImageSetAugmenter
from mmlspark_tpu.image import ImageTransformer as JImageTransformer
from mmlspark_tpu.image import ResizeImageTransformer as JResize
from mmlspark_tpu.image import UnrollBinaryImage as JUnrollBinaryImage
from mmlspark_tpu.image import UnrollImage as JUnrollImage
from mmlspark_tpu.image import ops as jops
from mmlspark_tpu.io import binary as jbinary
from mmlspark_tpu.io import image_source as jsource
from mmlspark_tpu.models.zoo import LoadedModel as JLoadedModel
from mmlspark_tpu.models.zoo import ModelSchema as JModelSchema
from mmlspark_torch.core import DataFrame
from mmlspark_torch.dl import TPUModel
from mmlspark_torch.image import (ImageFeaturizer, ImageSetAugmenter,
                                  ImageTransformer, ResizeImageTransformer,
                                  UnrollBinaryImage, UnrollImage, ops)
from mmlspark_torch.io import binary, image_source
from mmlspark_torch.models import (LoadedModel, ModelSchema,
                                   resnet_from_flax, vit_from_flax)
import test_torch_vision_models as vm

RESIZE_ATOL = 5e-3
RTOL = 1e-4
RESNET_LAYERS = ("stage1", "stage2", "stage3", "stage4", "pooled", "logits")
VIT_LAYERS = ("block1", "block2", "pooled", "logits")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Single-threaded torch (tier-1 runs several workers at once)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def pixels(shape, seed=0):
    return np.random.default_rng(seed).uniform(0, 255, shape).astype(
        np.float32)


def u8_images(n, h, w, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (n, h, w, 3)) \
        .astype(np.uint8)


def ragged(seed=0):
    col = np.empty(3, object)
    col[:] = [u8_images(1, 20, 24, seed)[0], u8_images(1, 18, 18, seed + 1)[0],
              u8_images(1, 20, 24, seed + 2)[0]]
    return col


@pytest.mark.parametrize("src, dst", [
    ((256, 256), (224, 224)), ((300, 200), (224, 224)), ((20, 30), (64, 48)),
    ((37, 53), (16, 70)), ((32, 32), (32, 32))])
def test_resize_against_jax(src, dst):
    x = pixels((2, *src, 3))
    want = np.asarray(jops.resize(jnp.asarray(x), *dst))
    got = ops.resize(torch.from_numpy(x), *dst)
    assert got.dtype == torch.float32 and got.is_contiguous()
    assert np.abs(got.numpy() - want).max() <= RESIZE_ATOL
    plain = torch.nn.functional.interpolate(
        torch.from_numpy(x).permute(0, 3, 1, 2), size=dst, mode="bilinear",
        align_corners=False, antialias=False).permute(0, 2, 3, 1).numpy()
    if src[0] > dst[0] and src[0] > 1.5 * dst[0]:
        assert np.abs(plain - want).max() > 10 * RESIZE_ATOL


@pytest.mark.parametrize("name, args", [
    ("crop", (2, 3, 5, 7)), ("center_crop", (9, 9)), ("flip", (1,)),
    ("flip", (0,)), ("flip", (-1,)), ("color_format", ("gray",)),
    ("color_format", ("bgr2rgb",)), ("blur", (3, 5)),
    ("gaussian_blur", (5, 0.0)), ("gaussian_blur", (3, 1.2)),
    ("threshold", (100.0, 255.0, "binary")),
    ("threshold", (100.0, 200.0, "binary_inv")),
    ("threshold", (100.0, 255.0, "trunc")),
    ("threshold", (100.0, 255.0, "tozero")),
    ("threshold", (100.0, 255.0, "tozero_inv"))])
def test_ops_against_jax(name, args):
    x = pixels((2, 17, 23, 3), seed=1)
    want = np.asarray(getattr(jops, name)(jnp.asarray(x), *args))
    got = getattr(ops, name)(torch.from_numpy(x), *args).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=RTOL * 255)


def test_ops_refuse_unknown_modes():
    x = torch.zeros(1, 4, 4, 3)
    with pytest.raises(ValueError, match="unsupported conversion"):
        ops.color_format(x, "hsv")
    with pytest.raises(ValueError, match="unknown threshold"):
        ops.threshold(x, 1.0, 2.0, "otsu")


def _chain(cls, **kw):
    return cls(inputCol="image", outputCol="out", **kw).resize(16, 20) \
        .crop(1, 2, 12, 15).colorFormat("bgr2rgb").flip(-1).blur(3, 3) \
        .gaussianKernel(3, 0.8).threshold(90.0, 255.0, "tozero")


@pytest.mark.parametrize("kind", ["uniform", "ragged"])
def test_image_transformer_against_jax(kind):
    col = u8_images(3, 24, 30, seed=2) if kind == "uniform" else ragged(3)
    want = _chain(JImageTransformer).transform(
        JDataFrame({"image": col}))["out"]
    got = _chain(ImageTransformer, device="cpu").transform(
        DataFrame({"image": col}))["out"]
    assert got.shape == want.shape
    np.testing.assert_allclose(np.stack(list(got)),
                               np.stack([np.asarray(a) for a in want]),
                               rtol=0, atol=RESIZE_ATOL)
    # ragged output shapes stay an object column
    mixed = ImageTransformer(inputCol="image", outputCol="out",
                             device="cpu").flip(1).transform(
        DataFrame({"image": ragged(4)}))["out"]
    assert mixed.dtype == object and mixed[1].shape == (18, 18, 3)
    stages = _chain(ImageTransformer).get("stages")
    assert stages[0] == ["resize", {"height": 16, "width": 20}]


def test_stages_against_jax():
    col = u8_images(4, 20, 26, seed=5)
    for kind, images in (("uniform", col), ("ragged", ragged(6))):
        want = JResize(height=12, width=14).transform(
            JDataFrame({"image": images}))["image"]
        got = ResizeImageTransformer(height=12, width=14, device="cpu") \
            .transform(DataFrame({"image": images}))["image"]
        assert got.dtype == np.float32, kind
        np.testing.assert_allclose(got, np.asarray(want), rtol=0,
                                   atol=RESIZE_ATOL, err_msg=kind)
    want = np.asarray(JUnrollImage().transform(
        JDataFrame({"image": col}))["unrolled"])
    got = UnrollImage(device="cpu").transform(
        DataFrame({"image": col}))["unrolled"]
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(                  # CHW order
        got[1].reshape(3, 20, 26), col[1].transpose(2, 0, 1))
    for kw in ({}, {"flipUpDown": True}, {"flipLeftRight": False}):
        want = JImageSetAugmenter(**kw).transform(JDataFrame({"image": col}))
        got = ImageSetAugmenter(device="cpu", **kw).transform(
            DataFrame({"image": col}))
        assert got.num_rows == want.num_rows == 4 * (
            1 + kw.get("flipLeftRight", True) + kw.get("flipUpDown", False))
        np.testing.assert_array_equal(got["image"], np.asarray(want["image"]))


def _png(img: np.ndarray) -> bytes:
    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="PNG")
    return buf.getvalue()


def test_unroll_binary_image_against_jax():
    imgs = [u8_images(1, 10, 12, seed=s)[0] for s in range(3)]
    blobs = np.empty(3, object)
    blobs[:] = [_png(a) for a in imgs]
    for kw in ({}, {"height": 8, "width": 9}):
        want = JUnrollBinaryImage(**kw).transform(
            JDataFrame({"image": blobs}))["unrolled"]
        got = UnrollBinaryImage(device="cpu", **kw).transform(
            DataFrame({"image": blobs}))["unrolled"]
        np.testing.assert_allclose(got, np.asarray(want), rtol=0,
                                   atol=RESIZE_ATOL)
    # decode gives BGR
    np.testing.assert_array_equal(binary.decode_image(blobs[0]),
                                  imgs[0][..., ::-1])


@pytest.fixture(scope="module")
def small_resnet():
    m, v = vm.jax_resnet("bottleneck")
    return (m, v), resnet_from_flax(v, dtype=torch.float32)


@pytest.mark.parametrize("wire", ["auto", "uint8", "bfloat16", "float32"])
def test_tpumodel_against_jax(small_resnet, wire):
    (m, v), port = small_resnet
    x = u8_images(5, 32, 32, seed=7)
    fetch = {"pooled": "p", "stage4": "s4", "logits": "l"}
    kw = dict(inputCol="image", minibatchSize=2, fetchDict=fetch,
              transferDtype=wire)
    want = JTPUModel(model=(m, v), **kw).transform(JDataFrame({"image": x}))
    stage = TPUModel(model=port, device="cpu", **kw)
    got = stage.transform(DataFrame({"image": x}))
    for col in fetch.values():
        assert got[col].dtype == np.float32 and got[col].shape[0] == 5
        vm.assert_close(got[col], np.asarray(want[col]), RTOL, col)
    assert got["s4"].shape == (5, 1 * 1 * 256)
    assert set(stage.last_stats) == {"prep_ms", "dispatch_ms", "drain_ms",
                                     "total_ms"}
    wire_dtype = stage._coerce_input(x).dtype
    assert wire_dtype == (torch.float32 if wire == "float32" else
                          torch.uint8)
    floats = x.astype(np.float32) + 0.3
    assert stage._coerce_input(floats).dtype == (
        torch.bfloat16 if wire == "bfloat16" else torch.float32)


def test_tpumodel_input_shape_padding_and_depth(small_resnet):
    (m, v), port = small_resnet
    x = u8_images(5, 32, 32, seed=8)
    unrolled = UnrollImage(device="cpu").transform(
        DataFrame({"image": x}))["unrolled"]
    kw = dict(inputCol="unrolled", inputShape=(32, 32, 3), minibatchSize=4)
    want = JTPUModel(model=(m, v), **kw).transform(
        JDataFrame({"unrolled": unrolled}))["output"]
    for depth in (2, 3):
        got = TPUModel(model=LoadedModel(ModelSchema(name="t"), port),
                       device="cpu", pipelineDepth=depth, **kw).transform(
            DataFrame({"unrolled": unrolled}))["output"]
        vm.assert_close(got, np.asarray(want), RTOL, f"depth {depth}")
    # the padded tail is dropped: a row alone gives its batched features
    one = TPUModel(model=port, device="cpu", **kw).transform(
        DataFrame({"unrolled": unrolled[3:4]}))["output"]
    vm.assert_close(one[0], got[3], 1e-6, "row alone")
    with pytest.raises(ValueError, match="pipelineDepth"):
        TPUModel(model=port, device="cpu", pipelineDepth=1, **kw).transform(
            DataFrame({"unrolled": unrolled}))
    with pytest.raises(KeyError, match="endpoint"):
        TPUModel(model=port, device="cpu", outputNode="nope", **kw) \
            .transform(DataFrame({"unrolled": unrolled}))
    with pytest.raises(ValueError, match="transferDtype"):
        TPUModel(model=port, device="cpu", transferDtype="fp8",
                 **kw).transform(DataFrame({"unrolled": unrolled}))


@pytest.mark.parametrize("kind, cut", [("resnet", c) for c in range(6)]
                         + [("vit", c) for c in range(4)] + [("vit-bf16", 1)])
def test_image_featurizer_cut_layers_against_jax(kind, cut):
    if kind == "resnet":
        m, v = vm.jax_resnet("basic")
        port = resnet_from_flax(v, dtype=torch.float32)
        size, layers = 32, RESNET_LAYERS
    else:
        dtype = jnp.bfloat16 if kind == "vit-bf16" else jnp.float32
        m, v = vm.jax_vit(dtype)
        port = vit_from_flax(v, heads=vm.VIT["heads"], dtype=(
            torch.bfloat16 if kind == "vit-bf16" else torch.float32))
        size, layers = 16, VIT_LAYERS
    imgs = u8_images(3, 20, 28, seed=cut)
    kw = dict(cutOutputLayers=cut, miniBatchSize=2, inputCol="image")
    want = JImageFeaturizer(model=JLoadedModel(JModelSchema(
        name="t", input_size=size, layer_names=layers), m, v), **kw) \
        .transform(JDataFrame({"image": imgs}))["features"]
    stage = ImageFeaturizer(model=LoadedModel(ModelSchema(
        name="t", input_size=size, layer_names=layers), port), device="cpu",
        **kw)
    got = stage.transform(DataFrame({"image": imgs}))["features"]
    rtol = vm.BF16_RTOL if kind == "vit-bf16" else RTOL
    vm.assert_close(got, np.asarray(want), rtol, layers[-(cut + 1)])
    tpu = stage._tpu_model[1]
    assert tpu.get("transferDtype") == (
        "bfloat16" if kind == "vit-bf16" else "auto")
    stage.transform(DataFrame({"image": imgs}))
    assert stage._tpu_model[1] is tpu                 # reused


def test_image_featurizer_zoo_and_errors(monkeypatch, tmp_path):
    monkeypatch.setenv("MMLSPARK_TPU_MODEL_DIR", str(tmp_path))
    stage = ImageFeaturizer(modelName="ResNet18", device="cpu",
                            miniBatchSize=2, cutOutputLayers=1)
    with pytest.warns(UserWarning, match="RANDOM"):
        loaded = stage._loaded()
    assert stage._loaded() is loaded                  # cached per name/dir
    assert loaded.schema.input_size == 224
    with pytest.raises(ValueError, match="cutOutputLayers"):
        ImageFeaturizer(model=loaded, cutOutputLayers=6, device="cpu") \
            .transform(DataFrame({"image": u8_images(1, 8, 8)}))
    assert ImageFeaturizer().setModel("ViT_B_16").get("modelName") == \
        "ViT_B_16"


def _write_images(root):
    os.makedirs(root / "sub")
    imgs = {}
    for i, rel in enumerate(["a.png", "b.png", "sub/c.png"]):
        imgs[rel] = u8_images(1, 6 + i, 7, seed=i)[0]
        (root / rel).write_bytes(_png(imgs[rel]))
    (root / "notes.txt").write_bytes(b"not an image")
    with zipfile.ZipFile(root / "pack.zip", "w") as z:
        z.writestr("d.png", _png(imgs["a.png"]))
        z.writestr("dir/", b"")
        z.writestr("dir/e.bin", b"\x00\x01")
    return imgs


def _same(got, want):
    assert got.columns == want.columns
    for c in got.columns:
        assert len(got[c]) == len(want[c]), c
        for a, b in zip(got[c], want[c]):
            if isinstance(a, np.ndarray):
                np.testing.assert_array_equal(a, b)
            else:
                assert a == b, c


def test_binary_reader_zip_and_read_images_against_jax(tmp_path):
    _write_images(tmp_path)
    for kw in ({}, {"inspect_zip": False}, {"glob": "*.png"},
               {"sample_ratio": 0.5}):
        _same(binary.read_binary_files(str(tmp_path), **kw),
              jbinary.read_binary_files(str(tmp_path), **kw))
    got = binary.BinaryFileReader(sample_ratio=0.5, seed=3).read(
        str(tmp_path))
    _same(got, jbinary.BinaryFileReader(sample_ratio=0.5, seed=3).read(
        str(tmp_path)))
    zipped = binary.read_binary_files(str(tmp_path))["path"]
    assert any(p.endswith("pack.zip::d.png") for p in zipped)
    images = binary.read_images(str(tmp_path))
    _same(images, jbinary.read_images(str(tmp_path)))
    assert len(images) == 3                       # the text file is dropped


def test_read_images_without_pil_raises(tmp_path, monkeypatch):
    """A missing PIL raises from ``read_images`` instead of dropping every
    image as undecodable; reading the bytes alone needs no PIL."""
    _write_images(tmp_path)
    monkeypatch.setitem(sys.modules, "PIL", None)
    monkeypatch.setitem(sys.modules, "PIL.Image", None)
    with pytest.raises(ImportError):
        binary.read_images(str(tmp_path))
    raw = binary.read_images(str(tmp_path), decode=False)
    assert len(raw) == 5            # every file, the zip unexpanded


def test_file_stream_source_offsets_against_jax(tmp_path):
    imgs = _write_images(tmp_path)
    port = image_source.FileStreamSource(str(tmp_path), glob="*.png",
                                         max_files_per_batch=2)
    ref = jsource.FileStreamSource(str(tmp_path), glob="*.png",
                                   max_files_per_batch=2)
    for _ in range(3):
        a, b = port.next_batch(), ref.next_batch()
        assert (a is None) == (b is None)
        if a is not None:
            _same(a, b)
        assert port.offset_json() == ref.offset_json()
    assert port.next_batch() is None
    time.sleep(0.01)
    (tmp_path / "new.png").write_bytes(_png(imgs["a.png"]))
    resumed = image_source.FileStreamSource(str(tmp_path), glob="*.png")
    resumed.restore_offset(port.offset_json())
    fresh = resumed.next_batch()
    assert list(fresh["path"]) == [str(tmp_path / "new.png")]
    batches = list(image_source.FileStreamSource(
        str(tmp_path), glob="*").stream(poll_interval=0.01,
                                        idle_timeout=0.05))
    assert sum(len(b) for b in batches) == 6
    (tmp_path / "broken.png").write_bytes(b"garbage")
    stream = image_source.ImageStreamSource(str(tmp_path), glob="*.png")
    out = stream.next_batch()
    want = jsource.ImageStreamSource(str(tmp_path), glob="*.png").next_batch()
    assert list(out["path"]) == list(want["path"])
    bad = [p.endswith("broken.png") for p in out["path"]]
    for i, is_bad in enumerate(bad):
        assert (out["image"][i] is None) == is_bad
        assert (out["error"][i] is not None) == is_bad
        if not is_bad:
            np.testing.assert_array_equal(out["image"][i], want["image"][i])


def test_image_stages_save_and_load_in_the_port(small_resnet, tmp_path):
    """A featurizer holding a model, a TPUModel and a chain round-trip
    through the port's own save/load bit for bit."""
    from mmlspark_torch.core import load_stage
    _, port = small_resnet
    imgs = u8_images(3, 20, 28, seed=11)
    df = DataFrame({"image": imgs})
    stages = {
        "featurizer": ImageFeaturizer(model=LoadedModel(ModelSchema(
            name="t", input_size=32, layer_names=RESNET_LAYERS), port),
            device="cpu", cutOutputLayers=2),
        "tpu": TPUModel(model=port, inputCol="image", device="cpu",
                        outputNode="stage3"),
        "chain": _chain(ImageTransformer, device="cpu")}
    frames = {"featurizer": df, "chain": df,
              "tpu": DataFrame({"image": u8_images(3, 32, 32, seed=12)})}
    for name, stage in stages.items():
        want = stage.transform(frames[name])
        stage.save(str(tmp_path / name))
        loaded = load_stage(str(tmp_path / name))
        assert type(loaded) is type(stage)
        got = loaded.transform(frames[name])
        col = stage.getOutputCol()
        np.testing.assert_array_equal(got[col], want[col])
