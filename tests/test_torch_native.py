"""The port's native transform pipeline (aa_clip_iqm_tpu_torch/data/native.py,
its own copy of the C++ source) on the CPU: each of the five entries bit for
bit the JAX package's ``aa_clip_iqm_tpu.data.native`` at sizes that resize
(97x123 -> 56, as tests/test_native_pipeline.py uses); the bicubic resize
within one level (1/255) of PIL's; the mask resize exactly the nearest rule
floor((i + 0.5) * src / dst), which is PIL's but where that coordinate is
an exact tie (PIL accumulates the coordinate in floating point and lands
below the tie: at 518 px from 600-900 px sources, 0.2% of the pixels), as the
JAX package's native resize has it; the nearest warp exactly the numpy
warp's; the library built from the port's source
into the port's build directory, and rebuilt when the source is newer;
``get_dataset`` batches from synthetic images written at a size that
resizes (70 px for a 56 px model), port against JAX, with the native
pipeline on in both, and again with ``AACLIP_NATIVE=0`` in both: bit for
bit. Where no library can be built the data layer takes the PIL path."""
import concurrent.futures
import os

import numpy as np
import pytest
from PIL import Image

from aa_clip_iqm_tpu.data import datasets as jdatasets
from aa_clip_iqm_tpu.data import native as jnative
from aa_clip_iqm_tpu.data import synthetic as jsynthetic
from aa_clip_iqm_tpu_torch.data import datasets as tdatasets
from aa_clip_iqm_tpu_torch.data import native as tnative
from aa_clip_iqm_tpu_torch.data import synthetic as tsynthetic
from aa_clip_iqm_tpu_torch.data.registry import IMAGE_MEAN, IMAGE_STD

IMG = 56
WRITTEN = 70          # the synthetic images' size: every load resizes
CLASSES = ("widget", "gadget")


@pytest.fixture(scope="module", autouse=True)
def both_built():
    assert tnative.available(), tnative.BUILD_LOG
    assert jnative.available()


@pytest.fixture
def rng():
    return np.random.default_rng(12)


def _rotation(angle, size):
    a = np.deg2rad(angle)
    c = size / 2 - 0.5
    cos, sin = np.cos(a), np.sin(a)
    return np.array([[cos, sin, (1 - cos) * c - sin * c],
                     [-sin, cos, sin * c + (1 - cos) * c]], np.float64)


def test_the_port_builds_its_own_source_into_its_build_directory():
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert tnative.SOURCE == os.path.join(repo, "aa_clip_iqm_tpu_torch", "native",
                                          "image_pipeline.cpp")
    assert tnative.LIB_PATH == os.path.join(repo, "build", "aa_clip_iqm_tpu_torch",
                                            "libaaclip_data.so")
    assert os.path.isfile(tnative.LIB_PATH)
    jlib = os.path.realpath(jnative._LIB_PATH)
    assert os.path.realpath(tnative.LIB_PATH) != jlib
    assert tnative.load_library()._name == tnative.LIB_PATH


@pytest.mark.parametrize("size", [56, 70, 256])
def test_bicubic_resize_equals_jax_and_pil_within_one_level(rng, size):
    img = rng.integers(0, 256, (97, 123, 3)).astype(np.uint8)
    out = tnative.resize_bicubic_rgb(img, size)
    assert out.shape == (3, size, size) and out.dtype == np.float32
    np.testing.assert_array_equal(out, jnative.resize_bicubic_rgb(img, size))
    pil = np.asarray(Image.fromarray(img).resize((size, size), Image.BICUBIC),
                     np.float32).transpose(2, 0, 1) / 255.0
    np.testing.assert_allclose(out, pil, atol=1.01 / 255.0)


@pytest.mark.parametrize("shape,size", [((83, 57), 64), ((97, 123), 56)])
def test_mask_resize_equals_jax_and_pil(rng, shape, size):
    mask = (rng.random(shape) > 0.5).astype(np.uint8) * 255
    out = tnative.resize_nearest_mask(mask, size)
    np.testing.assert_array_equal(out, jnative.resize_nearest_mask(mask, size))
    pil = (np.asarray(Image.fromarray(mask, "L").resize((size, size), Image.NEAREST))
           != 0).astype(np.float32)
    np.testing.assert_array_equal(out, pil)


@pytest.mark.parametrize("shape", [(700, 900), (600, 600)])
def test_mask_resize_departs_from_pil_only_at_exact_ties(rng, shape):
    h, w = shape
    size = 518
    mask = (rng.random(shape) > 0.5).astype(np.uint8) * 255
    out = tnative.resize_nearest_mask(mask, size)
    np.testing.assert_array_equal(out, jnative.resize_nearest_mask(mask, size))
    i = np.arange(size)
    rule = mask[((2 * i + 1) * h) // (2 * size)][:, ((2 * i + 1) * w) // (2 * size)] != 0
    np.testing.assert_array_equal(out, rule.astype(np.float32))
    pil = np.asarray(Image.fromarray(mask, "L").resize((size, size), Image.NEAREST)) != 0
    tie = ((((2 * i + 1) * h) % (2 * size) == 0)[:, None]
           | (((2 * i + 1) * w) % (2 * size) == 0)[None, :])
    off = (out != 0) != pil
    assert off.any() and not (off & ~tie).any()
    assert off.mean() < 0.01


def test_normalize_equals_jax(rng):
    img = rng.random((3, 56, 56)).astype(np.float32)
    out = tnative.normalize_chw(img.copy(), IMAGE_MEAN, IMAGE_STD)
    np.testing.assert_array_equal(out, jnative.normalize_chw(img.copy(), IMAGE_MEAN, IMAGE_STD))
    ref = (img - np.asarray(IMAGE_MEAN, np.float32)[:, None, None]) / np.asarray(
        IMAGE_STD, np.float32)[:, None, None]
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("bilinear", [False, True])
@pytest.mark.parametrize("angle", [17.0, -23.0])
def test_warp_equals_jax_and_the_numpy_warp(rng, bilinear, angle):
    img = rng.random((3, 56, 56)).astype(np.float32)
    mask = (rng.random((1, 56, 56)) > 0.5).astype(np.float32)
    stack = np.concatenate([img, mask])
    M = _rotation(angle, 56)
    out = tnative.warp_affine_chw(stack, M, bilinear=bilinear)
    np.testing.assert_array_equal(out, jnative.warp_affine_chw(stack, M, bilinear=bilinear))
    if not bilinear:
        np.testing.assert_array_equal(out, tdatasets._warp_nearest(stack, M))
        assert set(np.unique(out[3])) <= {0.0, 1.0}


def test_flip_equals_jax_and_numpy(rng):
    stack = rng.random((4, 16, 24)).astype(np.float32)
    for h, v in ((True, False), (False, True), (True, True)):
        out = tnative.flip_chw(stack, h, v)
        np.testing.assert_array_equal(out, jnative.flip_chw(stack, h, v))
        want = stack[:, ::-1 if v else 1, ::-1 if h else 1]
        np.testing.assert_array_equal(out, want)


def test_entries_refuse_wrong_shapes():
    with pytest.raises(ValueError):
        tnative.resize_bicubic_rgb(np.zeros((8, 8), np.uint8), 4)
    with pytest.raises(ValueError):
        tnative.warp_affine_chw(np.zeros((1, 8, 8), np.float32), np.eye(3))
    with pytest.raises(ValueError):
        tnative.normalize_chw(np.zeros((3, 4, 4), np.float32), (0.5, 0.5), (1.0, 1.0))


def test_threads_get_the_serial_results(rng):
    """The decode pool's threads call the library at once: each result is
    the serial one."""
    imgs = [rng.integers(0, 256, (97, 123, 3)).astype(np.uint8) for _ in range(16)]
    serial = [tnative.resize_bicubic_rgb(im, 56) for im in imgs]
    with concurrent.futures.ThreadPoolExecutor(4) as pool:
        threaded = list(pool.map(lambda im: tnative.resize_bicubic_rgb(im, 56), imgs))
    for a, b in zip(threaded, serial):
        np.testing.assert_array_equal(a, b)


def test_a_stale_library_is_rebuilt(tmp_path, monkeypatch):
    """A library older than its source is rebuilt (into place, by rename);
    a source that does not compile leaves the pipeline unavailable, with the
    compiler's message, and the data layer on its PIL path."""
    lib = str(tmp_path / "libaaclip_data.so")
    monkeypatch.setattr(tnative, "LIB_PATH", lib)
    monkeypatch.setattr(tnative, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "_load_failed", False)
    assert tnative._stale()
    assert tnative.load_library() is not None and os.path.isfile(lib)
    assert not tnative._stale()
    os.utime(lib, (1, 1))
    assert tnative._stale()

    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(tnative, "SOURCE", str(bad))
    monkeypatch.setattr(tnative, "_lib", None)
    assert not tnative.available()
    assert "bad.cpp" in tnative.BUILD_LOG
    assert not tdatasets._use_native()


# --------------------------------------------------------------------------
# get_dataset on images that resize: port against JAX, each backend
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("synth_native"))
    tsynthetic.generate(root, n_normal=2, n_anomalous=3, size=WRITTEN,
                        class_names=CLASSES, seed=6)
    meta_root = tsynthetic.register_synthetic(root, CLASSES)
    assert jsynthetic.register_synthetic(root, CLASSES) == meta_root
    return meta_root


def _same(got, want):
    got, want = list(got), list(want)
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        assert a["file_name"] == b["file_name"]
        for key in ("image", "mask", "label"):
            assert a[key].dtype == b[key].dtype
            np.testing.assert_array_equal(a[key], b[key])


@pytest.mark.parametrize("native", ["1", "0"])
def test_get_dataset_resizing_equals_jax(data, monkeypatch, native):
    """Train (stage 1 and 2: jitter, resizes, warps, flips) and test batches
    of both packages over two epochs, native on in both or off in both."""
    monkeypatch.setenv("AACLIP_NATIVE", native)
    assert tdatasets._use_native() == jdatasets._use_native() == (native == "1")
    args = ("Synth", IMG, "full_shot", -1, "train")
    t_text, t_image = tdatasets.get_dataset(*args, metadata_root=data, seed=9)
    j_text, j_image = jdatasets.get_dataset(*args, metadata_root=data, seed=9)
    for t_ds, j_ds in ((t_text, j_text), (t_image, j_image)):
        for epoch in (0, 1):
            _same(t_ds.epoch_batches(epoch, 3), j_ds.epoch_batches(epoch, 3))
    t_test = tdatasets.get_dataset("Synth", IMG, None, -1, "test", metadata_root=data)
    j_test = jdatasets.get_dataset("Synth", IMG, None, -1, "test", metadata_root=data)
    for c in CLASSES:
        _same(t_test[c].batches(4), j_test[c].batches(4))


def test_the_two_backends_differ_by_at_most_one_level(data, monkeypatch):
    """The same test images through the native pipeline and through PIL:
    within 1/255 in [0, 1] (before normalisation), masks equal."""
    batches = {}
    for native in ("1", "0"):
        monkeypatch.setenv("AACLIP_NATIVE", native)
        ds = tdatasets.get_dataset("Synth", IMG, None, -1, "test", metadata_root=data)
        batches[native] = list(ds[CLASSES[0]].batches(8))
    for a, b in zip(batches["1"], batches["0"]):
        std = np.asarray(IMAGE_STD, np.float32)[:, None, None]
        diff = np.abs(a["image"] - b["image"]) * std
        assert diff.max() <= 1.01 / 255.0
        np.testing.assert_array_equal(a["mask"], b["mask"])
