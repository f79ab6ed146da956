"""The port's serving API against the JAX package's, on the CPU with
tiny_test_config(56): AnomalyDetector.from_checkpoint on an OpenAI-layout
.pt (zero-shot, and with a checkpoint that cli.train's writer left),
predict_paths, the MicroBatchingService, and evaluation/visualize.

Both detectors compute in float32 here. Their maps and scores agree to
1e-4 of the largest value (the tolerance of tests/test_torch_slice.py):
the two frameworks sum in other orders."""
import os
import threading
import time
from concurrent.futures import Future

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aa_clip_iqm_tpu import configs as jconfigs
from aa_clip_iqm_tpu import loader as jloader
from aa_clip_iqm_tpu.data import synthetic as jsynthetic
from aa_clip_iqm_tpu.serving import AnomalyDetector as JaxDetector
from aa_clip_iqm_tpu_torch import configs as tconfigs
from aa_clip_iqm_tpu_torch import serving
from aa_clip_iqm_tpu_torch.data import synthetic as tsynthetic
from aa_clip_iqm_tpu_torch.data.datasets import _load_image, _load_image_u8, normalize_clip
from aa_clip_iqm_tpu_torch.loader import init_trainable
from aa_clip_iqm_tpu_torch.models.convert import params_from_jax, tree_leaves, tree_map
from aa_clip_iqm_tpu_torch.serving import AnomalyDetector, MicroBatchingService
from aa_clip_iqm_tpu_torch.train import checkpoint as ckpt
from torch_ref import make_clip_state_dict

IMG = 56
CLASSES = ("widget", "gizmo")
TIMEOUT = 120          # seconds, for every future and every HTTP call


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    torch.set_num_threads(1)


def close_rel(out, ref, rtol=1e-4):
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(np.asarray(out, np.float32), ref, rtol=rtol,
                               atol=rtol * np.abs(ref).max())


def write_pt(directory, seed=4):
    """A tiny OpenAI-layout .pt in fp16, its positional embedding at a
    6 x 6 grid (the loader resizes it to 4 x 4)."""
    cfg = tconfigs.tiny_test_config(IMG).clip
    sd = make_clip_state_dict(
        np.random.default_rng(seed), v_layers=cfg.vision.layers,
        v_width=cfg.vision.width, v_patch=cfg.vision.patch_size, v_grid=6,
        t_layers=cfg.text.layers, t_width=cfg.text.width,
        vocab=cfg.text.vocab_size, embed_dim=cfg.embed_dim)
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, "ViT-tiny.pt")
    torch.save({k: torch.as_tensor(np.asarray(v)).half() for k, v in sd.items()}, path)
    return path, sd


def bridged_trainable():
    """The JAX package's zero-shot adapters (its init_trainable, seed 111)
    in the port's layout, float32 on the CPU."""
    jt = jloader.init_trainable(jconfigs.tiny_test_config(IMG))
    _, tt = params_from_jax(None, jax.tree.map(np.asarray, jt),
                            tconfigs.tiny_test_config(IMG), device="cpu",
                            dtype=torch.float32)
    return tt


def port_from_checkpoint(save_path, backbone, **kw):
    return AnomalyDetector.from_checkpoint(
        save_path, "Synth", img_size=IMG, backbone=backbone, model_name="tiny-test",
        compute_dtype=torch.float32, device="cpu", **kw)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """Two synthetic classes on disk, registered with both packages."""
    root = str(tmp_path_factory.mktemp("servdata"))
    tsynthetic.generate(root, n_normal=3, n_anomalous=3, size=IMG,
                        class_names=CLASSES, seed=5)
    meta_root = tsynthetic.register_synthetic(root, CLASSES)
    assert jsynthetic.register_synthetic(root, CLASSES) == meta_root
    return root, meta_root


def image_paths(root, n=3):
    d = os.path.join(root, "Synth", "widget", "test", "defect")
    return [os.path.join(d, f) for f in sorted(os.listdir(d))[:n]]


@pytest.fixture(scope="module")
def stack(tmp_path_factory, data):
    """The zero-shot detectors of both packages from_checkpoint on copies
    of one .pt, the port's with the JAX package's initial adapters."""
    tmp = tmp_path_factory.mktemp("pt")
    tpt, sd = write_pt(str(tmp / "port"))
    jpt, _ = write_pt(str(tmp / "jax"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(serving, "init_trainable", lambda cfg, **kw: bridged_trainable())
        tdet = port_from_checkpoint(None, tpt)
    jdet = JaxDetector.from_checkpoint(
        None, "Synth", img_size=IMG, backbone=jpt, model_name="tiny-test",
        compute_dtype=jnp.float32, use_pallas=False)
    return tdet, jdet, tpt, sd


def _images(seed, n):
    return np.random.default_rng(seed).integers(0, 256, (n, 3, IMG, IMG), dtype=np.uint8)


def test_from_checkpoint_zero_shot_matches_jax(stack):
    """The .pt converted and cached, untrained adapters, raw anchors: the
    JAX package's maps and scores, predict and predict_multi."""
    tdet, jdet, tpt, sd = stack
    assert os.path.isfile(os.path.splitext(tpt)[0] + f".{IMG}.npz")
    np.testing.assert_array_equal(
        tdet.frozen["visual"]["proj"].numpy(),
        sd["visual.proj"].astype(np.float16).astype(np.float32))
    assert tdet.class_names() == jdet.class_names() == list(CLASSES)
    for c in CLASSES:
        close_rel(tdet.anchors[c].numpy(), jdet.anchors[c])
    imgs = _images(1, 3)
    tm, ts = tdet.predict(imgs, "widget")
    jm, js = jdet.predict(imgs, "widget")
    assert tm.shape == (3, IMG, IMG) and ts.shape == (3,)
    close_rel(tm, jm)
    close_rel(ts, js)
    names = ["gizmo", "widget", "gizmo"]
    tm, ts = tdet.predict_multi(imgs, names)
    jm, js = jdet.predict_multi(imgs, names)
    close_rel(tm, jm)
    close_rel(ts, js)


def _require(cond):
    assert cond


def _perturbed(seed):
    """Seeded adapters that differ from any initialization."""
    tt = bridged_trainable()
    gen = torch.Generator().manual_seed(seed)
    for t in tree_leaves(tt):
        t.add_(0.05 * torch.randn(t.shape, generator=gen))
    return tt


@pytest.mark.parametrize("stages", ["stage1+stage2", "stage2", "stage1"])
def test_from_checkpoint_restores_port_checkpoint(stack, tmp_path, stages):
    """A save_path as cli.train writes it: the restored adapters are the
    saved ones; the anchors come from the adapted text tower exactly when
    a stage-1 text adapter was saved; the maps are those of a detector
    built from the same tensors."""
    _, _, tpt, _ = stack
    save_path = str(tmp_path / "ckpt")
    text, full = _perturbed(1), _perturbed(2)
    if "stage1" in stages:
        ckpt.save_stage1(save_path, 1, text["text_adapter"], None)
    if "stage2" in stages:
        ckpt.save_stage2(save_path, 3, full, None)
    det = port_from_checkpoint(save_path, tpt)
    if "stage2" in stages:
        want = full
    else:         # the zero-shot adapters but for the restored text adapter
        want = dict(init_trainable(det.cfg, device="cpu", dtype=torch.float32),
                    text_adapter=text["text_adapter"])
    tree_map(lambda got, ref: _require(torch.equal(got, ref)), det.trainable, want)
    adapted = "stage1" in stages
    ref_det = AnomalyDetector(det.frozen, want, det.cfg, "Synth", img_size=IMG,
                              adapted_text=adapted, compute_dtype=torch.float32,
                              device="cpu")
    for c in CLASSES:
        assert torch.equal(det.anchors[c], ref_det.anchors[c])
    imgs = _images(2, 2)
    m, s = det.predict(imgs, "gizmo")
    rm, rs = ref_det.predict(imgs, "gizmo")
    np.testing.assert_array_equal(m, rm)
    np.testing.assert_array_equal(s, rs)


def test_predict_paths_matches_jax_and_predict(stack, data, tmp_path):
    """predict_paths decodes and resizes as the datasets do (one PNG here
    is 70 px and is resized bicubically), ships uint8 and normalizes on the
    device: bit for bit predict on the _load_image_u8 arrays and on the
    host-normalized floats, and the JAX package's predict_paths."""
    from PIL import Image

    tdet, jdet, _, _ = stack
    root, _ = data
    big = str(tmp_path / "big.png")
    Image.fromarray(np.random.default_rng(3).integers(
        0, 256, (70, 70, 3), dtype=np.uint8)).save(big)
    paths = image_paths(root) + [big]
    maps, scores = tdet.predict_paths(paths, "widget")
    assert maps.shape == (4, IMG, IMG) and scores.shape == (4,)
    u8 = np.stack([_load_image_u8(p, IMG) for p in paths])
    m8, s8 = tdet.predict(u8, "widget")
    np.testing.assert_array_equal(maps, m8)
    np.testing.assert_array_equal(scores, s8)
    floats = np.stack([normalize_clip(_load_image(p, IMG)) for p in paths]).astype(np.float32)
    mf, sf = tdet.predict(floats, "widget")
    np.testing.assert_array_equal(maps, mf)
    np.testing.assert_array_equal(scores, sf)
    jm, js = jdet.predict_paths(paths, "widget")
    close_rel(maps, jm)
    close_rel(scores, js)


# --------------------------------------------------------------------------
# MicroBatchingService
# --------------------------------------------------------------------------

def _normalized(seed, n):
    return np.random.default_rng(seed).standard_normal((n, 3, IMG, IMG)).astype(np.float32)


def test_micro_batching_service(stack):
    """Single-image submits coalesce; each future gets its own image's map
    and score; an unknown class fails through its future; a batch is
    refused at submit."""
    tdet = stack[0]
    images = _normalized(3, 5)
    ref_maps, ref_scores = tdet.predict(images, "widget")
    svc = MicroBatchingService(tdet, max_batch=4, max_latency_ms=50.0)
    try:
        futs = [svc.submit(images[i], "widget") for i in range(5)]
        for i, fut in enumerate(futs):
            amap, score = fut.result(timeout=TIMEOUT)
            assert amap.shape == (IMG, IMG)
            close_rel(amap, ref_maps[i])
            close_rel(score, ref_scores[i])
        bad = svc.submit(images[0], "nope")
        with pytest.raises(KeyError, match="unknown class"):
            bad.result(timeout=TIMEOUT)
        with pytest.raises(ValueError, match="one"):
            svc.submit(images, "widget")
    finally:
        svc.close()


def test_micro_batching_mixed_classes_one_dispatch(stack):
    """A mixed-class window goes through predict_multi as one device batch;
    the results equal per-class predict; an unknown class fails only its
    own future."""
    tdet = stack[0]
    calls = []
    orig = tdet.predict_multi

    class Counting:
        img_size = IMG

        def class_names(self):
            return tdet.class_names()

        def predict_multi(self, images, names):
            calls.append(list(names))
            return orig(images, names)

    svc = MicroBatchingService(Counting(), max_batch=8, max_latency_ms=200.0)
    images = _normalized(4, 4)
    names = ["widget", "gizmo", "widget", "gizmo"]
    try:
        futs = [svc.submit(images[i], names[i]) for i in range(4)]
        bad = svc.submit(images[0], "nope")
        results = [f.result(timeout=TIMEOUT) for f in futs]
        with pytest.raises(KeyError, match="unknown class"):
            bad.result(timeout=TIMEOUT)
    finally:
        svc.close()
    assert sum(len(c) for c in calls) == 4 and len(calls) < 4
    for i, name in enumerate(names):
        m_ref, s_ref = tdet.predict(images[i:i + 1], name)
        close_rel(results[i][0], m_ref[0])
        close_rel(results[i][1], s_ref[0])


class _StubDetector:
    """The single-class predict contract alone (no predict_multi): map =
    image mean + class offset."""

    def __init__(self, classes=("a", "b", "c"), delay=0.0, img_size=8):
        self.classes = {c: i for i, c in enumerate(classes)}
        self.delay = delay
        self.batch_sizes = []
        self.img_size = img_size

    def predict(self, images, class_name):
        if class_name not in self.classes:
            raise KeyError(f"unknown class {class_name!r}")
        if self.delay:
            time.sleep(self.delay)
        self.batch_sizes.append(images.shape[0])
        off = float(self.classes[class_name])
        return images.mean(axis=1) + off, images.mean(axis=(1, 2, 3)) + off


def test_micro_batching_stress(rng):
    """Concurrent submitters (more threads than cores, the interpreter
    switching threads often) over three classes through the per-class
    fallback: every future resolves to its own image's result, and windows
    coalesce."""
    import sys

    det = _StubDetector(delay=0.002)
    svc = MicroBatchingService(det, max_batch=16, max_latency_ms=20.0)
    images = rng.standard_normal((48, 3, 8, 8)).astype(np.float32)
    classes = ["a", "b", "c"]
    results = [None] * 48
    errors = []

    def submitter(lo, hi):
        try:
            futs = [(i, svc.submit(images[i], classes[i % 3])) for i in range(lo, hi)]
            for i, fut in futs:
                results[i] = fut.result(timeout=TIMEOUT)
        except Exception as exc:
            errors.append(exc)

    n_threads = max(8, 2 * (os.cpu_count() or 1))
    bounds = np.linspace(0, 48, n_threads + 1).astype(int)
    threads = [threading.Thread(target=submitter, args=(lo, hi))
               for lo, hi in zip(bounds[:-1], bounds[1:])]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=TIMEOUT)
    finally:
        sys.setswitchinterval(interval)
        svc.close()
    assert not any(t.is_alive() for t in threads) and not svc._worker.is_alive()
    assert not errors
    for i in range(48):
        amap, score = results[i]
        off = float(i % 3)
        np.testing.assert_allclose(amap, images[i].mean(axis=0) + off, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(score, images[i].mean() + off, rtol=1e-5, atol=1e-6)
    assert len(det.batch_sizes) < 48 and sum(det.batch_sizes) == 48


def test_micro_batching_submit_validates_shape(rng):
    """A malformed request fails its own caller at submit(), never the
    window it would have joined."""
    svc = MicroBatchingService(_StubDetector(), max_batch=8, max_latency_ms=50.0)
    try:
        with pytest.raises(ValueError, match=r"\(3, 8, 8\)"):
            svc.submit(np.zeros((3, 4, 4), np.float32), "a")
        with pytest.raises(ValueError, match=r"\(3, H, W\)"):
            svc.submit(np.zeros((3, 8, 8, 1), np.float32), "a")
        img = rng.standard_normal((3, 8, 8)).astype(np.float32)
        amap, _ = svc.submit(img, "a").result(timeout=TIMEOUT)
        np.testing.assert_allclose(amap, img.mean(axis=0), rtol=1e-5, atol=1e-6)
    finally:
        svc.close()


def test_micro_batching_cancelled_future_keeps_worker(rng):
    """A caller cancelling its pending future does not end the worker, on
    the result path and on the error path."""
    svc = MicroBatchingService(_StubDetector(), max_batch=8, max_latency_ms=500.0)
    images = rng.standard_normal((3, 3, 8, 8)).astype(np.float32)
    try:
        doomed = svc.submit(images[0], "a")
        assert doomed.cancel()
        doomed_cls = svc.submit(images[1], "nope")
        assert doomed_cls.cancel()
        amap, _ = svc.submit(images[2], "a").result(timeout=TIMEOUT)
        np.testing.assert_allclose(amap, images[2].mean(axis=0), rtol=1e-5, atol=1e-6)
        assert svc._worker.is_alive()
        assert doomed.cancelled() and doomed_cls.cancelled()
    finally:
        svc.close()


def test_micro_batching_close_semantics(rng):
    """close() in flight: the request in flight resolves; requests behind
    the stop sentinel fail with RuntimeError; submit() after close()
    raises; close() is idempotent."""
    svc = MicroBatchingService(_StubDetector(delay=0.05), max_batch=2, max_latency_ms=1.0)
    images = rng.standard_normal((4, 3, 8, 8)).astype(np.float32)
    first = svc.submit(images[0], "a")
    time.sleep(0.01)
    svc._closed = True
    svc._queue.put(svc._STOP)
    stragglers = [Future(), Future()]
    for i, fut in enumerate(stragglers):
        svc._queue.put((images[1 + i], "a", fut))
    svc.close()
    svc.close()
    amap, _ = first.result(timeout=TIMEOUT)
    np.testing.assert_allclose(amap, images[0].mean(axis=0), rtol=1e-5, atol=1e-6)
    for fut in stragglers:
        with pytest.raises(RuntimeError, match="closed"):
            fut.result(timeout=TIMEOUT)
    with pytest.raises(RuntimeError, match="closed"):
        svc.submit(images[3], "a")


def test_micro_batching_flush_error_settles_the_window(rng):
    """An error inside a device batch (a sticky CUDA error, say) fails every
    future of that window with it, and the worker serves the next window.
    The detector is called on the service's worker thread only."""
    threads = []

    class Failing:
        img_size = 8
        fail = True

        def class_names(self):
            return ["a", "b"]

        def predict_multi(self, images, names):
            threads.append(threading.current_thread())
            if self.fail:
                self.fail = False
                raise RuntimeError("CUDA error: an illegal memory access was encountered")
            return images.mean(axis=1), images.mean(axis=(1, 2, 3))

    svc = MicroBatchingService(Failing(), max_batch=8, max_latency_ms=200.0)
    images = rng.standard_normal((4, 3, 8, 8)).astype(np.float32)
    try:
        futs = [svc.submit(images[i], "ab"[i % 2]) for i in range(3)]
        for fut in futs:
            with pytest.raises(RuntimeError, match="illegal memory access"):
                fut.result(timeout=TIMEOUT)
        amap, _ = svc.submit(images[3], "a").result(timeout=TIMEOUT)
        np.testing.assert_allclose(amap, images[3].mean(axis=0), rtol=1e-5, atol=1e-6)
        assert threads and all(t is svc._worker for t in threads)
    finally:
        svc.close()


# --------------------------------------------------------------------------
# evaluation/visualize, bit for bit against the JAX package's
# --------------------------------------------------------------------------

def _mvtec_layout(tmp_path, rng, cv2):
    size, files, root = 24, [], str(tmp_path / "data")
    for damage, name in (("broken_large", "000.png"), ("good", "001.png")):
        rel = f"bottle/test/{damage}/{name}"
        p = os.path.join(root, rel)
        os.makedirs(os.path.dirname(p), exist_ok=True)
        cv2.imwrite(p, rng.integers(0, 256, (size, size, 3)).astype(np.uint8))
        files.append(rel)
    files.append("bottle/test/missing/002.png")     # unreadable: a blank panel
    labels = (rng.random((3, 1, size, size)) > 0.7).astype(np.float32)
    return root, files, labels, size


PRED_KINDS = ["random", "constant", "unit_max"]


@pytest.mark.parametrize("dataset", ["MVTec", "SomethingElse"])
@pytest.mark.parametrize("preds_kind", PRED_KINDS)
def test_dump_heatmaps_matches_jax(tmp_path, rng, dataset, preds_kind):
    cv2 = pytest.importorskip("cv2")
    from aa_clip_iqm_tpu.evaluation import visualize as jvis
    from aa_clip_iqm_tpu_torch.evaluation import visualize as tvis

    root, files, labels, size = _mvtec_layout(tmp_path, rng, cv2)
    preds = {"random": rng.random((3, size, size)).astype(np.float32),
             "constant": np.full((3, size, size), 0.5, np.float32),
             "unit_max": np.linspace(0, 1, 3 * size * size, dtype=np.float32)
             .reshape(3, size, size)}[preds_kind]
    for out, mod in (("t", tvis), ("j", jvis)):
        mod.dump_heatmaps(labels, preds, files, str(tmp_path / out), dataset, "bottle",
                          data_root=root)
    names = sorted(os.listdir(tmp_path / "j" / "visualization" / dataset / "bottle"))
    assert names == ["broken_large_000.png", "good_001.png", "missing_002.png"]
    assert sorted(os.listdir(tmp_path / "t" / "visualization" / dataset / "bottle")) == names
    for n in names:
        a, b = (open(tmp_path / d / "visualization" / dataset / "bottle" / n, "rb").read()
                for d in ("t", "j"))
        assert a == b, n


def test_overlays_match_jax(rng):
    pytest.importorskip("cv2")
    from aa_clip_iqm_tpu.evaluation import visualize as jvis
    from aa_clip_iqm_tpu_torch.evaluation import visualize as tvis

    image = rng.integers(0, 256, (32, 32, 3)).astype(np.uint8)
    scoremap = rng.integers(0, 256, (32, 32)).astype(np.uint8)
    np.testing.assert_array_equal(tvis.apply_ad_scoremap(image, scoremap),
                                  jvis.apply_ad_scoremap(image, scoremap))
    for amap in (rng.random((32, 32)).astype(np.float32) * 3 - 1,
                 np.full((32, 32), 0.5, np.float32)):
        np.testing.assert_array_equal(tvis.render_overlay(image, amap),
                                      jvis.render_overlay(image, amap))
