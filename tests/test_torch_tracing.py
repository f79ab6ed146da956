"""The port's spans and counters (``utils/profiling.span``, ``count``,
``counters``).

On the CPU (tiny_test_config(56), float32): with no profiler running a span
never reaches ``record_function``; under ``torch.profiler`` a
``predict_multi`` gives ``aaclip/predict`` with its four stage children
inside it, and a captured step (the CUDA calls stood in for, as in
tests/test_torch_train_graphs.py) gives ``aaclip/step`` with its children;
the detector counts its device batches, rows, padding and host<->device
bytes, each bucket of a split call once; building a detector adds to
``setup.anchors_s``; the kernels' build and load, the micro-batcher and the
registry itself count as documented; a CPU detector returns ordinary
arrays and copies nothing into page-locked memory; every counter the
package keeps is named in ``utils/profiling``'s list.

Marked ``cuda`` (skipped without a card): under the profiler each replayed
``GraphedStep`` call and each replayed predict gives its spans, no
``aaclip/`` range is a device operation, and the maps' copy to the host
runs inside ``aaclip/predict/copy_out``. On a machine with a card:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_tracing.py -q
"""
import pathlib
import re
import threading
import time
from concurrent.futures import Future
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from aa_clip_iqm_tpu_torch import configs as tconfigs
from aa_clip_iqm_tpu_torch.loader import init_trainable, random_backbone
from aa_clip_iqm_tpu_torch.ops import _build
from aa_clip_iqm_tpu_torch.serving import AnomalyDetector, MicroBatchingService
from aa_clip_iqm_tpu_torch.train import graphs
from aa_clip_iqm_tpu_torch.utils import profiling

IMG = 56
STAGES = ("predict/stage", "predict/copy_in", "predict/run", "predict/copy_out")


@pytest.fixture(autouse=True)
def fresh_counters():
    profiling.reset_counters()
    yield
    profiling.reset_counters()


@pytest.fixture(scope="module")
def det():
    torch.set_num_threads(1)
    cfg = tconfigs.tiny_test_config(IMG)
    frozen = random_backbone(cfg, seed=0, device="cpu", dtype=torch.float32)
    trainable = init_trainable(cfg, seed=1, device="cpu", dtype=torch.float32)
    return AnomalyDetector(frozen, trainable, cfg, "MVTec", img_size=IMG,
                           compute_dtype=torch.float32, batch_buckets=(1, 8),
                           device="cpu")


def _u8(n, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (n, 3, IMG, IMG), np.uint8)


def _host_spans(prof):
    """[(name without the prefix, start, end)] of the program's host ranges."""
    return sorted(((e.name[len(profiling.SPAN_PREFIX):], e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == DeviceType.CPU
                   and e.name.startswith(profiling.SPAN_PREFIX)), key=lambda s: s[1])


def _inside(child, parent):
    return parent[1] <= child[1] and child[2] <= parent[2]


def test_span_without_a_profiler_never_records(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with no profiler running")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    with profiling.span("predict"), profiling.span("predict/stage"):
        pass
    assert profiling.span("a") is profiling.span("b")      # one shared null context


def test_predict_multi_spans_nest_under_the_profiler(det):
    names = det.class_names()[:3]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        det.predict_multi(_u8(3), names)
    spans = _host_spans(prof)
    parents = [s for s in spans if s[0] == "predict"]
    assert len(parents) == 1
    children = [s for s in spans if s[0].startswith("predict/")]
    assert sorted(s[0] for s in children) == sorted(STAGES + ("predict/stage",))
    assert all(_inside(c, parents[0]) for c in children)
    # The stages run in order and do not overlap one another.
    order = [s[0] for s in children]
    assert order == ["predict/stage"] * 2 + list(STAGES[1:])
    assert all(a[2] <= b[1] for a, b in zip(children, children[1:]))


def test_a_padded_call_counts_rows_padding_and_bytes(det):
    images = _u8(3)
    maps, scores = det.predict(images, det.class_names()[0])
    c = profiling.counters()
    assert (c["predict.calls"], c["predict.rows"], c["predict.padded_rows"]) == (1, 3, 5)
    assert c["predict.bytes_in"] == 8 * images[0].nbytes          # the padded bucket
    assert c["predict.bytes_out"] == maps.nbytes + scores.nbytes   # the rows returned
    assert maps.shape == (3, IMG, IMG)


def test_a_split_call_counts_each_bucket_once(det):
    images = _u8(10, seed=1)
    names = [det.class_names()[i % 4] for i in range(10)]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        maps, scores = det.predict_multi(images, names)
    c = profiling.counters()
    # 8 rows in bucket 8, then 2 rows padded to 8.
    assert (c["predict.calls"], c["predict.rows"], c["predict.padded_rows"]) == (2, 10, 6)
    assert c["predict.bytes_in"] == 16 * images[0].nbytes
    assert c["predict.bytes_out"] == maps.nbytes + scores.nbytes
    spans = _host_spans(prof)
    assert [s[0] for s in spans].count("predict") == 1
    assert [s[0] for s in spans].count("predict/run") == 2
    # Each row still gets its own class: the split equals two calls.
    m1, s1 = det.predict_multi(images[:8], names[:8])
    m2, s2 = det.predict_multi(images[8:], names[8:])
    np.testing.assert_array_equal(maps, np.concatenate([m1, m2]))
    np.testing.assert_array_equal(scores, np.concatenate([s1, s2]))


def test_a_cpu_detector_copies_out_into_ordinary_arrays(det):
    """The eager CPU path returns plain float32 arrays, and the page-locked
    copy-out of the graphed path neither runs nor counts."""
    maps, scores = det.predict_multi(_u8(3, seed=2), det.class_names()[:3])
    for a in (maps, scores):
        assert isinstance(a, np.ndarray) and a.dtype == np.float32
        base = a
        while isinstance(base, np.ndarray):
            base = base.base
        assert base is None or not base.is_pinned()
    c = profiling.counters()
    assert c["predict.calls"] == 1
    assert c.get("predict.copy_out_pinned", 0) == 0
    assert c.get("predict.pinned_allocs", 0) == 0


_PACKAGE = pathlib.Path(profiling.__file__).resolve().parents[1]
_COUNTED = sorted({m for f in _PACKAGE.rglob("*.py")
                   for m in re.findall(r"\b(?:count|timed)\(\"([a-z0-9_.]+)\"",
                                       f.read_text())})


@pytest.mark.parametrize("name", _COUNTED)
def test_profiling_lists_every_counter_the_package_keeps(name):
    assert f"``{name}``" in profiling.__doc__


def test_the_pinned_copy_out_counters_are_kept_and_listed():
    for name in ("predict.copy_out_pinned", "predict.pinned_allocs"):
        assert name in _COUNTED


def test_building_a_detector_adds_to_setup_anchors_s(det):
    AnomalyDetector(det.frozen, det.trainable, det.cfg, "MVTec", img_size=IMG,
                    compute_dtype=torch.float32, batch_buckets=(1,), device="cpu")
    first = profiling.counters()["setup.anchors_s"]
    assert first > 0
    AnomalyDetector(det.frozen, det.trainable, det.cfg, "MVTec", img_size=IMG,
                    compute_dtype=torch.float32, batch_buckets=(1,), device="cpu")
    assert profiling.counters()["setup.anchors_s"] > first
    assert "graphs.captures" not in profiling.counters()         # the CPU runs eagerly


def test_reset_counters_empties_the_registry():
    profiling.count("a")
    profiling.count("b", 2.5)
    with profiling.timed("c"):
        pass
    snap = profiling.counters()
    assert snap["a"] == 1 and snap["b"] == 2.5 and snap["c"] >= 0
    snap["a"] = 99                                   # a snapshot, not the registry
    assert profiling.counters()["a"] == 1
    profiling.reset_counters()
    assert profiling.counters() == {}


def test_counters_are_exact_under_threads():
    def add():
        for _ in range(2000):
            profiling.count("n")
            profiling.count("x", 0.5)

    threads = [threading.Thread(target=add) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert profiling.counters() == {"n": 16000, "x": 8000.0}


def test_kernel_builds_and_loads_are_counted(monkeypatch):
    """One nvcc run for a stale library, none for an up-to-date one; a
    library loads once, under ``setup/kernels``."""
    started = []
    monkeypatch.setattr(_build, "_stale", lambda name: name == "stale")
    monkeypatch.setattr(_build, "_start", lambda name: started.append(name) or name)
    monkeypatch.setattr(_build, "_finish", lambda name, proc: None)
    _build.build(["fresh"])
    assert "kernels.builds" not in profiling.counters()
    _build.build(["stale", "fresh"])
    c = profiling.counters()
    assert started == ["stale"] and c["kernels.builds"] == 1 and c["kernels.build_s"] >= 0

    lib = SimpleNamespace(aaclip_k_error_string=SimpleNamespace())
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: lib)
    monkeypatch.delitem(_build._LIBS, "k", raising=False)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert _build.load("k") is lib
        assert _build.load("k") is lib
    _build._LIBS.pop("k")
    assert profiling.counters()["kernels.loads"] == 1
    # One range: the build's, nested under the same name, is merged into the
    # load's by the profiler, and the second load is a lookup.
    assert [s[0] for s in _host_spans(prof)] == ["setup/kernels"]


class _Stub:
    img_size = 8

    def class_names(self):
        return ["a", "b"]

    def predict_multi(self, images, names):
        time.sleep(0.01)
        return images.mean(axis=1), images.reshape(len(images), -1).mean(axis=1)


def test_micro_batcher_counts_requests_batches_and_queue_wait():
    """The counters from the worker thread; the span where a profiler runs
    on the dispatching thread (torch.profiler records the host ranges of
    the thread that started it)."""
    svc = MicroBatchingService(_Stub(), max_batch=4, max_latency_ms=20.0)
    try:
        futs = [svc.submit(np.full((3, 8, 8), i, np.float32), "a") for i in range(4)]
        results = [f.result(timeout=60) for f in futs]
        c = profiling.counters()
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            svc._flush([(np.zeros((3, 8, 8), np.float32), "b", Future(), time.perf_counter())])
    finally:
        svc.close()
    assert [float(s) for _, s in results] == [0.0, 1.0, 2.0, 3.0]
    assert c["serve.requests"] == 4 and 1 <= c["serve.batches"] <= 4
    assert c["serve.queue_wait_s"] > 0
    assert [s[0] for s in _host_spans(prof)] == ["serve/dispatch"]
    assert profiling.counters()["serve.requests"] == 5


class _FakeOpt:
    """A graphable optimizer's surface, as ``GraphedStep`` uses it."""
    graphable, version = True, 0

    def __init__(self):
        self.optimizer = SimpleNamespace(state={})
        self.advanced = 0

    def advance(self):
        self.advanced += 1


class _FakeStep:
    @staticmethod
    def update(params, opt_state, frozen, x):
        return (params["w"] * x).sum()


def test_graphed_step_spans_on_stand_ins(monkeypatch):
    """The step's spans and counters on the CPU, the CUDA calls stood in
    for: the first call captures under ``step/prepare``, the second copies
    its batch in; each gives ``aaclip/step`` with its children inside."""
    from test_torch_train_graphs import _FakeCuda

    _FakeCuda.install(monkeypatch)
    step = graphs.GraphedStep(_FakeStep(), graphs.GraphCache())
    params, opt, frozen = {"w": torch.ones(3)}, _FakeOpt(), {}
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for i in range(2):
            step(params, opt, frozen, torch.full((3,), float(i)))
    spans = _host_spans(prof)
    steps_ = [s for s in spans if s[0] == "step"]
    assert len(steps_) == 2 and opt.advanced == 2
    for k, parent in enumerate(steps_):
        kids = [s[0] for s in spans if s[0] != "step" and _inside(s, parent)]
        want = ["step/prepare", "capture", "step/replay", "step/advance"] if k == 0 else \
            ["step/prepare", "step/copy_in", "step/replay", "step/advance"]
        assert kids == want
    c = profiling.counters()
    assert c["step.calls"] == 2 and c["graphs.captures"] == 1 and c["graphs.capture_s"] >= 0


# --------------------------------------------------------------------------
# On the card
# --------------------------------------------------------------------------

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _device_annotations_only(prof):
    """No ``aaclip/`` range among the device's operations: where the
    profiler mirrors one on the device's timeline it is a user annotation."""
    mirrored = [e for e in prof.events() if e.device_type == DeviceType.CUDA
                and e.name.startswith(profiling.SPAN_PREFIX)]
    assert all(getattr(e, "is_user_annotation", False) for e in mirrored), \
        [e.name for e in mirrored if not getattr(e, "is_user_annotation", False)]


def _overlap(ops, spans):
    """Seconds of ``ops`` (start, end) inside the union of ``spans``."""
    total = 0.0
    for s, e in ops:
        for _, a, b in spans:
            total += max(0.0, min(e, b) - max(s, a))
    return total


@pytest.mark.cuda
def test_replayed_steps_give_their_spans_on_the_card(dev):
    from test_torch_train_graphs import CARD_IMG, _run_stage2, _small_model

    cfg, frozen = _small_model(dev, torch.bfloat16, img=CARD_IMG, heads64=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step, _, _, _ = _run_stage2(cfg, frozen, dev, {}, True, n_steps=3)
    spans = _host_spans(prof)
    steps_ = [s for s in spans if s[0] == "step"]
    assert len(steps_) == 3 and [c.replays for c in step.graphs.values()] == [3]
    for k, parent in enumerate(steps_):
        kids = {s[0] for s in spans if s[0].startswith("step/") and _inside(s, parent)}
        assert kids == {"step/prepare", "step/replay", "step/advance"} | (
            {"step/copy_in"} if k else set())
    _device_annotations_only(prof)


@pytest.mark.cuda
def test_replayed_predicts_copy_out_inside_their_span_on_the_card(dev):
    cfg = tconfigs.tiny_test_config(IMG)
    frozen = random_backbone(cfg, seed=0, device=dev, dtype=torch.float32)
    trainable = init_trainable(cfg, seed=1, device=dev, dtype=torch.float32)
    d = AnomalyDetector(frozen, trainable, cfg, "MVTec", img_size=IMG,
                        compute_dtype=torch.float32, batch_buckets=(8,), device=dev,
                        use_pallas=False)
    names = d.class_names()[:8]
    d.predict_multi(_u8(8), names)                 # the capture
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(3):
            d.predict_multi(_u8(8, seed=i), names)
    spans = _host_spans(prof)
    assert [s[0] for s in spans].count("predict/replay") == 3
    assert "capture" not in [s[0] for s in spans]
    _device_annotations_only(prof)
    dtoh = [(e.time_range.start, e.time_range.end) for e in prof.events()
            if e.device_type == DeviceType.CUDA and "Memcpy DtoH" in e.name]
    assert dtoh
    copy_out = [s for s in spans if s[0] == "predict/copy_out"]
    assert _overlap(dtoh, copy_out) >= 0.95 * sum(e - s for s, e in dtoh)
