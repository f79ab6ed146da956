"""The readers of the program's own spans and counters
(``benchmark/metrics/_program.py`` and the metrics on it) and
``benchmark/tools/spans.py``, on hand-built traces and a rehearsal on the
CPU: the program's spans beside a trace change no reading that was there;
the interval helpers count nested and overlapping spans once and meet the
idle gaps by interval; each reader reads nothing where the program keeps no
counters or the window ran nothing on the device."""
import json
import os
from types import SimpleNamespace

import pytest

from benchmark import harness, inputs
from benchmark.metrics import _program
from benchmark.tests.test_bench_harness import SMALL
from benchmark.tests.tiny import tiny_config
from benchmark.trace import Trace

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
P = _program.PROGRAM_PREFIX

# A window of 0-100 us: the device busy at 10-30, 40-60 and 70-80.
DEVICE = [("void aaclip::attention_fwd_kernel<128, packed_attention>", 10, 20),
          ("void aaclip::gemm_kernel<ln_mlp_residual_stage>", 20, 30),
          ("Memcpy HtoD (Pageable -> Device)", 40, 45),
          ("aaclip::attention_bwd<false>", 45, 50),
          ("void aaclip::gemm_kernel<ln_mlp_residual_dx_stage>", 50, 55),
          ("Memcpy DtoH (Device -> Pageable)", 55, 60),
          ("void at::native::elementwise_kernel<128, 4>", 70, 80)]
HARNESS = [("bench/predict_multi", 5, 65), ("bench/step", 66, 95)]
# Nested and overlapping program spans; the copy-in span straddles the gap
# at 30-40, and the two "predict" spans overlap at 35-38.
PROGRAM = [(P + "predict", 5, 38), (P + "predict", 35, 64),
           (P + "predict/stage", 6, 12), (P + "predict/copy_in", 25, 45),
           (P + "predict/replay", 45, 55), (P + "predict/copy_out", 55, 64),
           (P + "step", 66, 95), (P + "step/replay", 66, 90)]


def _trace():
    return Trace(DEVICE, HARNESS, (0, 100))


def _ctx(trace, cell="offline-518-b32"):
    return SimpleNamespace(trace=trace, config=inputs.load_json("configs", "vitl14-336-518"),
                           work={"images": 64, "calls": 2, "batch": 32, "seconds": 1e-4},
                           counters={"answered": 6, "replays": 2}, workload={},
                           cell={"name": cell})


def _old_metrics():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    new = {"predict.copy_gbps", "setup.anchors_s", "setup.capture_s"}
    names = [m["name"] for m in bench["per_layer"] if m["name"] not in new]
    return names + ["serve.requests_per_batch", "device_idle.serve"]


def _readings(trace):
    ctx = _ctx(trace)
    return ({n: harness.load_module("metrics", n).read(ctx) for n in _old_metrics()},
            trace.spans, trace.busy, trace.busy_s, trace.window_s, trace.idle_gaps(),
            trace.breakdown(), trace.groups(), trace.ops(),
            trace.seconds_matching([r"memcpy"]))


def test_program_spans_change_no_old_reading():
    plain, with_spans = _trace(), _trace()
    with_spans.program_spans = PROGRAM
    before = _readings(plain)
    assert _readings(with_spans) == before
    assert any(v is not None for v in before[0].values())


def test_union_and_overlap_count_each_instant_once():
    spans = _program.spans_named(PROGRAM, "predict")
    assert spans == [[5, 64]]                       # two overlapping spans, one union
    assert _program.union([(0, 2), (1, 3), (5, 6), (6, 7)]) == [[0, 3], [5, 7]]
    assert _program.idle_gaps(_trace()) == [(0, 10), (30, 40), (60, 70), (80, 100)]
    # Idle under predict: 5-10, 30-40 (inside the union), 60-64.
    assert _program.overlap(_program.idle_gaps(_trace()), spans) == 5 + 10 + 4
    # The copy-in span straddles the gap 30-40 on both sides: 10 us of it.
    copy_in = _program.spans_named(PROGRAM, "predict/copy_in")
    assert _program.overlap(_program.idle_gaps(_trace()), copy_in) == 10
    assert _program.overlap([(0, 10)], [(10, 20)]) == 0


def test_host_idle_readers_read_the_union():
    tr = _trace()
    ctx = _ctx(tr)
    read = {n: harness.load_module("metrics", n).read for n in
            ("predict.host_idle", "step.host_idle")}
    assert read["predict.host_idle"](ctx) is None       # no program spans given
    tr.program_spans = PROGRAM
    assert read["predict.host_idle"](ctx) == pytest.approx(19.0)
    # Idle under step: 66-70 and 80-95.
    assert read["step.host_idle"](ctx) == pytest.approx(19.0)
    idle_total = 100.0 - tr.busy_s / tr.window_s * 100.0
    assert read["predict.host_idle"](ctx) <= idle_total
    tr.device = []                                      # no device: nothing to read
    assert read["predict.host_idle"](ctx) is None


def _registry(monkeypatch, values):
    from aa_clip_iqm_tpu_torch.utils import profiling

    if values is None:
        monkeypatch.delattr(profiling, "counters")
    else:
        monkeypatch.setattr(profiling, "counters", lambda: dict(values))


def test_copy_rate_and_set_up_readers(monkeypatch):
    counters = {"predict.calls": 4, "predict.bytes_in": 4000, "predict.bytes_out": 8000,
                "setup.anchors_s": 1.5, "graphs.capture_s": 2.25}
    _registry(monkeypatch, counters)
    ctx = _ctx(_trace())
    read = {n: harness.load_module("metrics", n).read for n in
            ("predict.copy_gbps", "setup.anchors_s", "setup.capture_s")}
    # 3000 bytes a call x 2 calls over the copies' 10 us.
    assert read["predict.copy_gbps"](ctx) == pytest.approx(6000 / 10e-6 / 1e9)
    assert read["setup.anchors_s"](ctx) == 1.5 and read["setup.capture_s"](ctx) == 2.25
    _registry(monkeypatch, {})
    assert all(r(ctx) is None for r in read.values())
    _registry(monkeypatch, counters)
    ctx.trace.device = []
    assert all(r(ctx) is None for r in read.values())


def test_readers_read_nothing_from_a_program_without_counters(monkeypatch):
    _registry(monkeypatch, None)
    ctx = _ctx(_trace())
    for n in ("predict.copy_gbps", "setup.anchors_s", "setup.capture_s"):
        assert harness.load_module("metrics", n).read(ctx) is None


def test_spans_tool_rehearses_on_the_cpu(capsys):
    """The tool's window on the CPU at the tiny size: the detector's stage
    spans in the host's seconds, the window's counters, no capture or
    build in the window, no program range among the device's operations."""
    import torch

    from benchmark.tools import spans

    wl = dict(inputs.load_json("workloads", "offline-518-b32"), **SMALL)
    out = spans.main(["--workload", "offline-518-b32", "--seed", str(2 ** 31 + 5),
                      "--seconds", "0.3"], device=torch.device("cpu"),
                     config=tiny_config(), workload=wl)
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == out
    assert {"predict", "predict/stage", "predict/copy_in", "predict/run",
            "predict/copy_out"} <= set(out["host_s"])
    assert out["host_s"]["predict"] <= out["window_s"] + 1e-6
    calls = out["window_counters"]["predict.calls"]
    assert calls >= 1 and out["window_counters"]["predict.rows"] == 2 * calls
    assert not {"kernels.builds", "graphs.captures"} & set(out["window_counters"])
    assert out["ranges_as_ops"] == []
    # On the CPU the new readers read nothing (no device operation).
    assert not set(out["metrics"]) & {"predict.copy_gbps", "setup.anchors_s", "setup.capture_s",
                                      "predict.host_idle", "step.host_idle"}
    assert out["setup_counters"]["setup.anchors_s"] > 0
