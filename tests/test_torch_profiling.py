"""The port's tracing and NaN checks on the CPU, against the JAX package:
``utils/profiling.trace`` writes a Chrome trace that the port's
``tools/trace_summary`` reads, with the ``step_annotation`` ranges in it;
the port's ``summarize`` equals the repo-root ``tools/trace_summary.py``'s on
the same events (exactly: the same sums in the same order); the ``--device``
view counts kernels (graph replays included) by group and a directory with
no trace fails; ``StepTimer`` keeps JAX's keys; ``enable_nan_checks`` and
``jax_debug_nans`` both raise ``FloatingPointError`` on the same planted
NaN, a clean stage-2 step passes the checks and one NaN pixel fails it; the
CLIs take ``--profile_dir``, ``--debug_nans``, ``--use_pallas`` and
``--no_pallas``, and a tiny ``cli.evaluate --profile_dir`` writes a trace."""
import gzip
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aa_clip_iqm_tpu import configs as jconfigs
from aa_clip_iqm_tpu.evaluation import predict as jpredict
from aa_clip_iqm_tpu.models import adapters as jadapters
from aa_clip_iqm_tpu.models import clip as jclip
from aa_clip_iqm_tpu.utils import profiling as jprofiling
from aa_clip_iqm_tpu_torch import configs as tconfigs
from aa_clip_iqm_tpu_torch.cli import evaluate as tcli_eval
from aa_clip_iqm_tpu_torch.cli import serve as tcli_serve
from aa_clip_iqm_tpu_torch.cli import single_image as tcli_single
from aa_clip_iqm_tpu_torch.cli import train as tcli_train
from aa_clip_iqm_tpu_torch.data import synthetic as tsynthetic
from aa_clip_iqm_tpu_torch.evaluation import predict as tpredict
from aa_clip_iqm_tpu_torch.models.convert import params_from_jax
from aa_clip_iqm_tpu_torch.tools import export_model as ttool_export
from aa_clip_iqm_tpu_torch.tools import trace_summary as tsummary
from aa_clip_iqm_tpu_torch.train import optim as toptim
from aa_clip_iqm_tpu_torch.train import steps as tsteps
from aa_clip_iqm_tpu_torch.utils import profiling as tprofiling

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
import trace_summary as jsummary  # noqa: E402  (the repo-root tool)

IMG = 56


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    torch.set_num_threads(1)


def test_trace_writes_what_the_summary_reads(tmp_path):
    with tprofiling.trace(None):                 # no directory: nothing is written
        torch.ones(2) + 1
    x = torch.randn(64, 64)
    with tprofiling.trace(str(tmp_path / "prof")):
        for i in range(2):
            with tprofiling.step_annotation(f"step_{i}"):
                x = torch.tanh(x @ x)
    assert os.listdir(tmp_path) == ["prof"]
    path = tsummary.find_trace(str(tmp_path))
    assert path.endswith(".pt.trace.json")
    events = tsummary.load_events(path)
    names = {e.get("name") for e in events}
    assert {"step_0", "step_1"} <= names
    per_track, totals = tsummary.summarize(events)
    steps = [t for t, ops in per_track.items() if "step_0" in ops]
    assert steps and all(totals[t] > 0 for t in steps)
    assert any(name.startswith("aten::mm") for t in steps for name in per_track[t])
    assert tsummary.main([str(tmp_path), "--top", "3"]) == 0


def _x(name, ts, dur, pid=1, tid=2, cat="cpu_op", **args):
    return {"ph": "X", "pid": pid, "tid": tid, "name": name, "ts": ts, "dur": dur,
            "cat": cat, "args": args}


EVENTS = [
    {"ph": "M", "pid": 1, "name": "process_name", "args": {"name": "host"}},
    {"ph": "M", "pid": 1, "tid": 2, "name": "thread_name", "args": {"name": "main"}},
    {"ph": "M", "pid": 0, "name": "process_name", "args": {"name": "GPU 0"}},
    {"ph": "M", "pid": 0, "tid": 7, "name": "thread_name", "args": {"name": "stream 7"}},
    _x("ProfilerStep#1", 0, 400),
    _x("aten::linear", 10, 100),
    _x("aten::addmm", 20, 60),
    _x("aten::gelu", 150, 30.5),
    _x("aten::linear", 300, 50),
    {"ph": "s", "id": 3, "pid": 1, "tid": 2, "ts": 25, "cat": "ac2g", "name": "ac2g"},
    {"ph": "f", "id": 3, "pid": 0, "tid": 7, "ts": 40, "cat": "ac2g", "name": "ac2g",
     "bp": "e"},
    {"ph": "i", "pid": 1, "tid": 2, "ts": 33, "name": "Iteration Start", "s": "t"},
    _x("cudaLaunchKernel", 22, 5, cat="cuda_runtime"),
    _x("cudaGraphLaunch", 200, 8, cat="cuda_runtime"),
    _x("void packed_attention_kernel<128>", 40, 120, pid=0, tid=7, cat="kernel"),
    _x("void ln_mlp_residual_gemm<256>", 170, 200.25, pid=0, tid=7, cat="kernel"),
    # Kernels a CUDA graph replayed: kernel events of their own.
    _x("void packed_attention_kernel<128>", 400, 118, pid=0, tid=7, cat="kernel",
       **{"graph id": 1, "graph node id": 4}),
    _x("void ln_mlp_residual_gemm<256>", 520, 199, pid=0, tid=7, cat="kernel",
       **{"graph id": 1, "graph node id": 5}),
    _x("nvjet_tst_128x256_64x4_1x2_h_bz_coopA_NNT", 720, 30, pid=0, tid=7, cat="kernel"),
    _x("Memcpy HtoD (Pageable -> Device)", 750, 9, pid=0, tid=7, cat="gpu_memcpy"),
    _x("void at::native::elementwise_kernel<128, 4>", 760, 3, pid=0, tid=7, cat="kernel"),
]


@pytest.mark.parametrize("track", [None, "main", "stream", "nomatch"])
def test_summarize_equals_the_repo_tool(track):
    got = tsummary.summarize(EVENTS, track)
    want = jsummary.summarize(EVENTS, track)
    assert {t: dict(ops) for t, ops in got[0].items()} == \
        {t: dict(ops) for t, ops in want[0].items()}
    assert dict(got[1]) == dict(want[1])
    if track is None:
        host = got[0]["host/main"]
        assert host["ProfilerStep#1"] == 400 - 100 - 30.5 - 50 - 8
        assert host["aten::linear"] == 100 - 60 + 50


def _write(tmp_path, events, name="host.123.pt.trace.json.gz"):
    d = tmp_path / "plugins" / "profile"
    d.mkdir(parents=True, exist_ok=True)
    with gzip.open(d / name, "wt") as f:
        json.dump({"traceEvents": events}, f)


def test_device_view_counts_kernels_by_group(tmp_path, capsys):
    groups = tsummary.device_summary(EVENTS)
    assert set(groups) == {"B1 packed_attention", "B2 ln_mlp_residual", "GEMM (cuBLAS)",
                           "other"}
    assert groups["B1 packed_attention"]["launches"] == 2          # eager + replayed
    assert groups["B1 packed_attention"]["ms"] == pytest.approx(0.238)
    assert groups["B2 ln_mlp_residual"]["launches"] == 2
    assert groups["B2 ln_mlp_residual"]["ms"] == pytest.approx(0.39925)
    assert groups["GEMM (cuBLAS)"]["launches"] == 1
    _write(tmp_path, EVENTS)
    assert tsummary.main([str(tmp_path), "--device"]) == 0
    out = capsys.readouterr().out
    assert "x2      B1 packed_attention" in out and "GEMM (cuBLAS)" in out
    want = {"packed_attention_kernel<128>": "B1", "flash_attention_fwd": "B7",
            "ln_attn_residual_x": "B8", "packed_attention_bwd<false>": "B4",
            "packed_attention_bwd<true>": "B6", "ln_mlp_residual_dx_k": "B5",
            "ln_mlp_residual_int8_gemm": "B3", "Memcpy DtoD": "memcpy",
            "gemm_s8_kernel<ln_mlp_residual_int8_probe_stage, 128>": "B9",
            "sm90_xmma_gemm": "GEMM", "triton_x": "other"}
    assert {n: tsummary.kernel_group(n).split()[0] for n in want} == want


def test_summary_fails_without_a_trace_or_kernels(tmp_path):
    with pytest.raises(SystemExit, match="no trace.json"):
        tsummary.main([str(tmp_path)])
    with pytest.raises(SystemExit, match="no trace.json"):
        jsummary.find_trace(str(tmp_path))
    _write(tmp_path, [e for e in EVENTS if e.get("cat") != "kernel"])
    with pytest.raises(SystemExit, match="no kernel events"):
        tsummary.main([str(tmp_path), "--device"])


def test_step_timer_keys_match_jax():
    timers = [tprofiling.StepTimer(), jprofiling.StepTimer()]
    assert [t.summary() for t in timers] == [{}, {}]
    for t in timers:
        for _ in range(3):
            t.start()
            t.stop()
    assert set(timers[0].summary()) == set(timers[1].summary())
    assert timers[0].summary()["steps"] == 3
    tprofiling.sync({"a": [torch.ones(2), (torch.zeros(1),)], "b": None})


@pytest.fixture(scope="module")
def tiny():
    cfg = jconfigs.tiny_test_config(IMG)
    frozen = jax.tree.map(np.asarray, jclip.init_clip_params(jax.random.PRNGKey(0), cfg.clip))
    trainable = jax.tree.map(np.asarray,
                             jadapters.init_adapter_params(jax.random.PRNGKey(1), cfg))
    tcfg = tconfigs.tiny_test_config(IMG)
    tf, tt = params_from_jax(frozen, trainable, tcfg, device="cpu", dtype=torch.float32)
    return cfg, frozen, trainable, tcfg, tf, tt


def _images(nan):
    rng = np.random.default_rng(8)
    images = rng.standard_normal((2, 3, IMG, IMG)).astype(np.float32)
    anchors = rng.standard_normal((2, 32, 2)).astype(np.float32)
    if nan:
        images[1, 2, 30, 17] = np.nan
    return images, anchors


@pytest.mark.parametrize("nan", [False, True], ids=["clean", "planted"])
def test_nan_checks_raise_where_jax_debug_nans_does(tiny, nan):
    cfg, frozen, trainable, tcfg, tf, tt = tiny
    images, anchors = _images(nan)
    # A jit of its own (not make_predict_fn's cached one), so that no call
    # made before debug_nans was on can have left a compiled fast path.
    jfn = jpredict.make_predict_fn.__wrapped__(cfg, IMG, "Industrial")
    tfn = tpredict.make_predict_fn(tcfg, IMG, "Industrial")
    raised = []
    jax.config.update("jax_debug_nans", True)
    tprofiling.enable_nan_checks(True)
    try:
        for run in (lambda: np.asarray(jfn(frozen, trainable, jnp.asarray(images),
                                           jnp.asarray(anchors))[0]),
                    lambda: tfn(tf, tt, torch.from_numpy(images),
                                torch.from_numpy(anchors))[0].numpy()):
            try:
                run()
                raised.append(False)
            except FloatingPointError:
                raised.append(True)
    finally:
        tprofiling.enable_nan_checks(False)
        jax.config.update("jax_debug_nans", False)
    assert raised == [nan, nan]
    assert not tprofiling.nan_checks_enabled() and not torch.is_anomaly_enabled()
    tfn(tf, tt, torch.from_numpy(images), torch.from_numpy(anchors))   # checks off again


def test_nan_checks_pass_a_clean_stage2_step_and_fail_a_nan_pixel(tiny):
    """Forward, backward and the optimizer under the checks."""
    _, _, _, tcfg, tf, _ = tiny
    from aa_clip_iqm_tpu_torch.loader import init_trainable

    trainable = init_trainable(tcfg, seed=1, device="cpu", dtype=torch.float32,
                               requires_grad=True)
    train_cfg = tconfigs.TrainConfig(img_size=IMG, compute_dtype="float32")
    opt = toptim.stage2_optimizer(trainable, train_cfg.image_lr, 10)
    step = tsteps.make_stage2_step(tcfg, train_cfg)
    rng = np.random.default_rng(9)
    masks = torch.from_numpy((rng.random((2, 1, IMG, IMG)) > 0.8).astype(np.float32))
    labels = torch.tensor([0, 1])
    weights = torch.ones(2)
    tprofiling.enable_nan_checks(True)
    try:
        for nan in (False, True):
            images, anchors = _images(nan)
            anchors /= np.linalg.norm(anchors, axis=1, keepdims=True)
            args = (trainable, opt, tf, torch.from_numpy(images), masks, labels,
                    torch.from_numpy(anchors), weights)
            if nan:
                with pytest.raises(FloatingPointError, match="NaN in the output of aten"):
                    step(*args)
            else:
                assert torch.isfinite(step(*args)[-1])
    finally:
        tprofiling.enable_nan_checks(False)


def test_cli_flags_parse():
    args = tcli_train.build_parser().parse_args(
        ["--use_pallas", "--profile_dir", "p", "--debug_nans"])
    assert (args.use_pallas, args.profile_dir, args.debug_nans) == (True, "p", True)
    args = tcli_eval.build_parser().parse_args(
        ["--use_pallas", "--profile_dir", "p", "--debug_nans"])
    assert (args.use_pallas, args.profile_dir, args.debug_nans) == (True, "p", True)
    assert tcli_single.build_parser().parse_args(
        ["--image_path", "a.png", "--use_pallas"]).use_pallas
    assert tcli_serve.build_parser().parse_args(["--no_pallas"]).no_pallas
    assert not tcli_serve.build_parser().parse_args([]).no_pallas
    assert ttool_export.build_parser().parse_args(
        ["--dataset", "MVTec", "--out", "x", "--no_pallas"]).no_pallas
    for parser in (tcli_train, tcli_eval):
        assert "always runs its kernels" in parser.build_parser().format_help()


def test_cli_evaluate_profile_dir_writes_a_trace(tmp_path, capsys, monkeypatch):
    """--profile_dir writes a trace of the sweep; --debug_nans turns the
    checks on around it and off again, and a clean sweep passes them."""
    calls = []

    def spy(enable):
        calls.append(enable)
        tprofiling.enable_nan_checks(enable)

    monkeypatch.setattr(tcli_eval, "enable_nan_checks", spy)
    root = str(tmp_path / "synth")
    classes = ("widget", "gadget")
    tsynthetic.generate(root, n_normal=2, n_anomalous=2, size=IMG, class_names=classes,
                        seed=3)
    meta_root = tsynthetic.register_synthetic(root, classes)
    prof = str(tmp_path / "prof")
    rows = tcli_eval.main(["--model_name", "tiny-test", "--img_size", str(IMG),
                           "--dataset", "Synth", "--random_backbone", "--no_adapters",
                           "--device", "cpu", "--image_batch_size", "4",
                           "--metadata_root", meta_root, "--compute_dtype", "float32",
                           "--save_path", str(tmp_path / "out"), "--profile_dir", prof,
                           "--use_pallas", "--debug_nans"])
    assert rows[-1]["class name"] == "Average"
    assert calls == [True, False] and not tprofiling.nan_checks_enabled()
    events = tsummary.load_events(tsummary.find_trace(prof))
    per_track, _ = tsummary.summarize(events)
    assert any("aten::" in name for ops in per_track.values() for name in ops)
    capsys.readouterr()
