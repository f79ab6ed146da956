"""The EVA02-CLIP cell's pieces on the CPU: ``flops_eva02`` against hand
counts, the new metrics' readers on a made-up trace, the EVA-02 reference
against the program at the tiny size (``configs.tiny_eva02_config``,
float32) through ``drivers/offline_eva02.py``, and the driver's comparison
with the timed path broken (an answer altered, the rotation dropped) and
with the float8 control, each of which must read not correct."""
import contextlib
from types import SimpleNamespace

import pytest
import torch

from benchmark import flops, flops_eva02, inputs
from benchmark.harness import load_module
from benchmark.reference import eva02
from benchmark.reference import model as ref
from benchmark.tests.tiny import tiny_run
from benchmark.trace import Trace

OFFLINE = {"batch": 2, "pool": 2, "sample": 3, "reference_chunk": 2, "reference_head_chunk": 1,
           "limits": {"anchor_err": 1e-5, "map_rel_rms": 1e-4, "score_abs": 1e-5}}
TINY = {"model_name": "tiny-eva02-test",
        "vision": {"width": 64, "layers": 4, "head_width": 16, "mlp_ratio": 2.6667,
                   "rope_ref_grid": 3}}


def cfg(size=518):
    c = inputs.load_json("configs", "eva02-clip-l14-336-518")
    c["img_size"] = size
    return c


def test_block_and_image_against_hand_counts():
    n, d, h = 1370, 1024, 2730
    assert flops_eva02.hidden(cfg()) == h == cfg()["vision"]["mlp_hidden"]
    block = flops_eva02.block_forward(n, d, h)
    assert block == 2 * n * 4 * d * d + 4 * n * n * d + 2 * n * 3 * d * h
    assert abs(block / 42.16e9 - 1) < 0.001
    # The same work as ViT-L's block: 12 d^2 against 4 d^2 + 3 d h.
    vitl = flops.block_forward(n, d)
    assert abs(block / vitl - 1) < 0.001
    assert abs(24 * block / 1.01e12 - 1) < 0.01
    image = flops_eva02.infer_image(cfg())
    assert 24 * block < image < 1.06 * 24 * block
    vitl_cfg = inputs.load_json("configs", "vitl14-336-518")
    assert abs(image / flops.infer_image(vitl_cfg) - 1) < 0.001


def test_kernel_counts():
    ops, nbytes = flops_eva02.swiglu_fwd(32, 1370, 1024, 2730)
    m = 32 * 1370
    assert ops == 6 * m * 1024 * 2730
    assert nbytes == (2 * m * 1024 + 3 * 1024 * 2730 + 2 * m * 2730) * 2
    assert flops.bound_s(ops, nbytes) == ops / flops.PEAK_BF16       # bound by operations
    ops, nbytes = flops_eva02.rope_fwd(32, 1370, 1024)
    assert ops == 3 * 32 * 1369 * 2048
    assert nbytes == 32 * 1369 * 2048 * 4 + 2 * 1369 * 64 * 4
    assert flops.bound_s(ops, nbytes) == nbytes / flops.PEAK_BYTES   # bound by bytes


def _trace(names_seconds):
    events, at = [], 0.0
    for name, sec in names_seconds:
        events.append((name, at, at + sec * 1e6))
        at += sec * 1e6
    return Trace(events, [], (0.0, at + 1e6))


def test_readers_on_a_made_up_trace():
    swiglu = ("void (anonymous namespace)::swiglu_dual_kernel<(anonymous "
              "namespace)::ln_swiglu_residual_stage>(CUtensorMap, CUtensorMap, int)")
    b2 = ("void aaclip::gemm90::(anonymous namespace)::gemm_bias_act_kernel<(anonymous "
          "namespace)::ln_mlp_residual_stage, 256, 1>(int)")
    rope = "(anonymous namespace)::rope_qk_kernel(__nv_bfloat16*, float const*, int)"
    c = cfg()
    work = {"images": 64, "calls": 2, "batch": 32, "seconds": 1.0}
    ctx = SimpleNamespace(trace=_trace([(swiglu, 0.05), (b2, 0.01), (rope, 0.02)]), work=work,
                          config=c, counters={})
    ops, nbytes = flops_eva02.swiglu_fwd(32, 1370, 1024, 2730)
    got = load_module("metrics", "swiglu_fwd_roofline").read(ctx)
    assert got == pytest.approx(100.0 * 48 * flops.bound_s(ops, nbytes) / 0.05)
    ops, nbytes = flops_eva02.rope_fwd(32, 1370, 1024)
    got = load_module("metrics", "rope_roofline").read(ctx)
    assert got == pytest.approx(100.0 * 48 * flops.bound_s(ops, nbytes) / 0.02)
    got = load_module("metrics", "mfu.infer.eva02").read(ctx)
    assert got == pytest.approx(100.0 * flops_eva02.infer_image(c) * 64
                                / (ctx.trace.window_s * flops.PEAK_BF16))
    # B2 alone, or a program without the kernels, reads nothing.
    ctx.trace = _trace([(b2, 0.01)])
    assert load_module("metrics", "swiglu_fwd_roofline").read(ctx) is None
    assert load_module("metrics", "rope_roofline").read(ctx) is None


def test_fused_share_reads_the_counters(monkeypatch):
    from aa_clip_iqm_tpu_torch.utils import profiling

    read = load_module("metrics", "mlp.swiglu_fused_share").read
    ctx = SimpleNamespace(trace=_trace([("k", 0.01)]))
    monkeypatch.setattr(profiling, "counters", lambda: {"mlp.swiglu_fused": 72})
    assert read(ctx) == 100.0
    monkeypatch.setattr(profiling, "counters",
                        lambda: {"mlp.swiglu_fused": 48, "mlp.swiglu_chain": 16})
    assert read(ctx) == 75.0
    monkeypatch.setattr(profiling, "counters", lambda: {"predict.calls": 3})
    assert read(ctx) is None
    ctx.trace = Trace([], [], (0.0, 1.0))                 # a CPU rehearsal: nothing
    assert read(ctx) is None


def correct(driver):
    driver.setup()
    driver.window(0.0)
    driver.window(0.0)
    driver.release()
    checks = driver.check()
    return all(v <= lim for _, v, lim in checks), checks


def run(**workload):
    return tiny_run("offline_eva02", dict(OFFLINE, **workload), **TINY)


def test_sound_run_is_correct_and_the_reference_matches():
    ok, checks = correct(run())
    assert ok, checks
    assert ref.vision is not eva02.vision       # the swap lasts the comparison alone


def test_answer_altered_reads_not_correct(monkeypatch):
    from aa_clip_iqm_tpu_torch.serving import AnomalyDetector

    real = AnomalyDetector.predict_multi

    def altered(self, images, names):
        maps, scores = real(self, images, names)
        return maps[::-1].copy(), scores
    monkeypatch.setattr(AnomalyDetector, "predict_multi", altered)
    ok, checks = correct(run())
    assert not ok, checks


def test_rotation_dropped_reads_not_correct(monkeypatch):
    from aa_clip_iqm_tpu_torch.models import clip

    monkeypatch.setattr(clip, "rope_qk", lambda qkv, table, num_heads: qkv)
    ok, checks = correct(run())
    assert not ok, checks
    assert dict((n, v) for n, v, _ in checks)["anchor_err"] <= 1e-5   # the text tower is sound


def test_fp8_control_reads_not_correct():
    ok, checks = correct(run(control="fp8_reference"))
    assert not ok, checks
    values = dict((n, v) for n, v, _ in checks)
    assert values["map_rel_rms"] > 1e-4 and values["anchor_err"] <= 1e-5


def test_reference_tower_is_swapped_back_after_a_failure():
    with contextlib.suppress(RuntimeError):
        with eva02.in_clips_place():
            assert ref.vision is eva02.vision
            raise RuntimeError
    assert ref.vision is not eva02.vision
