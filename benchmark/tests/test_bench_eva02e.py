"""The EVA02-CLIP-E/14+ cell's pieces on the CPU: ``flops_eva02e`` against
hand counts, the new metrics' readers on a made-up trace, the post-norm
reference against the program at the tiny size
(``configs.tiny_eva_postnorm_config``, float32) through
``drivers/offline_eva02e.py``, and the driver's comparison with the timed
path broken (the heads scaled by 64^-0.5 where they take head_width^-0.5)
and with the float8 control, each of which must read not correct."""
from types import SimpleNamespace

import pytest

from benchmark import flops, flops_eva02e, inputs
from benchmark.harness import load_module
from benchmark.reference import eva02e
from benchmark.reference import model as ref
from benchmark.tests.tiny import tiny_run
from benchmark.trace import Trace

OFFLINE = {"batch": 2, "pool": 2, "sample": 3, "reference_chunk": 2, "reference_head_chunk": 1,
           "limits": {"anchor_err": 1e-5, "map_rel_rms": 1e-4, "score_abs": 1e-5}}
TINY = {"model_name": "tiny-eva-postnorm-test",
        "vision": {"width": 112, "layers": 4, "head_width": 28,
                   "mlp_ratio": 8.571428571428571}}


def cfg():
    return inputs.load_json("configs", "eva02-clip-bige14p-518")


def test_block_and_image_against_hand_counts():
    n, d, h = 1370, 1792, 15360
    assert flops_eva02e.hidden(cfg()) == h == cfg()["vision"]["mlp_hidden"]
    block = flops_eva02e.block_forward(n, d, h)
    parts = {"qkv": 2 * n * d * 3 * d, "out": 2 * n * d * d, "mlp": 2 * 2 * n * d * h,
             "attn": 4 * n * n * d}
    assert block == sum(parts.values())
    for name, gflop in (("qkv", 26.4), ("out", 8.8), ("mlp", 150.8), ("attn", 13.45)):
        assert abs(parts[name] / (gflop * 1e9) - 1) < 0.01, name
    assert abs(block / 199.5e9 - 1) < 0.001
    image = flops_eva02e.infer_image(cfg())
    # The patch embedding, the heads and the maps add 1.5%.
    assert 64 * block < image < 1.02 * 64 * block
    assert abs(image / 12.96e12 - 1) < 0.01
    vitl = flops.infer_image(inputs.load_json("configs", "vitl14-336-518"))
    assert 12.1 < image / vitl < 12.3


def test_kernel_counts():
    m, d, h = 16 * 1370, 1792, 15360
    ops, nbytes = flops_eva02e.attn_fwd(16, 1370, d, 112)
    assert ops == 4 * 16 * 1370 ** 2 * d
    assert nbytes == m * 4 * d * 2 + 16 * 16 * 1370 * 4
    assert flops.bound_s(ops, nbytes) == ops / flops.PEAK_BF16       # bound by operations
    ops, nbytes = flops_eva02e.postnorm_gemms(16, 1370, d, h)
    assert ops == 2 * m * d * (4 * d + 2 * h)
    assert flops.bound_s(ops, nbytes) == ops / flops.PEAK_BF16
    ops, nbytes = flops_eva02e.postnorm_rows(16, 1370, d)
    assert nbytes == m * d * 8 + 3 * d * 4
    assert flops.bound_s(ops, nbytes) == nbytes / flops.PEAK_BYTES   # bound by bytes


def _trace(names_seconds):
    events, at = [], 0.0
    for name, sec in names_seconds:
        events.append((name, at, at + sec * 1e6))
        at += sec * 1e6
    return Trace(events, [], (0.0, at + 1e6))


B1_112 = ("void aaclip::attn_fwd::(anonymous namespace)::attention_wgmma_kernel"
          "<packed_attention_hd112>(int)")
B1_64 = B1_112.replace("packed_attention_hd112", "packed_attention")
GEMM = ("void aaclip::gemm90::(anonymous namespace)::gemm_bias_act_kernel<(anonymous "
        "namespace)::eva_postnorm_stage, 256, 0>(int)")
GEMM_F32 = ("void aaclip::gemm90::(anonymous namespace)::gemm_f32_kernel<(anonymous "
            "namespace)::eva_postnorm_stage, 256, false>(int)")
B2 = GEMM.replace("eva_postnorm_stage", "ln_mlp_residual_stage")
ROWS = ("void (anonymous namespace)::ln_residual_rows_kernel<(anonymous namespace)::"
        "eva_postnorm_stage, 14>(int)")


def test_readers_on_a_made_up_trace():
    c = cfg()
    work = {"images": 32, "calls": 2, "batch": 16, "seconds": 1.0}
    ctx = SimpleNamespace(trace=_trace([(B1_112, 0.02), (B1_64, 0.01), (GEMM, 0.3),
                                        (GEMM_F32, 0.1), (B2, 0.01), (ROWS, 0.04)]),
                          work=work, config=c, counters={})
    calls = 2 * 64
    ops, nbytes = flops_eva02e.attn_fwd(16, 1370, 1792, 112)
    got = load_module("metrics", "attn_hd112_fwd_roofline").read(ctx)
    assert got == pytest.approx(100.0 * calls * flops.bound_s(ops, nbytes) / 0.02)
    ops, nbytes = flops_eva02e.postnorm_gemms(16, 1370, 1792, 15360)
    got = load_module("metrics", "postnorm_gemm_roofline").read(ctx)
    assert got == pytest.approx(100.0 * calls * flops.bound_s(ops, nbytes) / 0.4)
    ops, nbytes = flops_eva02e.postnorm_rows(16, 1370, 1792)
    got = load_module("metrics", "postnorm_rows_roofline").read(ctx)
    assert got == pytest.approx(100.0 * 2 * calls * flops.bound_s(ops, nbytes) / 0.04)
    got = load_module("metrics", "mfu.infer.eva02e").read(ctx)
    assert got == pytest.approx(100.0 * flops_eva02e.infer_image(c) * 32
                                / (ctx.trace.window_s * flops.PEAK_BF16))
    # A program without the new kernels (the parent's) reads nothing.
    ctx.trace = _trace([(B1_64, 0.01), (B2, 0.01)])
    for name in ("attn_hd112_fwd_roofline", "postnorm_gemm_roofline", "postnorm_rows_roofline"):
        assert load_module("metrics", name).read(ctx) is None, name


def test_fused_share_reads_the_counters(monkeypatch):
    from aa_clip_iqm_tpu_torch.utils import profiling

    read = load_module("metrics", "postnorm.fused_share").read
    ctx = SimpleNamespace(trace=_trace([("k", 0.01)]))
    monkeypatch.setattr(profiling, "counters", lambda: {"postnorm.fused": 256})
    assert read(ctx) == 100.0
    monkeypatch.setattr(profiling, "counters",
                        lambda: {"postnorm.fused": 96, "postnorm.chain": 32})
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
    return tiny_run("offline_eva02e", dict(OFFLINE, **workload), **TINY)


def test_sound_run_is_correct_and_the_reference_matches():
    ok, checks = correct(run())
    assert ok, checks
    assert ref.vision is not eva02e.vision       # the swap lasts the comparison alone


def scale_64(monkeypatch):
    """The planted fault: the tower's heads scaled by 64^-0.5 (the text
    tower's masked calls pass through)."""
    from aa_clip_iqm_tpu_torch.ops import attention

    real = attention.attend_qkv

    def attend(qkv, num_heads, attn_mask=None, valid_len=None, use_pallas=True):
        if attn_mask is not None:
            return real(qkv, num_heads, attn_mask=attn_mask, valid_len=valid_len,
                        use_pallas=use_pallas)
        return attention.flash_mha_packed(qkv, num_heads, 64 ** -0.5, valid_len=valid_len)
    monkeypatch.setattr(attention, "attend_qkv", attend)


def test_heads_scaled_by_64_read_not_correct(monkeypatch):
    scale_64(monkeypatch)
    ok, checks = correct(run())
    assert not ok, checks
    assert dict((n, v) for n, v, _ in checks)["anchor_err"] <= 1e-5   # the text tower is sound


def test_fp8_control_reads_not_correct():
    ok, checks = correct(run(control="fp8_reference"))
    assert not ok, checks
    values = dict((n, v) for n, v, _ in checks)
    assert values["map_rel_rms"] > 1e-4 and values["anchor_err"] <= 1e-5


def test_the_cell_s_files_state_the_program_s_sizes():
    """The configuration file's sizes are the program's (``common.
    model_config``), nothing is cut, and the workload builds the cell's
    kernels."""
    from benchmark.drivers import common

    c = cfg()
    mc = common.model_config(c)
    v = mc.clip.vision
    assert (v.postnorm, v.mlp_hidden, v.heads) == (True, c["vision"]["mlp_hidden"], 16)
    assert c["reduced"] == []
    wl = inputs.load_json("workloads", "offline-eva02e-518-b16")
    assert set(wl["kernels"]) == {"packed_attention", "eva_postnorm", "ln_mlp_residual"}
    assert (wl["batch"], wl["sample"], wl["reference_chunk"]) == (16, 16, 2)
