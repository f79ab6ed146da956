"""The SigLIP So400m/14 cell's pieces on the CPU: ``flops_siglip`` against
hand counts, the new metrics' readers on a made-up trace, SigLIP's
reference against the program at the tiny size
(``configs.tiny_siglip_config``, float32) through
``drivers/offline_siglip.py``, and the driver's comparison with the timed
path broken (the heads scaled by 64^-0.5 where they take 72^-0.5; the
hidden tail dropped) and with the float8 control, each of which must read
not correct."""
from types import SimpleNamespace

import pytest

from benchmark import flops, flops_siglip, inputs
from benchmark.harness import load_module
from benchmark.reference import model as ref
from benchmark.reference import siglip
from benchmark.tests.tiny import tiny_run
from benchmark.trace import Trace

OFFLINE = {"batch": 2, "pool": 2, "sample": 3, "reference_chunk": 2, "reference_head_chunk": 1,
           "limits": {"anchor_err": 1e-5, "map_rel_rms": 1e-4, "score_abs": 1e-5}}
TINY = {"model_name": "tiny-siglip-test", "act": "gelu_tanh", "embed_dim": 32,
        "vision": {"width": 144, "layers": 3, "head_width": 72, "mlp_ratio": 3.7362},
        "text": {"width": 144, "layers": 3, "heads": 2, "context_length": 16,
                 "vocab_size": 32000},
        "adapter": {"image_adapt_until": 1, "text_adapt_until": 1, "image_adapt_weight": 0.1,
                    "text_adapt_weight": 0.1, "levels": [2, 3], "relu": False}}


def cfg():
    return inputs.load_json("configs", "siglip-so400m14-384-518")


def test_block_and_image_against_hand_counts():
    n, d, h = 1369, 1152, 4304
    c = cfg()
    assert (flops_siglip.tokens(c), flops_siglip.hidden(c)) == (n, h) == (
        n, c["vision"]["mlp_hidden"])
    block = flops_siglip.block_forward(n, d, h)
    parts = {"qkv": 2 * n * d * 3 * d, "out": 2 * n * d * d, "mlp": 2 * 2 * n * d * h,
             "attn": 4 * n * n * d}
    assert block == sum(parts.values())
    for name, gflop in (("qkv", 10.90), ("out", 3.63), ("mlp", 27.15), ("attn", 8.64)):
        assert abs(parts[name] / (gflop * 1e9) - 1) < 0.005, name
    assert abs(block / 50.3e9 - 1) < 0.002
    assert abs(flops_siglip.map_head(n, d, h) / 7.3e9 - 1) < 0.01
    image = flops_siglip.infer_image(c)
    # The patch embedding, the pool, the heads and the maps add 5.4%.
    assert 27 * block < image < 1.06 * 27 * block
    vitl = flops.infer_image(inputs.load_json("configs", "vitl14-336-518"))
    assert 1.33 < image / vitl < 1.37


def test_kernel_counts():
    m, d, h = 32 * 1369, 1152, 4304
    ops, nbytes = flops_siglip.attn_fwd(32, 1369, d, 72)
    assert ops == 4 * 32 * 1369 ** 2 * d
    assert nbytes == m * 4 * d * 2 + 32 * 16 * 1369 * 4
    assert flops.bound_s(ops, nbytes) == ops / flops.PEAK_BF16
    ops, nbytes = flops_siglip.mlp_fwd(32, 1369, d, h)
    assert ops == 4 * m * d * h and nbytes == (2 * m * d + 2 * d * h) * 2
    assert flops.bound_s(ops, nbytes) == ops / flops.PEAK_BF16


def _trace(names_seconds):
    events, at = [], 0.0
    for name, sec in names_seconds:
        events.append((name, at, at + sec * 1e6))
        at += sec * 1e6
    return Trace(events, [], (0.0, at + 1e6))


B1_72 = ("void aaclip::attn_fwd::(anonymous namespace)::attention_wgmma_kernel"
         "<packed_attention_hd72>(int)")
B1_64 = B1_72.replace("packed_attention_hd72", "packed_attention")
B2 = ("void aaclip::gemm90::(anonymous namespace)::gemm_bias_act_kernel<(anonymous "
      "namespace)::ln_mlp_residual_stage, 256, 3>(int)")
B8 = B2.replace("ln_mlp_residual_stage, 256, 3", "ln_attn_residual_stage, 256, 2")


def test_readers_on_a_made_up_trace():
    c = cfg()
    work = {"images": 64, "calls": 2, "batch": 32, "seconds": 1.0}
    ctx = SimpleNamespace(trace=_trace([(B1_72, 0.04), (B1_64, 0.01), (B2, 0.1), (B8, 0.05)]),
                          work=work, config=c, counters={})
    calls = 2 * 27
    ops, nbytes = flops_siglip.attn_fwd(32, 1369, 1152, 72)
    got = load_module("metrics", "attn_hd72_fwd_roofline").read(ctx)
    assert got == pytest.approx(100.0 * calls * flops.bound_s(ops, nbytes) / 0.04)
    ops, nbytes = flops_siglip.mlp_fwd(32, 1369, 1152, 4304)
    got = load_module("metrics", "siglip_mlp_fwd_roofline").read(ctx)
    assert got == pytest.approx(100.0 * calls * flops.bound_s(ops, nbytes) / 0.1)
    got = load_module("metrics", "mfu.infer.siglip").read(ctx)
    assert got == pytest.approx(100.0 * flops_siglip.infer_image(c) * 64
                                / (ctx.trace.window_s * flops.PEAK_BF16))
    # A program without the 72-wide instance (the parent's) reads nothing there.
    ctx.trace = _trace([(B1_64, 0.01)])
    for name in ("attn_hd72_fwd_roofline", "siglip_mlp_fwd_roofline"):
        assert load_module("metrics", name).read(ctx) is None, name


def test_fused_share_reads_the_counters(monkeypatch):
    from aa_clip_iqm_tpu_torch.utils import profiling

    read = load_module("metrics", "siglip.fused_share").read
    ctx = SimpleNamespace(trace=_trace([("k", 0.01)]))
    monkeypatch.setattr(profiling, "counters", lambda: {"siglip.fused": 108})
    assert read(ctx) == 100.0
    monkeypatch.setattr(profiling, "counters", lambda: {"siglip.fused": 54, "siglip.chain": 54})
    assert read(ctx) == 50.0
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
    return tiny_run("offline_siglip", dict(OFFLINE, **workload), **TINY)


def test_sound_run_is_correct_and_the_reference_matches():
    ok, checks = correct(run())
    assert ok, checks
    # The swap lasts the comparison alone.
    assert ref.vision is not siglip.vision and ref.text_anchors is not siglip.text_anchors


def test_heads_scaled_by_64_read_not_correct(monkeypatch):
    from aa_clip_iqm_tpu_torch.ops import attention

    real = attention.attend_qkv

    def attend(qkv, num_heads, attn_mask=None, valid_len=None, use_pallas=True):
        if attn_mask is not None:
            return real(qkv, num_heads, attn_mask=attn_mask, valid_len=valid_len,
                        use_pallas=use_pallas)
        return attention.flash_mha_packed(qkv, num_heads, 64 ** -0.5, valid_len=valid_len)
    monkeypatch.setattr(attention, "attend_qkv", attend)
    ok, checks = correct(run())
    assert not ok, checks


def test_hidden_tail_dropped_reads_not_correct(monkeypatch):
    from aa_clip_iqm_tpu_torch.models import clip
    from aa_clip_iqm_tpu_torch.ops import fused_mlp

    def dropped(mlp):
        c_fc, c_proj = mlp["c_fc"], mlp["c_proj"]
        h = c_fc["w"].shape[-1] - 80
        return fused_mlp._pad_hidden(c_fc["w"][:, :h], c_fc["b"][:h], c_proj["w"][:h],
                                     c_proj["b"])
    monkeypatch.setattr(clip, "padded_hidden", dropped)
    ok, checks = correct(run())
    assert not ok, checks


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
    v, t = mc.clip.vision, mc.clip.text
    assert (v.class_token, v.pool, v.mlp_hidden, v.heads, v.ln_eps) == (
        c["vision"]["class_token"], c["vision"]["pool"], c["vision"]["mlp_hidden"], 16,
        c["vision"]["ln_eps"])
    assert (t.causal, t.pool, t.head_bias, t.ln_eps) == (
        c["text"]["causal"], c["text"]["pool"], c["text"]["head_bias"], c["text"]["ln_eps"])
    assert common.model_config(c, c["native_image_size"]).clip.vision.grid == 27
    assert c["reduced"] == []
    wl = inputs.load_json("workloads", "offline-siglip-518-b32")
    base = inputs.load_json("workloads", "offline-518-b32")
    assert {k: wl[k] for k in ("batch", "pool", "sample")} == {
        k: base[k] for k in ("batch", "pool", "sample")}
    assert set(wl["kernels"]) == {"packed_attention", "ln_attn_residual", "ln_mlp_residual"}
