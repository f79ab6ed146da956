"""Operation and byte counts against hand counts, and the readers of the
per-layer metrics on a made-up trace."""
import math
from types import SimpleNamespace

import pytest

from benchmark import flops, inputs
from benchmark.harness import load_module
from benchmark.trace import Trace


def cfg(size):
    c = inputs.load_json("configs", "vitl14-336-518")
    c["img_size"] = size
    return c


@pytest.mark.parametrize("size,n,hand", [(518, 1370, 1.01e12), (1274, 8282, 1.17e13)])
def test_tower_against_hand_count(size, n, hand):
    d = 1024
    assert flops.tokens(cfg(size)) == n
    exact = 24 * (24 * n * d * d + 4 * n * n * d)
    assert flops.tower_blocks(cfg(size)) == exact
    assert abs(exact / hand - 1) < 0.01


@pytest.mark.parametrize("size", [518, 1274])
def test_image_and_step_around_the_tower(size):
    c = cfg(size)
    tower = flops.tower_blocks(c)
    assert tower < flops.infer_image(c) < 1.05 * tower
    assert 1.9 * tower < flops.train_image(c) < 2.7 * tower


def test_attention_share_of_the_image():
    # 4 n^2 d of every block: 0.19 of 1.01 TFLOP at 518 px, 6.7 of 11.7 at 1274.
    for size, share in ((518, 0.19 / 1.01), (1274, 6.7 / 11.7)):
        c = cfg(size)
        n = flops.tokens(c)
        attn = 24 * 4 * n * n * 1024
        assert abs(attn / flops.tower_blocks(c) - share) < 0.01


def test_kernel_counts():
    ops, nbytes = flops.attn_fwd(32, 1370, 1024)
    assert ops == 4 * 32 * 1370 ** 2 * 1024
    assert nbytes == 32 * 1370 * 4 * 1024 * 2 + 32 * 16 * 1370 * 4
    assert flops.bound_s(ops, nbytes) == ops / 989e12       # bound by operations
    ops, nbytes = flops.mlp_fwd(8, 1370, 1024)
    assert ops == 16 * 8 * 1370 * 1024 ** 2
    assert flops.attn_bwd(8, 1370, 1024)[0] == 2.5 * flops.attn_fwd(8, 1370, 1024)[0]
    assert flops.mlp_bwd(8, 1370, 1024)[0] == 1.5 * flops.mlp_fwd(8, 1370, 1024)[0]
    assert flops.bound_s(1.0, 3.35e12) == 1.0


def fake_trace():
    name_b1 = "void aaclip::attn_fwd::(anonymous namespace)::attention_wgmma_kernel<packed_attention>(int)"
    name_b2 = ("void aaclip::gemm90::(anonymous namespace)::gemm_bias_act_kernel<(anonymous "
               "namespace)::ln_mlp_residual_stage, 256, 1>(int)")
    name_b5 = ("void aaclip::gemm90::(anonymous namespace)::gemm_f32_kernel<(anonymous "
               "namespace)::ln_mlp_residual_dx_stage, 128, false>(int)")
    dev = [(name_b1, 0.0, 600.0), (name_b2, 700.0, 1700.0), (name_b5, 1800.0, 2000.0),
           ("Memcpy DtoH (Device -> Pageable)", 2500.0, 3000.0)]
    spans = [("bench/predict_multi", 0.0, 3200.0)]
    return Trace(dev, spans, (0.0, 4000.0))


def test_trace_reduction():
    tr = fake_trace()
    assert tr.window_s == 4000e-6
    assert tr.busy_s == pytest.approx(2300e-6)
    gaps = tr.idle_gaps()
    assert gaps["bench/predict_multi"] == pytest.approx(700e-6)
    assert gaps["no harness span"] == pytest.approx(1000e-6)
    bd = tr.breakdown()
    assert bd["device_ops"][0][1] == pytest.approx(1000e-6)
    assert tr.groups()["B1 packed_attention"] == pytest.approx(600e-6)


def test_readers_on_a_trace():
    c = cfg(518)
    ctx = SimpleNamespace(trace=fake_trace(), config=c, counters={"answered": 12, "replays": 4},
                          work={"images": 32, "calls": 1, "batch": 32, "seconds": 0.004})
    attn = load_module("metrics", "attn_fwd_roofline").read(ctx)
    bound = 24 * flops.bound_s(*flops.attn_fwd(32, 1370, 1024))
    assert attn == pytest.approx(100 * bound / 600e-6)
    mlp = load_module("metrics", "mlp_fwd_roofline").read(ctx)
    assert mlp == pytest.approx(100 * 24 * flops.bound_s(*flops.mlp_fwd(32, 1370, 1024)) / 1000e-6)
    assert load_module("metrics", "mlp_bwd_roofline").read(ctx) == pytest.approx(
        100 * 23 * flops.bound_s(*flops.mlp_bwd(32, 1370, 1024)) / 200e-6)
    assert load_module("metrics", "attn_bwd_roofline").read(ctx) is None
    assert load_module("metrics", "device_idle.offline").read(ctx) == pytest.approx(42.5)
    assert load_module("metrics", "serve.requests_per_batch").read(ctx) == 3.0
    mfu = load_module("metrics", "mfu.infer").read(ctx)
    assert mfu == pytest.approx(100 * 32 * flops.infer_image(c) / (4000e-6 * 989e12))
    assert math.isfinite(load_module("metrics", "mfu.train").read(ctx))
