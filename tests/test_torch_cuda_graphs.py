"""The aaclip:: ops' CUDA implementations and the detector's per-bucket CUDA
graphs, on the card.

Marked ``cuda``: each test skips (from a fixture) where no CUDA device is
present. On a machine with an H100 and nvcc run

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_graphs.py -q

Each op is held to its plain version on the same CUDA tensors in bf16 ulps
(ops/compare.py); a graph replay is held to the eager program bit for bit
(the same kernels in the same order), on the tiny config and at one ViT-L
bucket, and again after the input buffers were rewritten by other
requests.
"""
import numpy as np
import pytest
import torch

from aa_clip_iqm_tpu_torch import configs as tconfigs
from aa_clip_iqm_tpu_torch.loader import build_model_config, init_trainable, random_backbone
from aa_clip_iqm_tpu_torch.ops import attn_block, flash_attention, fused_mlp, quant
from aa_clip_iqm_tpu_torch.ops import packed_attention as pa
from aa_clip_iqm_tpu_torch.ops.compare import BF16_MAX_ULPS, BF16_RMS_ULPS, bf16_error
from aa_clip_iqm_tpu_torch.ops.layers import gelu
from aa_clip_iqm_tpu_torch.serving import AnomalyDetector

pytestmark = pytest.mark.cuda
OPS = torch.ops.aaclip
PORT_KERNELS = ("packed_attention", "ln_mlp_residual", "ln_attn_residual", "flash_attention")


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _check(out, ref, base=None):
    torch.cuda.synchronize()
    max_ulps, rms_ulps = bf16_error(out, ref, base)
    assert max_ulps <= BF16_MAX_ULPS and rms_ulps <= BF16_RMS_ULPS, (max_ulps, rms_ulps)


def _randn(dev, *shape, scale=1.0, dtype=torch.bfloat16, seed=0):
    g = torch.Generator(device="cpu").manual_seed(seed + sum(shape))
    return (torch.randn(shape, generator=g) * scale).to(dev, dtype)


def test_flash_mha_packed_ops(dev):
    qkv = _randn(dev, 2, 1370, 3 * 1024)
    before = pa.LAUNCHES
    out = OPS.flash_mha_packed(qkv, 16, 0.125, False, None)
    out_l, lse = OPS.flash_mha_packed_lse(qkv, 16, 0.125, False, 1300)
    assert pa.LAUNCHES == before + 2
    _check(out, pa.flash_mha_packed_reference(qkv, 16, 0.125))
    _check(out_l, pa.flash_mha_packed_reference(qkv, 16, 0.125, False, 1300))
    want = pa.packed_lse_reference(qkv, 16, 0.125, False, 1300)
    assert ((lse - want).abs() / want.abs().clamp_min(1.0)).max().item() <= 1e-5


@pytest.mark.parametrize("int8", [False, True])
def test_ln_mlp_residual_ops(dev, int8):
    d, h, m = 1024, 4096, 1370
    x = _randn(dev, m, d)
    ln = {"scale": 1 + _randn(dev, d, scale=0.1, dtype=torch.float32, seed=1),
          "bias": _randn(dev, d, scale=0.1, dtype=torch.float32, seed=2)}
    mlp = {"c_fc": {"w": _randn(dev, d, h, scale=d ** -0.5, seed=3),
                    "b": _randn(dev, h, scale=0.02, dtype=torch.float32, seed=4)},
           "c_proj": {"w": _randn(dev, h, d, scale=h ** -0.5, seed=5),
                      "b": _randn(dev, d, scale=0.02, dtype=torch.float32, seed=6)}}
    if int8:
        q = {k: quant.quantize_linear_params(p) for k, p in mlp.items()}
        before = fused_mlp.INT8_LAUNCHES
        out = OPS.ln_mlp_residual_int8(x, ln["scale"], ln["bias"], q["c_fc"]["w_q"],
                                       q["c_fc"]["scale"], q["c_fc"]["b"], q["c_proj"]["w_q"],
                                       q["c_proj"]["scale"], q["c_proj"]["b"], "gelu", 1e-5)
        assert fused_mlp.INT8_LAUNCHES == before + 1
        # The stages round where the kernel rounds (tests/test_torch_cuda_kernels.py).
        _check(out, fused_mlp.ln_mlp_residual_int8_stages(ln, q, x, gelu)["y"], x)
    else:
        before = fused_mlp.LAUNCHES
        out = OPS.ln_mlp_residual(x, ln["scale"], ln["bias"], mlp["c_fc"]["w"],
                                  mlp["c_fc"]["b"], mlp["c_proj"]["w"], mlp["c_proj"]["b"],
                                  "gelu", 1e-5)
        assert fused_mlp.LAUNCHES == before + 1
        _check(out, fused_mlp.ln_mlp_residual_reference(ln, mlp, x, gelu), x)


def test_flash_mha_op(dev):
    q, k, v = (_randn(dev, 16, 8282, 64, seed=s) for s in range(3))
    before = flash_attention.LAUNCHES
    out = OPS.flash_mha(q, k, v, 0.125)
    assert flash_attention.LAUNCHES == before + 1
    _check(out, flash_attention.flash_mha_reference(q, k, v, 0.125))


@pytest.mark.parametrize("vv", [False, True])
def test_ln_attn_residual_op(dev, vv):
    d = 1024
    x = _randn(dev, 2, 1370, d)
    f32 = torch.float32
    ln = {"scale": 1 + _randn(dev, d, scale=0.1, dtype=f32, seed=1),
          "bias": _randn(dev, d, scale=0.1, dtype=f32, seed=2)}
    attn = {"qkv": {"w": _randn(dev, d, 3 * d, scale=d ** -0.5, seed=3),
                    "b": _randn(dev, 3 * d, scale=0.02, dtype=f32, seed=4)},
            "out": {"w": _randn(dev, d, d, scale=d ** -0.5, seed=5),
                    "b": _randn(dev, d, scale=0.02, dtype=f32, seed=6)}}
    before = attn_block.LAUNCHES
    out = OPS.ln_attn_residual(x, ln["scale"], ln["bias"], attn["qkv"]["w"], attn["qkv"]["b"],
                               attn["out"]["w"], attn["out"]["b"], 16, vv, None, 1e-5)
    assert attn_block.LAUNCHES == before + 1
    _check(out, attn_block.ln_attn_residual_stages(ln, attn, x, 16, vv, walk=True), x)


def _eager(det, images, name):
    return det._run_eager(*_padded(det, images, name))


def _padded(det, images, name):
    bucket = next(b for b in det._buckets if b >= len(images))
    pad = np.zeros((bucket - len(images),) + images.shape[1:], images.dtype)
    anchor = det.anchors[name]
    return (np.concatenate([images, pad]),
            anchor[None].expand((bucket,) + tuple(anchor.shape)), len(images))


def _device_kernels(fn):
    """The port's device kernels ``fn`` ran under torch.profiler (their
    names carry their source's name), by name and count."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {e.key: e.count for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and any(w in e.key for w in PORT_KERNELS)}


def _replays(det):
    return sum(g["replays"] for g in det.graph_stats())


def _graph_against_eager(det, img, seed):
    rng = np.random.default_rng(seed)
    first = rng.integers(0, 256, (2, 3, img, img), dtype=np.uint8)
    other = rng.integers(0, 256, (2, 3, img, img), dtype=np.uint8)
    maps, scores = det.predict(first, "bottle")          # warm-up, capture, replay
    assert _replays(det) == 1 and len(det.graph_stats()) == 1
    maps_e, scores_e = _eager(det, first, "bottle")
    np.testing.assert_array_equal(maps, maps_e)
    np.testing.assert_array_equal(scores, scores_e)
    # Other requests rewrite the input buffers; the first one's again must
    # give its own maps back, and the other's its own.
    maps_o, _ = det.predict(other, "screw")
    np.testing.assert_array_equal(maps_o, _eager(det, other, "screw")[0])
    assert not np.array_equal(maps_o, maps)
    again, _ = det.predict(first, "bottle")
    np.testing.assert_array_equal(again, maps)
    assert _replays(det) == 3 and len(det.graph_stats()) == 1


def test_graph_replay_matches_eager_tiny(dev):
    cfg = tconfigs.tiny_test_config(56)
    det = AnomalyDetector(random_backbone(cfg, device=dev), init_trainable(cfg, device=dev),
                          cfg, "MVTec", img_size=56, batch_buckets=(2,), device=dev)
    _graph_against_eager(det, 56, 0)


def test_graph_replay_matches_eager_vit_l(dev):
    cfg = build_model_config("ViT-L-14-336", img_size=518)
    det = AnomalyDetector(random_backbone(cfg, device=dev), init_trainable(cfg, device=dev),
                          cfg, "MVTec", img_size=518, batch_buckets=(2,), device=dev)
    _graph_against_eager(det, 518, 1)
    assert det.graph_memory() > 0
    # A replay moves no counter: it must run the device kernels of the eager
    # program on the same input, whose launches the counters count.
    # The profiler now and then loses a few kernel records of a run, so a
    # disagreement is measured again, up to three times in all.
    images = np.random.default_rng(3).integers(0, 256, (2, 3, 518, 518), dtype=np.uint8)
    for _ in range(3):
        replayed = _device_kernels(lambda: det.predict(images, "bottle"))
        before = (pa.LAUNCHES, fused_mlp.LAUNCHES)
        eager = _device_kernels(lambda: _eager(det, images, "bottle"))
        assert (pa.LAUNCHES - before[0], fused_mlp.LAUNCHES - before[1]) == (24, 24)
        if replayed == eager:
            break
    assert replayed == eager
    assert sum(n for k, n in replayed.items() if "packed_attention" in k) == 24


def test_concurrent_requests_share_the_graphs_safely(dev):
    """Threads that call one detector at once (more of them than buckets)
    each get their own request's maps: the lock serialises copy-in, replay
    and copy-out on the shared buffers."""
    import sys
    import threading

    cfg = tconfigs.tiny_test_config(56)
    det = AnomalyDetector(random_backbone(cfg, device=dev), init_trainable(cfg, device=dev),
                          cfg, "MVTec", img_size=56, batch_buckets=(1, 2), device=dev)
    rng = np.random.default_rng(2)
    batches = [rng.integers(0, 256, (1 + i % 2, 3, 56, 56), dtype=np.uint8) for i in range(8)]
    want = [_eager(det, b, "bottle")[0] for b in batches]
    got, errors = {}, []

    def work(i):
        try:
            for _ in range(5):
                got[i] = det.predict(batches[i], "bottle")[0]
                np.testing.assert_array_equal(got[i], want[i])
        except Exception as exc:       # reported below, from the main thread
            errors.append(exc)

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=work, args=(i,)) for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors[0]
    assert _replays(det) == 40 and len(det.graph_stats()) == 2
