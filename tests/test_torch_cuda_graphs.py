"""The aaclip:: ops' CUDA implementations and the detector's per-bucket CUDA
graphs, on the card.

Marked ``cuda``: each test skips (from a fixture) where no CUDA device is
present. On a machine with an H100 and nvcc run

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_graphs.py -q

Each op is held to its plain version on the same CUDA tensors in bf16 ulps
(ops/compare.py); a graph replay is held to the eager program bit for bit
(the same kernels in the same order), on the tiny config and at one ViT-L
bucket, and again after the input buffers were rewritten by other
requests. A replay's maps and scores come back as views of page-locked
host memory, each its own block: later calls, and later windows of the
micro-batcher, leave them as they were.
"""
import numpy as np
import pytest
import torch

from aa_clip_iqm_tpu_torch import configs as tconfigs
from aa_clip_iqm_tpu_torch.loader import build_model_config, init_trainable, random_backbone
from aa_clip_iqm_tpu_torch.ops import _build, attn_block, flash_attention, fused_mlp, quant
from aa_clip_iqm_tpu_torch.ops import packed_attention as pa
from aa_clip_iqm_tpu_torch.ops.compare import BF16_MAX_ULPS, BF16_RMS_ULPS, bf16_error
from aa_clip_iqm_tpu_torch.ops.layers import gelu
from aa_clip_iqm_tpu_torch.serving import AnomalyDetector, MicroBatchingService
from aa_clip_iqm_tpu_torch.utils import profiling

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
    before = profiling.counters()
    out = OPS.flash_mha_packed(qkv, 16, 0.125, False, None)
    out_l, lse = OPS.flash_mha_packed_lse(qkv, 16, 0.125, False, 1300)
    assert _build.launches(before) == {"packed_attention": 2}
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
        before = profiling.counters()
        out = OPS.ln_mlp_residual_int8(x, ln["scale"], ln["bias"], q["c_fc"]["w_q"],
                                       q["c_fc"]["scale"], q["c_fc"]["b"], q["c_proj"]["w_q"],
                                       q["c_proj"]["scale"], q["c_proj"]["b"], "gelu", 1e-5)
        assert _build.launches(before) == {"ln_mlp_residual_int8": 1}
        # The stages round where the kernel rounds (tests/test_torch_cuda_kernels.py).
        _check(out, fused_mlp.ln_mlp_residual_int8_stages(ln, q, x, gelu)["y"], x)
    else:
        before = profiling.counters()
        out = OPS.ln_mlp_residual(x, ln["scale"], ln["bias"], mlp["c_fc"]["w"],
                                  mlp["c_fc"]["b"], mlp["c_proj"]["w"], mlp["c_proj"]["b"],
                                  "gelu", 1e-5)
        assert _build.launches(before) == {"ln_mlp_residual": 1}
        _check(out, fused_mlp.ln_mlp_residual_reference(ln, mlp, x, gelu), x)


def test_flash_mha_op(dev):
    q, k, v = (_randn(dev, 16, 8282, 64, seed=s) for s in range(3))
    before = profiling.counters()
    out = OPS.flash_mha(q, k, v, 0.125)
    assert _build.launches(before) == {"flash_attention": 1}
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
    before = profiling.counters()
    out = OPS.ln_attn_residual(x, ln["scale"], ln["bias"], attn["qkv"]["w"], attn["qkv"]["b"],
                               attn["out"]["w"], attn["out"]["b"], 16, vv, None, 1e-5)
    assert _build.launches(before) == {"ln_attn_residual": 1}
    _check(out, attn_block.ln_attn_residual_stages(ln, attn, x, 16, vv, walk=True), x)


def test_ln_attn_halves_ops(dev):
    """B8's halves as ops, around B1's: the front and the back each held to
    its plain version."""
    d = 1024
    x = _randn(dev, 2, 1370, d)
    f32 = torch.float32
    ln = {"scale": 1 + _randn(dev, d, scale=0.1, dtype=f32, seed=1),
          "bias": _randn(dev, d, scale=0.1, dtype=f32, seed=2)}
    qkv_p = {"w": _randn(dev, d, 3 * d, scale=d ** -0.5, seed=3),
             "b": _randn(dev, 3 * d, scale=0.02, dtype=f32, seed=4)}
    out_p = {"w": _randn(dev, d, d, scale=d ** -0.5, seed=5),
             "b": _randn(dev, d, scale=0.02, dtype=f32, seed=6)}
    before = profiling.counters()
    qkv = OPS.ln_attn_front(x, ln["scale"], ln["bias"], qkv_p["w"], qkv_p["b"], 1e-5)
    o = OPS.flash_mha_packed(qkv, 16, 0.125, False, None)
    y = OPS.ln_attn_back(o, x, out_p["w"], out_p["b"])
    assert _build.launches(before) == {"ln_attn_residual_front": 1, "ln_attn_residual_back": 1,
                                       "packed_attention": 1}
    _check(qkv, attn_block.ln_attn_front_reference(ln, qkv_p, x))
    _check(y, attn_block.ln_attn_back_reference(out_p, o, x), x)


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


def _launched(before, *names):
    """The launches of each named C entry since the counters' snapshot ``before``."""
    got = _build.launches(before)
    return tuple(got.get(n, 0) for n in names)


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
        before = profiling.counters()
        eager = _device_kernels(lambda: _eager(det, images, "bottle"))
        assert _launched(before, "packed_attention", "ln_mlp_residual") == (24, 24)
        if replayed == eager:
            break
    assert replayed == eager
    assert sum(n for k, n in replayed.items() if "packed_attention" in k) == 24


@pytest.mark.parametrize("model,img,attention", [
    ("ViT-L-14-336", 518, "packed_attention"),
    ("ViT-L-14-336", 1274, "flash_attention"),
    ("EVA02-CLIP-L-14-336", 518, "packed_attention"),
])
def test_graph_replays_run_b8_s_halves(dev, model, img, attention):
    """The 518 px, 1274 px and EVA-02 detectors' replays equal their eager
    programs bit for bit. The eager program launches 24 fronts, 24 backs and
    24 of the routed attention kernel (B1 at 1,370 tokens, B7 at 8,282), and
    the replay runs the eager program's device kernels: among them B8's
    LayerNorm pass, qkv product and out-projection 24 times each."""
    cfg = build_model_config(model, img_size=img)
    det = AnomalyDetector(random_backbone(cfg, device=dev), init_trainable(cfg, device=dev),
                          cfg, "MVTec", img_size=img, batch_buckets=(2,), device=dev)
    _graph_against_eager(det, img, 6)
    b1 = 24 if attention == "packed_attention" else 0
    want = (24, 24, b1, 24 - b1)
    images = np.random.default_rng(7).integers(0, 256, (2, 3, img, img), dtype=np.uint8)
    # As in test_graph_replay_matches_eager_vit_l, a disagreement of the
    # profiler's records is measured again, up to three times in all.
    for _ in range(3):
        replayed = _device_kernels(lambda: det.predict(images, "bottle"))
        before = profiling.counters()
        eager = _device_kernels(lambda: _eager(det, images, "bottle"))
        assert _launched(before, "ln_attn_residual_front", "ln_attn_residual_back",
                         "packed_attention", "flash_attention") == want
        if replayed == eager:
            break
    assert replayed == eager
    halves = {k: n for k, n in replayed.items() if "ln_attn_residual" in k}
    assert len(halves) == 3 and set(halves.values()) == {24}, halves
    assert sum(n for k, n in replayed.items() if attention in k) == 24


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


def _pinned_base(a):
    """The tensor at the root of numpy array ``a``'s chain of bases."""
    while isinstance(a, np.ndarray):
        a = a.base
    return a


def _eager_multi(det, images, names):
    """The eager program on ``images`` padded as ``predict_multi`` pads them."""
    bucket = next(b for b in det._buckets if b >= len(images))
    pad = np.zeros((bucket - len(images),) + images.shape[1:], images.dtype)
    names = list(names) + [names[-1]] * (bucket - len(names))
    anchors = torch.stack([det.anchors[c] for c in names], dim=0)
    return det._run_eager(np.concatenate([images, pad]), anchors, len(images))


def _counted(name):
    return profiling.counters().get(name, 0)


def test_replayed_outputs_are_page_locked_views_of_their_own(dev):
    """``predict_multi`` on a graph returns float32, C-contiguous maps and
    scores bit for bit the eager program's, each a view of a pinned tensor;
    a first call's arrays are unchanged by three later calls on other
    frames; ten calls that drop their results reuse the allocator's blocks."""
    cfg = tconfigs.tiny_test_config(56)
    det = AnomalyDetector(random_backbone(cfg, device=dev), init_trainable(cfg, device=dev),
                          cfg, "MVTec", img_size=56, batch_buckets=(4,), device=dev)
    rng = np.random.default_rng(4)
    frames = [rng.integers(0, 256, (4, 3, 56, 56), dtype=np.uint8) for _ in range(4)]
    names = det.class_names()[:4]
    det.predict_multi(frames[0], names)                  # warm-up, capture, replay
    maps, scores = det.predict_multi(frames[0], names)
    maps_e, scores_e = _eager_multi(det, frames[0], names)
    np.testing.assert_array_equal(maps, maps_e)
    np.testing.assert_array_equal(scores, scores_e)
    for a, shape in ((maps, (4, 56, 56)), (scores, (4,))):
        assert a.dtype == np.float32 and a.shape == shape and a.flags.c_contiguous
        base = _pinned_base(a)
        assert isinstance(base, torch.Tensor) and base.is_pinned()
    kept_maps, kept_scores = maps.copy(), scores.copy()
    for f in frames[1:]:
        other, _ = det.predict_multi(f, names[::-1])
        np.testing.assert_array_equal(other, _eager_multi(det, f, names[::-1])[0])
    np.testing.assert_array_equal(maps, kept_maps)
    np.testing.assert_array_equal(scores, kept_scores)
    pinned, allocs, calls = (_counted("predict.copy_out_pinned"),
                             _counted("predict.pinned_allocs"), _counted("predict.calls"))
    for i in range(10):
        det.predict_multi(frames[i % 4], names)
    assert _counted("predict.copy_out_pinned") - pinned == 10
    assert _counted("predict.calls") - calls == 10
    assert _counted("predict.pinned_allocs") - allocs <= 2


def test_a_served_map_outlives_later_windows(dev):
    """Under ``MicroBatchingService`` a request's map is a view of its
    window's page-locked block, and is intact and right after two later
    windows of other requests ran."""
    cfg = tconfigs.tiny_test_config(56)
    det = AnomalyDetector(random_backbone(cfg, device=dev), init_trainable(cfg, device=dev),
                          cfg, "MVTec", img_size=56, batch_buckets=(4,), device=dev)
    rng = np.random.default_rng(5)
    windows = [rng.standard_normal((2, 3, 56, 56)).astype(np.float32) for _ in range(3)]
    names = [["bottle", "screw"], ["cable", "grid"], ["screw", "bottle"]]
    svc = MicroBatchingService(det, max_batch=2, max_latency_ms=1000.0)
    try:
        got = []
        for w, ns in zip(windows, names):
            futs = [svc.submit(img, c) for img, c in zip(w, ns)]
            got.append([f.result(timeout=300) for f in futs])
    finally:
        svc.close()
    first = got[0]
    for amap, _ in first:
        base = _pinned_base(amap)
        assert isinstance(base, torch.Tensor) and base.is_pinned()
    for (w, ns), results in zip(zip(windows, names), got):
        maps_e, scores_e = _eager_multi(det, w, ns)
        for i, (amap, score) in enumerate(results):
            np.testing.assert_array_equal(amap, maps_e[i])
            assert score == scores_e[i]
