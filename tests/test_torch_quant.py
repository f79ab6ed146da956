"""Port's int8 tier (ops/quant.py) vs the JAX package's, on the CPU: the same
inputs, made from a numpy seed, through both."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aa_clip_iqm_tpu.configs import tiny_test_config
from aa_clip_iqm_tpu.models import adapters as jadapters
from aa_clip_iqm_tpu.models import clip as jclip
from aa_clip_iqm_tpu.ops import layers as jlayers
from aa_clip_iqm_tpu.ops import quant as jquant
from aa_clip_iqm_tpu_torch import configs as tconfigs
from aa_clip_iqm_tpu_torch.models import clip as tclip
from aa_clip_iqm_tpu_torch.models.convert import params_from_jax
from aa_clip_iqm_tpu_torch.ops import layers as tlayers
from aa_clip_iqm_tpu_torch.ops import quant as tquant
from aa_clip_iqm_tpu_torch.serving import AnomalyDetector

IMG = 56
TIERS = ["int8", "int8_attn", "int8_mlp"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def model():
    cfg = tiny_test_config(IMG)
    frozen = jclip.init_clip_params(jax.random.PRNGKey(0), cfg.clip)
    trainable = jadapters.init_adapter_params(jax.random.PRNGKey(1), cfg)
    tcfg = tconfigs.tiny_test_config(IMG)
    tf, tt = params_from_jax(jax.tree.map(np.asarray, frozen),
                             jax.tree.map(np.asarray, trainable), tcfg,
                             device="cpu", dtype=torch.float32)
    return cfg, frozen, trainable, tcfg, tf, tt


def _linear_params(rng, *shape, bias=True):
    p = {"w": rng.standard_normal(shape).astype(np.float32) * 0.05}
    if bias:
        p["b"] = rng.standard_normal(shape[-1]).astype(np.float32) * 0.01
    return p


def _t(p):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in p.items()}


@pytest.mark.parametrize("shape", [(96, 64), (3, 32, 48)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quantize_linear_params_bit_equal(rng, shape, dtype):
    """Same integers and scales as the JAX package, 2-D and stacked; a
    weight held in bf16 quantizes from its float32 values."""
    p = _linear_params(rng, *shape)
    tp = _t(p)
    tp["w"] = tp["w"].to(dtype)
    jq = jquant.quantize_linear_params({"w": np.asarray(tp["w"].float()), "b": p["b"]})
    tq = tquant.quantize_linear_params(tp)
    assert tq["w_q"].dtype == torch.int8 and tq["scale"].dtype == torch.float32
    assert tuple(tq["scale"].shape) == shape[:-2] + (1, shape[-1])
    np.testing.assert_array_equal(tq["w_q"].numpy(), np.asarray(jq["w_q"]))
    np.testing.assert_array_equal(tq["scale"].numpy(), np.asarray(jq["scale"]))
    assert tq["b"] is tp["b"]
    assert "b" not in tquant.quantize_linear_params({"w": tp["w"]})


@pytest.mark.parametrize("bias", [True, False])
def test_int8_linear_matches_jax(rng, bias):
    """Same integers, same float32 epilogue order: rtol 1e-6. The hook in
    layers.linear routes quantized params there."""
    p = _linear_params(rng, 96, 64, bias=bias)
    x = rng.standard_normal((4, 17, 96)).astype(np.float32)
    ref = np.asarray(jquant.int8_linear(jquant.quantize_linear_params(p), jnp.asarray(x)))
    tq = tquant.quantize_linear_params(_t(p))
    out = tquant.int8_linear(tq, torch.from_numpy(x))
    assert out.shape == (4, 17, 64) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-6, atol=1e-7)
    assert torch.equal(tlayers.linear(tq, torch.from_numpy(x)), out)


def test_int8_linear_stacked_layers_match_jax(rng):
    """Stacked (layers, in, out) weights quantize per layer and channel; a
    layer's slice (scale (1, out)) runs like a 2-D weight."""
    w = rng.standard_normal((3, 32, 48)).astype(np.float32) * 0.05
    x = rng.standard_normal((2, 5, 32)).astype(np.float32)
    jq = jquant.quantize_linear_params({"w": w})
    tq = tquant.quantize_linear_params({"w": torch.from_numpy(w)})
    for i in range(3):
        ref = np.asarray(jquant.int8_linear(jax.tree.map(lambda a: a[i], jq), jnp.asarray(x)))
        out = tquant.int8_linear({k: v[i] for k, v in tq.items()}, torch.from_numpy(x))
        np.testing.assert_allclose(out.numpy(), ref, rtol=1e-6, atol=1e-7)


def test_int8_linear_bf16_and_exact_integer_product(rng):
    """bf16 in, bf16 out; and the integer product is exact where a float32
    one is not (k = 4096, all operands 127)."""
    p = _linear_params(rng, 64, 32)
    x = rng.standard_normal((9, 64)).astype(np.float32)
    ref = np.asarray(jquant.int8_linear(jquant.quantize_linear_params(p),
                                        jnp.asarray(x, jnp.bfloat16)), np.float32)
    out = tquant.int8_linear(tquant.quantize_linear_params(_t(p)),
                             torch.from_numpy(x).to(torch.bfloat16))
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), ref, rtol=1e-2, atol=1e-3)
    a = torch.full((3, 4096), 127, dtype=torch.int8)
    b = torch.full((4096, 8), 127, dtype=torch.int8)
    got = tquant.int8_matmul(a, b)
    assert got.dtype == torch.int32
    assert (got == 127 * 127 * 4096).all() and 127 * 127 * 4096 > 2 ** 24


def test_int8_linear_ste_gradients_match_jax(rng):
    """Straight-through backward (tests/test_quant.py:356): dx equals the
    JAX package's, the bias gradient flows, the no-bias path differentiates."""
    p = _linear_params(rng, 24, 16)
    x = rng.standard_normal((3, 24)).astype(np.float32)
    jq = jquant.quantize_linear_params(p)
    g_ref = np.asarray(jax.grad(lambda x: jnp.sum(jquant.int8_linear(jq, x) ** 2))(jnp.asarray(x)))
    tq = tquant.quantize_linear_params(_t(p))
    tq["b"] = tq["b"].clone().requires_grad_(True)
    xt = torch.from_numpy(x).requires_grad_(True)
    (tquant.int8_linear(tq, xt) ** 2).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), g_ref, rtol=1e-5, atol=1e-6)
    assert xt.grad.abs().sum() > 0 and tq["b"].grad.abs().sum() > 0
    db_ref = np.asarray(jax.grad(
        lambda b: jnp.sum(jquant.int8_linear(dict(jq, b=b), jnp.asarray(x)) ** 2))(jnp.asarray(p["b"])))
    np.testing.assert_allclose(tq["b"].grad.numpy(), db_ref, rtol=1e-5, atol=1e-6)
    x2 = torch.from_numpy(x).requires_grad_(True)
    tquant.int8_linear(tquant.quantize_linear_params({"w": torch.from_numpy(p["w"])}), x2).sum().backward()
    assert torch.isfinite(x2.grad).all() and x2.grad.abs().sum() > 0


@pytest.mark.parametrize("tier", TIERS)
def test_tier_front_end_matches_jax(model, tier):
    """Which matmuls each tier quantizes, with the JAX package's integers."""
    _, frozen, _, _, tf, _ = model
    jq = jquant.quantize_backbone_tier(frozen, tier)
    tq = tquant.quantize_backbone_tier(tf, tier)
    assert tq["text"] is tf["text"]
    for i, block in enumerate(tq["visual"]["blocks"]):
        for half, names in (("attn", ("qkv", "out")), ("mlp", ("c_fc", "c_proj"))):
            for name in names:
                jp = jq["visual"]["blocks"][half][name]
                tp = block[half][name]
                assert ("w_q" in tp) == ("w_q" in jp), (tier, half, name)
                if "w_q" in tp:
                    np.testing.assert_array_equal(tp["w_q"].numpy(), np.asarray(jp["w_q"][i]))
                    np.testing.assert_array_equal(tp["scale"].numpy(), np.asarray(jp["scale"][i]))
                    assert tuple(tp["scale"].shape) == (1, tp["w_q"].shape[-1])


def test_tier_front_end_errors_and_noop(model):
    _, _, _, tcfg, tf, _ = model
    assert tquant.quantize_backbone_tier(tf, None) is tf
    assert tquant.quantize_backbone_tier(tf, "") is tf
    for bad in ("int8-attn", "int4", "int8+rough"):
        with pytest.raises(ValueError, match="unknown quantization tier"):
            tquant.quantize_backbone_tier(tf, bad)
    with pytest.raises(ValueError, match="needs calibration statistics"):
        tquant.quantize_backbone_tier(tf, "int8+smooth")
    with pytest.raises(ValueError, match="needs the model config"):
        tquant.quantize_backbone_auto(tf, "int8_mlp+smooth")
    with pytest.raises(ValueError, match="scope must be"):
        tquant.quantize_backbone_int8(tf, scope="some")
    with pytest.raises(ValueError, match="ViT tower only"):
        tquant.quantize_backbone_int8({"visual": {"stem": 0}, "text": {}})
    auto = tquant.quantize_backbone_auto(tf, "int8_mlp+smooth", cfg=tcfg)
    assert "w_q" in auto["visual"]["blocks"][0]["mlp"]["c_fc"]
    assert "w" in auto["visual"]["blocks"][0]["attn"]["qkv"]


def _inject_outliers(frozen, channels, factor):
    """LN-gain outlier channels, as tests/test_quant.py does."""
    blocks = dict(frozen["visual"]["blocks"])
    for ln in ("ln_1", "ln_2"):
        scale = np.array(blocks[ln]["scale"])
        scale[:, list(channels)] *= factor
        blocks[ln] = dict(blocks[ln], scale=jnp.asarray(scale))
    return dict(frozen, visual=dict(frozen["visual"], blocks=blocks))


@pytest.fixture(scope="module")
def outlier_model(model):
    cfg, frozen, trainable, tcfg, _, _ = model
    frozen = _inject_outliers(frozen, (3, 17), 40.0)
    tf, _ = params_from_jax(jax.tree.map(np.asarray, frozen), None, tcfg,
                            device="cpu", dtype=torch.float32)
    images = np.random.default_rng(5).standard_normal((2, 3, IMG, IMG)).astype(np.float32)
    return cfg, frozen, tcfg, tf, images


@pytest.mark.parametrize("adapted", [False, True])
def test_calibrate_ln_amax_matches_jax(model, adapted):
    """Post-LN activation maxima per layer and channel: rtol 1e-5."""
    cfg, frozen, trainable, tcfg, tf, tt = model
    images = np.random.default_rng(5).standard_normal((2, 3, IMG, IMG)).astype(np.float32)
    jkw, tkw = {}, {}
    if adapted:
        common = dict(adapter_weight=cfg.adapter.image_adapt_weight,
                      adapt_until=cfg.adapter.image_adapt_until)
        jkw = dict(adapters=trainable["image_adapter"]["layer_adapters"], **common)
        tkw = dict(adapters=tt["image_adapter"]["layer_adapters"], **common)
    ref = jquant.calibrate_ln_amax(frozen["visual"], cfg.clip.vision,
                                   jnp.asarray(images), act_name=cfg.clip.act, **jkw)
    out = tquant.calibrate_ln_amax(tf["visual"], tcfg.clip.vision, images,
                                   act_name=tcfg.clip.act, **tkw)
    for site in ("qkv", "c_fc"):
        assert out[site].shape == ref[site].shape and out[site].dtype == np.float32
        np.testing.assert_allclose(out[site], ref[site], rtol=1e-5, atol=1e-6)
    ratio = tquant.activation_outlier_ratio(out)
    ref_ratio = jquant.activation_outlier_ratio(ref)
    for site in ratio:
        np.testing.assert_allclose(ratio[site], ref_ratio[site], rtol=1e-5)


@pytest.mark.parametrize("scope", ["all", "attn", "mlp"])
def test_smooth_backbone_matches_jax_and_is_float_identity(outlier_model, scope):
    """The fold equals the JAX package's (rtol 1e-6) and leaves the float
    forward unchanged up to rounding (the JAX test's rtol 2e-3 / atol 5e-4)."""
    cfg, frozen, tcfg, tf, images = outlier_model
    stats = jquant.calibrate_ln_amax(frozen["visual"], cfg.clip.vision,
                                     jnp.asarray(images), act_name=cfg.clip.act)
    js = jquant.smooth_backbone(frozen, stats, alpha=0.5, scope=scope)
    ts = tquant.smooth_backbone(tf, stats, alpha=0.5, scope=scope)
    assert tquant.activation_outlier_ratio(stats)["qkv"] > 10
    for i, block in enumerate(ts["visual"]["blocks"]):
        jb = js["visual"]["blocks"]
        for ln in ("ln_1", "ln_2"):
            for k in ("scale", "bias"):
                np.testing.assert_allclose(block[ln][k].numpy(), np.asarray(jb[ln][k][i]),
                                           rtol=1e-6, atol=1e-9)
        np.testing.assert_allclose(block["attn"]["qkv"]["w"].numpy(),
                                   np.asarray(jb["attn"]["qkv"]["w"][i]), rtol=1e-6, atol=1e-9)
        np.testing.assert_allclose(block["mlp"]["c_fc"]["w"].numpy(),
                                   np.asarray(jb["mlp"]["c_fc"]["w"][i]), rtol=1e-6, atol=1e-9)
    moved = not np.allclose(ts["visual"]["blocks"][0]["ln_1"]["scale"].numpy(),
                            tf["visual"]["blocks"][0]["ln_1"]["scale"].numpy())
    assert moved == (scope in ("all", "attn"))
    x = torch.from_numpy(images)
    pooled, taps, _ = tclip.vision_forward(tf["visual"], tcfg.clip.vision, x,
                                           out_layers=tcfg.adapter.levels)
    pooled_s, taps_s, _ = tclip.vision_forward(ts["visual"], tcfg.clip.vision, x,
                                               out_layers=tcfg.adapter.levels)
    for a, b in zip([pooled_s, *taps_s], [pooled, *taps]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-3, atol=5e-4)


@pytest.mark.parametrize("tier", TIERS + ["int8+smooth"])
def test_quantized_vision_forward_matches_jax(model, tier):
    """A quantized JAX pytree crosses the bridge with its integers, and the
    towers agree on it (fp32: the unfused int8 route in both packages).
    Quantization is discontinuous: a last-bit difference upstream (the two
    LayerNorms sum in different orders) flips a rounding now and then, and
    one flipped step is 1/127 of its row's largest value. So the towers are
    held to 2e-2 of the output range (four quantized blocks deep), not to
    float32 rounding."""
    cfg, frozen, trainable, tcfg, tf, tt = model
    images = np.random.default_rng(8).standard_normal((2, 3, IMG, IMG)).astype(np.float32)
    jq = jquant.quantize_backbone_auto(frozen, tier, cfg=cfg, trainable=trainable)
    bridged, _ = params_from_jax(jax.tree.map(np.asarray, jq), None, tcfg,
                                 device="cpu", dtype=torch.float32)
    for i, block in enumerate(bridged["visual"]["blocks"]):
        for half, name in (("attn", "qkv"), ("mlp", "c_proj")):
            jp = jq["visual"]["blocks"][half][name]
            if "w_q" in jp:
                assert block[half][name]["w_q"].dtype == torch.int8
                np.testing.assert_array_equal(block[half][name]["w_q"].numpy(),
                                              np.asarray(jp["w_q"][i]))
                assert tuple(block[half][name]["scale"].shape) == (1, jp["w_q"].shape[-1])
    ref_pooled, ref_taps, _ = jclip.vision_forward(
        jq["visual"], cfg.clip.vision, jnp.asarray(images), out_layers=(2, 4))
    for params in (bridged, tquant.quantize_backbone_auto(tf, tier, cfg=tcfg, trainable=tt)):
        pooled, taps, _ = tclip.vision_forward(params["visual"], tcfg.clip.vision,
                                               torch.from_numpy(images), out_layers=(2, 4))
        for t, j in zip([pooled, *taps], [ref_pooled, *ref_taps]):
            j = np.asarray(j)
            np.testing.assert_allclose(t.numpy(), j, atol=2e-2 * np.abs(j).max(), rtol=0)


def test_detector_quantize_matches_jax(model):
    """AnomalyDetector(quantize=...) against the JAX detector, fp32."""
    from aa_clip_iqm_tpu.serving import AnomalyDetector as JaxDetector

    cfg, frozen, trainable, tcfg, tf, tt = model
    imgs = np.random.default_rng(4).integers(0, 256, (3, 3, IMG, IMG), dtype=np.uint8)
    jdet = JaxDetector(frozen, trainable, cfg, "MVTec", img_size=IMG,
                       compute_dtype=jnp.float32, use_pallas=False, quantize="int8")
    tdet = AnomalyDetector(tf, tt, tcfg, "MVTec", img_size=IMG,
                           compute_dtype=torch.float32, quantize="int8", device="cpu")
    assert "w_q" in tdet.frozen["visual"]["blocks"][0]["mlp"]["c_fc"]
    assert "w" in tf["visual"]["blocks"][0]["mlp"]["c_fc"]          # input untouched
    jmaps, jscores = jdet.predict(imgs, "screw")
    tmaps, tscores = tdet.predict(imgs, "screw")
    np.testing.assert_allclose(tmaps, jmaps, atol=1e-3 * np.abs(jmaps).max(), rtol=0)
    np.testing.assert_allclose(tscores, jscores, atol=1e-3)
    with pytest.raises(ValueError, match="unknown quantization tier"):
        AnomalyDetector(tf, tt, tcfg, "MVTec", img_size=IMG, quantize="int8-mlp",
                        device="cpu")
