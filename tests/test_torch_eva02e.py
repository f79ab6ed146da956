"""EVA02-CLIP-E/14+'s post-norm vision tower in the port against the
benchmark's plain float32 reference (``benchmark/reference/eva02e.py``), and
its kernels against their plain versions.

On the CPU at a tiny post-norm config (``configs.tiny_eva_postnorm_config``:
width 112, 4 heads of 28, the published ``mlp_ratio`` (hidden 960), 4
blocks, taps (2, 4), 56 px), in float32, on seeded random weights made as
the benchmark makes them (``benchmark/inputs.fill``): one block, the tower,
the anchors, the detector's maps and scores; the stock chain and the
autograd route; the registry, the configuration's selection of the block
and the IQM width; the row pass's and the 112-wide attention's plain
versions; the kernel names that the benchmark's readers match. Planted
faults (the block run pre-norm, the heads scaled by 64^-0.5, v's bias
put on k, LayerNorms of eps 1e-5) must fail the same tolerance.

Tolerances: the port and the reference compute the same float32 function
with sums in other orders (the reference's patch embedding is a conv2d,
its attention a few heads at a time, its LayerNorm PyTorch's where the
port's row pass takes two passes of its own), so each element may differ by
a few float32 ulps of its row's scale, compounded over 4 blocks: max |port -
ref| <= 1e-5 * max(1, max |ref|) holds them with room (the port reads
2e-6 of that scale). The fault tests run on weights whose out-projections
and fc2 are scaled by 1e-2, so that the branch outputs' variance (about
1e-4 of the unscaled) lies near the LayerNorms' eps and the eps fault moves
elements by more than the tolerance; every planted fault moves elements by
1e-3 or more of that scale. The plain versions in float32 are held to the
stock calls within 1e-5 of the output's scale.

Marked ``cuda`` (skipped without a card): B1's 112-wide instance at
(16, 1370, 16 x 112) and ragged lengths, the tiny block raising where the
kernels refuse it (float32, width 112), the row pass at the cell's rows,
the block's products, and the whole bf16 block against the chain's
function, in bf16 ulps, with planted faults failing there too. This file
imports no JAX, so on a machine with a card:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_eva02e.py -q
"""
import json
import re

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._pytree import tree_map

from aa_clip_iqm_tpu_torch import configs as tconfigs
from aa_clip_iqm_tpu_torch.loader import build_model_config, init_trainable, random_backbone
from aa_clip_iqm_tpu_torch.models import clip as tclip
from aa_clip_iqm_tpu_torch.ops import _build
from aa_clip_iqm_tpu_torch.ops import attention as tattn
from aa_clip_iqm_tpu_torch.ops import gemm as tgemm
from aa_clip_iqm_tpu_torch.ops import packed_attention as pa
from aa_clip_iqm_tpu_torch.ops import postnorm
from aa_clip_iqm_tpu_torch.ops.compare import (BF16_MAX_ULPS, BF16_RMS_ULPS, WALK_MAX_ULPS,
                                                bf16_error)
from aa_clip_iqm_tpu_torch.ops.gemm import gemm_bias_act_reference, gemm_f32_reference
from aa_clip_iqm_tpu_torch.ops.layers import gelu, layer_norm, linear
from aa_clip_iqm_tpu_torch.serving import AnomalyDetector
from aa_clip_iqm_tpu_torch.tools import trace_summary
from aa_clip_iqm_tpu_torch.utils import profiling
from benchmark import inputs
from benchmark.harness import load_module
from benchmark.reference import eva02e as ref
from benchmark.reference import model as ref_model

IMG = 56
F32_TOL = 1e-5
CPU = torch.device("cpu")


def _close(out, want, tol=F32_TOL) -> bool:
    want = want.float()
    return (out.float() - want).abs().max().item() <= tol * max(1.0, want.abs().max().item())


def _make(seed=11, branch_scale=1.0):
    cfg = build_model_config("tiny-eva-postnorm-test", img_size=IMG)
    frozen = inputs.fill(random_backbone(cfg, device="meta", dtype=torch.float32), seed, CPU)
    trainable = inputs.fill(init_trainable(cfg, device="meta", dtype=torch.float32), seed + 1,
                            CPU)
    if branch_scale != 1.0:
        for blk in frozen["visual"]["blocks"]:
            for p in (blk["attn"]["out"], blk["mlp"]["c_proj"]):
                p["w"] = p["w"] * branch_scale
                p["b"] = p["b"] * branch_scale
    return cfg, frozen, trainable


@pytest.fixture(scope="module")
def tiny():
    torch.set_num_threads(1)
    return _make()


@pytest.fixture(scope="module")
def small_branches():
    """The tiny tower with its branch outputs' variance near the LayerNorms'
    eps (the fault tests' weights)."""
    torch.set_num_threads(1)
    return _make(21, branch_scale=1e-2)


def _ref_cfg(cfg):
    """The benchmark configuration file's keys that the reference reads."""
    v, a = cfg.clip.vision, cfg.adapter
    return {"vision": {"width": v.width, "head_width": v.head_width},
            "adapter": {"image_adapt_until": a.image_adapt_until,
                        "image_adapt_weight": a.image_adapt_weight, "levels": list(a.levels),
                        "relu": a.relu, "text_adapt_until": a.text_adapt_until,
                        "text_adapt_weight": a.text_adapt_weight},
            "text": {"context_length": cfg.clip.text.context_length, "heads": cfg.clip.text.heads},
            "iqm": {"layer_norm_eps": cfg.iqm.layer_norm_eps,
                    "num_attention_heads": cfg.iqm.num_attention_heads,
                    "fuse": [cfg.iqm.fuse_self, cfg.iqm.fuse_visual, cfg.iqm.fuse_text]},
            "fusion": {"text_weight": 0.6, "iqm_weight": 0.4},
            "patch_size": v.patch_size, "img_size": v.image_size}


def _images(n, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (n, 3, IMG, IMG)).astype(np.float32))


def _tower(model, images, use_pallas=True):
    cfg, frozen, trainable = model
    a = cfg.adapter
    return tclip.vision_forward(frozen["visual"], cfg.clip.vision, images,
                                out_layers=tuple(a.levels),
                                adapters=trainable["image_adapter"]["layer_adapters"],
                                adapter_weight=a.image_adapt_weight,
                                adapt_until=a.image_adapt_until, use_pallas=use_pallas)


def _ref_tower(model, images):
    cfg, frozen, trainable = model
    return ref.vision(frozen["visual"], _ref_cfg(cfg), images,
                      trainable["image_adapter"]["layer_adapters"],
                      frozen["visual"]["positional_embedding"])


def _tower_matches(model, images) -> bool:
    cfg, frozen, _ = model
    with torch.no_grad():
        pooled, taps, x = _tower(model, images)
        rtaps, rx = _ref_tower(model, images)
    eps = cfg.clip.vision.ln_eps
    tokens = [layer_norm(frozen["visual"]["ln_post"], t[:, 1:], eps=eps) for t in taps]
    return (_close(x, rx) and _close(pooled, ref.pooled(frozen["visual"], rx))
            and all(_close(t, r) for t, r in zip(tokens, rtaps)))


# --------------------------------------------------------------------------
# The configuration
# --------------------------------------------------------------------------

def test_registry_gives_the_published_widths():
    cfg = tconfigs.get_model_config("EVA02-CLIP-bigE-14-plus")
    v, t = cfg.vision, cfg.text
    assert isinstance(v, tconfigs.Eva02VisionConfig) and v.postnorm
    assert (v.image_size, v.patch_size, v.width, v.layers, v.heads, v.head_width) == (
        224, 14, 1792, 64, 16, 112)
    assert (v.mlp_hidden, v.ln_eps, cfg.embed_dim) == (15360, 1e-6, 1024)
    assert (t.width, t.layers, t.heads, t.context_length, t.vocab_size) == (1280, 32, 20, 77, 49408)
    assert cfg.act == "gelu"
    assert "EVA02-CLIP-bigE-14-plus" not in tconfigs.list_models()
    assert tconfigs.is_port_model("EVA02-CLIP-bigE-14-plus")
    assert not tconfigs.is_port_model("ViT-L-14-336")
    mc = build_model_config("EVA02-CLIP-bigE-14-plus", img_size=518)
    assert tclip.block_runner(mc.clip.vision, CPU).func is tclip._run_eva_postnorm_block


_BASE_VISION = {"image_size": 28, "layers": 1, "width": 112, "head_width": 28,
                "mlp_ratio": 8.571428571428571, "patch_size": 14, "pt_hw_seq_len": 16,
                "eva_model_name": "eva-test"}


@pytest.mark.parametrize("keys,bad", [
    ({"postnorm": True, "rope": True}, "rope"),
    ({"postnorm": True, "subln": True}, "subln"),
    ({"postnorm": True, "naiveswiglu": True}, "naiveswiglu"),
    ({}, "postnorm"),
    ({"rope": True, "intp_freq": True, "naiveswiglu": True, "subln": True, "postnorm": True},
     "postnorm"),
    ({"rope": True}, "intp_freq"),
])
def test_an_eva_config_asking_for_another_block_is_refused(tmp_path, monkeypatch, keys, bad):
    """Each EVA setting combination other than EVA-02's four or ``postnorm``
    alone raises, naming the keys; an ``eva_model_name`` never falls
    through to CLIP's block."""
    raw = {"embed_dim": 8, "text_cfg": {"context_length": 77, "vocab_size": 49408, "width": 8,
                                        "heads": 2, "layers": 1},
           "vision_cfg": dict(_BASE_VISION, **keys)}
    (tmp_path / "Other.json").write_text(json.dumps(raw))
    monkeypatch.setattr(tconfigs, "_PORT_CONFIG_DIR", str(tmp_path))
    with pytest.raises(NotImplementedError, match=bad):
        tconfigs.get_model_config("Other")


@pytest.mark.parametrize("keys,postnorm", [({"postnorm": True}, True),
                                           ({"rope": True, "intp_freq": True,
                                             "naiveswiglu": True, "subln": True}, False)])
def test_the_eva_settings_select_the_block(tmp_path, monkeypatch, keys, postnorm):
    raw = {"embed_dim": 8, "text_cfg": {"context_length": 77, "vocab_size": 49408, "width": 8,
                                        "heads": 2, "layers": 1},
           "vision_cfg": dict(_BASE_VISION, **keys)}
    (tmp_path / "Other.json").write_text(json.dumps(raw))
    monkeypatch.setattr(tconfigs, "_PORT_CONFIG_DIR", str(tmp_path))
    v = tconfigs.get_model_config("Other").vision
    assert isinstance(v, tconfigs.Eva02VisionConfig) and v.postnorm == postnorm
    assert v.mlp_hidden == 960


@pytest.mark.parametrize("name,img,want", [("EVA02-CLIP-bigE-14-plus", 518, 1024),
                                           ("EVA02-CLIP-L-14-336", 518, 768),
                                           ("ViT-L-14-336", 518, 768),
                                           ("ViT-B-16-plus-240", 240, 768),
                                           ("RN50", 224, 768)])
def test_iqm_text_width(name, img, want):
    """The port's own models take IQM's text width from embed_dim, the
    anchors' width; the JAX registry's keep the JAX package's 768 (ViT-L,
    whose embed_dim is 768, and ViT-B-16-plus-240, whose 640 the JAX
    package does not follow either). The text adapter's projection maps the
    text width to embed_dim: for the JAX registry's ViT towers the JAX
    package's (text width, text width), as the two widths agree there. RN50,
    whose text width (512) is not its embed_dim (1024), has no trainable
    layout in either package."""
    import jax
    from aa_clip_iqm_tpu.loader import build_model_config as jax_build
    from aa_clip_iqm_tpu.models.adapters import init_adapter_params

    mc = build_model_config(name, img_size=img)
    assert mc.iqm.text_encoder_hidden_size == want
    if tconfigs.is_port_model(name):
        jax_proj = None
    else:
        jc = jax_build(name, img_size=img)
        assert want == jc.iqm.text_encoder_hidden_size
        if name == "RN50":
            with pytest.raises(ValueError, match="ViT vision tower"):
                init_adapter_params(jax.random.PRNGKey(0), jc)
            with pytest.raises(ValueError, match="ViT vision tower"):
                init_trainable(mc, device="meta")
            return
        jax_proj = jax.eval_shape(lambda: init_adapter_params(jax.random.PRNGKey(0), jc))
        jax_proj = jax_proj["text_adapter"]["proj"]["w"].shape
    tr = init_trainable(mc, device="meta")
    assert tr["text_feature_proj"]["w"].shape == (want, want)
    proj = tr["text_adapter"]["proj"]["w"].shape
    assert proj == (mc.clip.text.width, mc.clip.embed_dim)
    assert jax_proj is None or proj == jax_proj


def test_random_backbone_is_the_post_norm_tree():
    mc = build_model_config("EVA02-CLIP-bigE-14-plus", img_size=518)
    f = random_backbone(mc, device="meta")
    blk = f["visual"]["blocks"][0]
    assert len(f["visual"]["blocks"]) == 64
    assert set(blk) == {"ln_1", "attn", "ln_2", "mlp"}
    assert set(blk["attn"]) == {"qkv", "q", "v", "out"} and "b" not in blk["attn"]["qkv"]
    assert blk["attn"]["qkv"]["w"].shape == (1792, 5376)
    assert blk["mlp"]["c_fc"]["w"].shape == (1792, 15360)
    assert blk["mlp"]["c_proj"]["w"].shape == (15360, 1792)
    assert f["visual"]["positional_embedding"].shape == (37 * 37 + 1, 1792)
    assert "ln_pre" not in f["visual"] and f["visual"]["head"]["b"].shape == (1024,)
    assert abs(sum(t.numel() for t in _leaves(blk)) / 67.9e6 - 1) < 0.01


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


# --------------------------------------------------------------------------
# The port against the reference
# --------------------------------------------------------------------------

def test_block_matches_reference(tiny):
    cfg, frozen, _ = tiny
    v = cfg.clip.vision
    x = torch.randn(2, v.num_patches + 1, v.width, generator=torch.Generator().manual_seed(3))
    blk = frozen["visual"]["blocks"][1]
    with torch.no_grad():
        got = tclip._run_eva_postnorm_block(blk, x, v.heads, eps=v.ln_eps)
        want = ref.block(blk, x, v.heads)
    assert _close(got, want)


def test_tower_matches_reference(tiny):
    assert _tower_matches(tiny, _images(2))


def test_anchors_match_reference(tiny):
    cfg, frozen, trainable = tiny
    det = AnomalyDetector(frozen, trainable, cfg, "MVTec", img_size=IMG,
                          compute_dtype=torch.float32, device="cpu")
    want = ref_model.text_anchors(frozen, trainable, _ref_cfg(cfg), CPU)
    assert set(want) == set(det.anchors)
    for c, w in want.items():
        assert _close(det.anchors[c], w, 1e-4), c


def test_detector_maps_and_scores_match_reference(tiny):
    """``predict_multi`` of the port against the reference's maps and
    scores on the port's anchors (1e-4: the maps pass the taps through
    100x similarities and two resizes)."""
    cfg, frozen, trainable = tiny
    det = AnomalyDetector(frozen, trainable, cfg, "MVTec", img_size=IMG,
                          compute_dtype=torch.float32, batch_buckets=(4,), device="cpu")
    names = det.class_names()[:3]
    u8 = np.random.default_rng(5).integers(0, 256, (3, 3, IMG, IMG), np.uint8)
    before = profiling.counters()
    maps, scores = det.predict_multi(u8, names)
    n = profiling.counters()["blocks.eva_postnorm"] - before.get("blocks.eva_postnorm", 0)
    assert n >= cfg.clip.vision.layers
    anchors = torch.stack([det.anchors[c].float() for c in names])
    with torch.no_grad(), ref.in_clips_place():
        rmaps, rscores = ref_model.predict(frozen, trainable, _ref_cfg(cfg), torch.from_numpy(u8),
                                           anchors, frozen["visual"]["positional_embedding"])
    assert _close(torch.from_numpy(maps), rmaps, 1e-4)
    assert _close(torch.from_numpy(scores), rscores, 1e-4)
    assert ref_model.vision is not ref.vision


@pytest.mark.parametrize("route", ["stock", "autograd"])
def test_chain_routes_match_reference(tiny, route):
    """``use_pallas=False`` and a forward under autograd run the stock chain
    (cuBLAS products rounded each, ``layer_norm``, the stock attention): the
    same function; only the latter counts ``postnorm.chain``."""
    images = _images(2, seed=1)
    before = profiling.counters().get("postnorm.chain", 0)
    if route == "stock":
        with torch.no_grad():
            _, _, x = _tower(tiny, images, use_pallas=False)
    else:
        images.requires_grad_(True)
        _, _, x = _tower(tiny, images)
        x.sum().backward()
        assert images.grad is not None and images.grad.abs().sum() > 0
    with torch.no_grad():
        _, rx = _ref_tower(tiny, images.detach())
    assert _close(x.detach(), rx)
    chain = profiling.counters().get("postnorm.chain", 0) - before
    assert chain == (0 if route == "stock" else 2 * tiny[0].clip.vision.layers)


@pytest.mark.parametrize("needs_grad,route", [(None, "postnorm.fused"),
                                              ("x", "postnorm.chain"),
                                              ("weight", "postnorm.chain")])
def test_the_block_takes_the_chain_only_where_a_gradient_is_recorded(tiny, needs_grad, route):
    cfg, frozen, _ = tiny
    v = cfg.clip.vision
    blk = tree_map(lambda t: t.detach().clone(), frozen["visual"]["blocks"][0])
    x = torch.randn(2, v.grid ** 2 + 1, v.width, generator=torch.Generator().manual_seed(6))
    if needs_grad == "x":
        x.requires_grad_(True)
    elif needs_grad == "weight":
        blk["mlp"]["c_proj"]["w"].requires_grad_(True)
    before = profiling.counters()
    assert torch.is_grad_enabled()
    got = tclip._run_eva_postnorm_block(blk, x, v.heads, eps=v.ln_eps)
    after = profiling.counters()
    other = ({"postnorm.fused", "postnorm.chain"} - {route}).pop()
    assert after[route] - before.get(route, 0) == 2
    assert after.get(other, 0) == before.get(other, 0)
    assert after["blocks.eva_postnorm"] - before.get("blocks.eva_postnorm", 0) == 1
    assert got.requires_grad == (needs_grad is not None)
    with torch.no_grad():
        want = ref.block(blk, x.detach(), v.heads)
    assert _close(got.detach(), want)


def test_the_block_refuses_masks_and_value_value_attention(tiny):
    cfg, frozen, _ = tiny
    v = cfg.clip.vision
    x = torch.zeros(1, 17, v.width)
    for kw in ({"vv": True}, {"attn_mask": torch.zeros(17, 17)}):
        with pytest.raises(NotImplementedError, match="post-norm"):
            tclip._run_eva_postnorm_block(frozen["visual"]["blocks"][0], x, v.heads,
                                          eps=v.ln_eps, **kw)


# --------------------------------------------------------------------------
# Planted faults
# --------------------------------------------------------------------------

def prenorm_block(block, x, num_heads, act=None, attn_mask=None, vv=False, valid_len=None,
                  fused_mlp=True, use_pallas=True, *, eps):
    """The post-norm block's planted fault: its LayerNorms moved before the
    branches (pre-norm), on the program's own calls."""
    attn, mlp = block["attn"], block["mlp"]
    h = layer_norm(block["ln_1"], x, eps=eps)
    qkv = linear({"w": attn["qkv"]["w"], "b": tclip._qkv_bias(attn["q"]["b"], attn["v"]["b"])},
                 h)
    o = tattn.attend_qkv(qkv, num_heads, valid_len=valid_len, use_pallas=use_pallas)
    x = x + linear(attn["out"], o)
    h = gelu(linear(mlp["c_fc"], layer_norm(block["ln_2"], x, eps=eps)))
    return x + linear(mlp["c_proj"], h)


def scaled_by_64(real):
    """The attention at the scale 64^-0.5 where the tower's heads take
    head_width^-0.5 (masked calls, the text tower's, pass through)."""
    def attend(qkv, num_heads, attn_mask=None, valid_len=None, use_pallas=True):
        if attn_mask is not None:
            return real(qkv, num_heads, attn_mask=attn_mask, valid_len=valid_len,
                        use_pallas=use_pallas)
        return tattn.flash_mha_packed(qkv, num_heads, 64 ** -0.5, valid_len=valid_len)
    return attend


FAULTS = ("prenorm", "scale_64", "k_bias", "eps_1e-5")


def plant(monkeypatch, fault):
    """Plant ``fault`` in the program (the benchmark's test and its readings
    on the card plant the same)."""
    if fault == "prenorm":
        monkeypatch.setattr(tclip, "_run_eva_postnorm_block", prenorm_block)
    elif fault == "scale_64":
        monkeypatch.setattr(tattn, "attend_qkv", scaled_by_64(tattn.attend_qkv))
    elif fault == "k_bias":
        # v's bias on k: a bias on k alone moves every logit of a query row
        # by one constant, q . b, which the softmax takes out.
        monkeypatch.setattr(tclip, "_qkv_bias", lambda q_b, v_b: torch.cat(
            (q_b.float(), v_b.float(), torch.zeros_like(v_b, dtype=torch.float32))))
    elif fault == "eps_1e-5":
        monkeypatch.setattr(tconfigs.Eva02VisionConfig, "ln_eps", 1e-5)


def test_the_fault_weights_match_when_sound(small_branches):
    assert _tower_matches(small_branches, _images(2, seed=2))


@pytest.mark.parametrize("fault", FAULTS)
def test_planted_faults_fail(small_branches, monkeypatch, fault):
    plant(monkeypatch, fault)
    assert not _tower_matches(small_branches, _images(2, seed=2))


# --------------------------------------------------------------------------
# Plain versions
# --------------------------------------------------------------------------

@pytest.mark.parametrize("m,d", [(37, 112), (5, 1792)])
def test_row_pass_plain_version_is_x_plus_layer_norm(m, d):
    g = torch.Generator().manual_seed(d)
    z, x = torch.randn(m, d, generator=g) * 3 + 1, torch.randn(m, d, generator=g)
    bias = torch.randn(d, generator=g) * 0.02
    ln = {"scale": 1 + 0.02 * torch.randn(d, generator=g), "bias": 0.02 * torch.randn(d, generator=g)}
    got = postnorm.ln_residual_rows(z, bias, ln, x)
    want = x + torch.nn.functional.layer_norm(z + bias, (d,), ln["scale"], ln["bias"], 1e-6)
    assert _close(got, want)
    assert postnorm.ln_residual_rows(z, bias, ln, x.to(torch.bfloat16)).dtype == torch.bfloat16


@pytest.mark.parametrize("seq_len,valid_len", [(1370, None), (200, 130), (129, None)])
def test_112_wide_attention_plain_versions_match_sdpa(seq_len, valid_len):
    """The twin and the plain version of the walk at 16 heads of 112 (4 at
    the ragged lengths) against SDPA on split heads in float32."""
    heads = 16 if seq_len == 1370 else 4
    g = torch.Generator().manual_seed(seq_len)
    qkv = torch.randn(1, seq_len, 3 * heads * 112, generator=g)
    q, k, v = (t.reshape(1, seq_len, heads, 112).transpose(1, 2) for t in qkv.chunk(3, -1))
    mask = None
    if valid_len is not None:
        mask = torch.where(torch.arange(seq_len) < valid_len, 0.0, float("-inf"))[None, :]
    want = torch.nn.functional.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                            scale=112 ** -0.5)
    want = want.transpose(1, 2).reshape(1, seq_len, heads * 112)
    assert _close(pa.flash_mha_packed_reference(qkv, heads, 112 ** -0.5, valid_len=valid_len),
                  want)
    assert _close(pa.flash_mha_packed_stages(qkv, heads, 112 ** -0.5, valid_len=valid_len), want)
    assert tattn.packed_ok(qkv, heads, None, heads * 112) == (seq_len >= 256)


def test_the_block_s_products_are_the_core_s_plain_versions_on_the_cpu():
    g = torch.Generator().manual_seed(1)
    a, w, b = torch.randn(7, 64, generator=g), torch.randn(64, 256, generator=g), torch.randn(256)
    assert torch.equal(postnorm.gemm_act(a, w, b, gelu), gemm_bias_act_reference(a, w, b, gelu))
    assert torch.equal(postnorm.gemm_f32(a.to(torch.bfloat16), w.to(torch.bfloat16)),
                       gemm_f32_reference(a.to(torch.bfloat16), w.to(torch.bfloat16)))


def _fake_block(d, h, dtype, device="cuda"):
    def e(*shape):
        return torch.empty(shape, dtype=dtype, device=device)

    return {"attn": {"qkv": {"w": e(d, 3 * d)}, "out": {"w": e(d, d)}},
            "mlp": {"c_fc": {"w": e(d, h)}, "c_proj": {"w": e(h, d)}}}


def test_the_gate_takes_every_cpu_call_and_the_card_s_widths_only(tiny):
    """``check_postnorm`` passes every CPU call and, on (fake) CUDA tensors,
    bf16 at the card's widths alone; anything else raises, naming why."""
    blk = tiny[1]["visual"]["blocks"][0]
    postnorm.check_postnorm(torch.zeros(1, 17, 112), blk)
    bf = torch.bfloat16
    with FakeTensorMode():
        def e(*shape, dtype=bf):
            return torch.empty(shape, dtype=dtype, device="cuda")

        x = e(2, 1370, 1792)
        postnorm.check_postnorm(x, _fake_block(1792, 15360, bf))
        for xs, block, why in (
                (e(2, 1370, 1792, dtype=torch.float32), _fake_block(1792, 15360, bf),
                 "float32, not bfloat16"),
                (e(1370, 1792), _fake_block(1792, 15360, bf), "2 dimensions"),
                (x.transpose(0, 1), _fake_block(1792, 15360, bf), "not contiguous"),
                (e(2, 17, 112), _fake_block(112, 960, bf), "width 112"),
                (e(2, 17, 2304), _fake_block(2304, 9216, bf), "width 2304"),
                (e(2, 17, 256), _fake_block(256, 2200, bf), "hidden width 2200"),
                (x, _fake_block(1792, 15360, torch.float32), "weights qkv, out, c_fc, c_proj")):
            with pytest.raises(ValueError, match=why):
                postnorm.check_postnorm(xs, block)


# --------------------------------------------------------------------------
# The GEMM core's tile order
# --------------------------------------------------------------------------

# An H100 SXM as torch reads it: 132 SMs, 50 MiB of L2.
H100 = {"sms": 132, "l2_bytes": 50 * 2 ** 20}


@pytest.mark.parametrize("group", [1, 3, 16, 200])
@pytest.mark.parametrize("n_tiles", [1, 7, 60])
@pytest.mark.parametrize("m", [1, 130, 21920])
def test_the_tile_order_is_a_permutation_of_every_tile(m, n_tiles, group):
    """The plain version of the core's order takes each tile once: ragged
    M, bands that do not divide the M-tiles (3), and bands wider than them
    (200). Bands of one M-tile are the N-fastest order."""
    m_tiles = -(-m // tgemm.TILE_M)
    order = tgemm.tile_order(m_tiles, n_tiles, group)
    assert sorted(order) == [(i, j) for i in range(m_tiles) for j in range(n_tiles)]
    if group == 1:
        assert order == [(t // n_tiles, t % n_tiles) for t in range(m_tiles * n_tiles)]


def test_a_wave_in_a_band_spans_the_band_s_m_tiles_and_few_n_tiles():
    """W1's order at batch 16 (172 x 60 tiles) in bands of 16: any 132
    tiles in a row inside a band take its 16 M-tiles and at most 10 of the
    60 N-tiles, where the N-fastest order takes all 60 and 3 M-tiles."""
    order = tgemm.tile_order(172, 60, 16)
    for start in range(0, 960 - 132, 7):
        wave = order[start:start + 132]
        assert len({m for m, _ in wave}) == 16 and len({n for _, n in wave}) <= 10
    flat = tgemm.tile_order(172, 60, 1)[:132]
    assert len({n for _, n in flat}) == 60 and len({m for m, _ in flat}) == 3


# The bf16 core's products in the other cells, (M, N, K, tile_n[, pairs]):
# tile_n 0 is the core's choice, the dual mode takes 128 and two pairs.
OTHER_CELLS = {
    "518 px B2 GEMM 1, batch 32": (43840, 4096, 1024, 0),
    "518 px B2 GEMM 2, batch 32": (43840, 1024, 4096, 0),
    "518 px B8 front, batch 32": (43840, 3072, 1024, 0),
    "518 px B8 back, batch 32": (43840, 1024, 1024, 0),
    "1274 px B2 GEMM 1, batch 8": (66256, 4096, 1024, 0),
    "1274 px B2 GEMM 2, batch 8": (66256, 1024, 4096, 0),
    "1274 px B8 front, batch 8": (66256, 3072, 1024, 0),
    "1274 px B8 back, batch 8": (66256, 1024, 1024, 0),
    "training B2 GEMM 1, batch 8": (10960, 4096, 1024, 0),
    "training B2 GEMM 2, batch 8": (10960, 1024, 4096, 0),
    "training B5 dual, batch 8": (10960, 4096, 1024, 128, 2),
    "training B5 GEMM 3, batch 8": (10960, 1024, 4096, 0),
    "training B8 front, batch 8": (10960, 3072, 1024, 0),
    "training B8 back, batch 8": (10960, 1024, 1024, 0),
    "ViT-L text tower GEMM 1": (1155, 3072, 768, 0),
    "ViT-L text tower GEMM 2": (1155, 768, 3072, 0),
    "ViT-L text tower, 40 prompts a class": (46200, 3072, 768, 0),
    "bigG text tower GEMM 1": (46200, 5120, 1280, 0),
    "bigG text tower GEMM 2": (46200, 1280, 5120, 0),
    "EVA02-CLIP-L B8 front, batch 32": (43840, 3072, 1024, 0),
    "EVA02-CLIP-L B8 back, batch 32": (43840, 1024, 1024, 0),
    "P1 W2, batch 16": (21920, 1792, 15360, 0),
    "P1 out-projection, batch 16": (21920, 1792, 1792, 0),
}


@pytest.mark.parametrize("product", sorted(OTHER_CELLS))
def test_the_rule_keeps_the_n_fastest_order_for_the_other_products(product):
    """Their weights stay in L2 from wave to wave, or (W2's seven N-tiles)
    a wave spans every N-tile anyway: the launch is the N-fastest one."""
    m, n, k, tile_n, *pairs = OTHER_CELLS[product]
    assert tgemm.tile_group(m, n, k, tile_n or (256 if n % 256 == 0 else 128), **H100,
                            pairs=pairs[0] if pairs else 1) == 1


@pytest.mark.parametrize("m,want", [(21920, 16), (21843, 16), (1370, 11), (130, 1), (1, 1)])
def test_the_rule_bands_w1(m, want):
    """EVA02-CLIP-E/14+'s W1 (a 55 MB weight, more than the L2) in bands of
    sqrt(132 x 256 / 128) = 16 M-tiles, or of all of them below 16; one
    wave's worth of tiles keeps the N-fastest order."""
    assert tgemm.tile_group(m, 15360, 1792, 256, **H100) == want


def test_the_rule_keeps_a_band_s_rows_within_the_l2():
    """A band's A rows stay within half the L2: at K = 15,360 a band of 16
    M-tiles would hold 63 MB, so it takes 6 (24 MB)."""
    assert tgemm.tile_group(21920, 15360, 15360, 256, **H100) == 6


def test_grouped_launches_are_counted_once_each():
    before = profiling.counters().get(tgemm.GROUPED, 0)
    tgemm.count_grouped([1, 16, 1, 3])
    tgemm.count_grouped([1, 1])
    assert profiling.counters()[tgemm.GROUPED] - before == 2


# --------------------------------------------------------------------------
# Tracing and the benchmark's readers
# --------------------------------------------------------------------------

def test_counters_count_blocks_and_halves(tiny):
    before = profiling.counters()
    with torch.no_grad():
        _tower(tiny, _images(1))
    after = profiling.counters()
    n = tiny[0].clip.vision.layers
    assert after["blocks.eva_postnorm"] - before.get("blocks.eva_postnorm", 0) == n
    assert after["postnorm.fused"] - before.get("postnorm.fused", 0) == 2 * n
    assert after.get("postnorm.chain", 0) == before.get("postnorm.chain", 0)


# Kernel names as the profiler records them on an H100 (torch 2.11+cu128).
B1_64 = ("void aaclip::attn_fwd::(anonymous namespace)::attention_wgmma_kernel<packed_attention>"
         "(aaclip::attn_fwd::(anonymous namespace)::Maps, __nv_bfloat16*, float*, "
         "aaclip::attn_fwd::(anonymous namespace)::Layout, int, int, float)")
B7_64 = B1_64.replace("<packed_attention>", "<flash_attention>")
B1_112 = B1_64.replace("<packed_attention>", "<packed_attention_hd112>")
B2 = ("void aaclip::gemm90::(anonymous namespace)::gemm_bias_act_kernel<(anonymous namespace)::"
      "ln_mlp_residual_stage, 256, 0>(CUtensorMap, CUtensorMap, CUtensorMap, CUtensorMap, "
      "aaclip::gemm90::(anonymous namespace)::Operands, int, int, int)")
S1 = ("void (anonymous namespace)::swiglu_dual_kernel<(anonymous namespace)::"
      "ln_swiglu_residual_stage>(CUtensorMap, CUtensorMap, int)")
R1 = "void (anonymous namespace)::rope_qk_kernel(__nv_bfloat16*, float const*, int, int, int)"
P1 = [B2.replace("ln_mlp_residual_stage, 256, 0", f"eva_postnorm_stage, 256, {act}")
      for act in (0, 2)] + [B2.replace("gemm_bias_act_kernel<(anonymous namespace)::"
                                       "ln_mlp_residual_stage, 256, 0>",
                                       "gemm_f32_kernel<(anonymous namespace)::"
                                       "eva_postnorm_stage, 256, false>")]
P2 = ("void (anonymous namespace)::ln_residual_rows_kernel<(anonymous namespace)::"
      "eva_postnorm_stage, 14>(float const*, float const*, float const*, float const*, "
      "__nv_bfloat16 const*, __nv_bfloat16*, int, int, float)")
NEW = [B1_112, *P1, P2]


def _matches(reader, name):
    mod = load_module("metrics", reader)
    return (any(re.search(p, name) for p in mod.INCLUDE)
            and not any(re.search(p, name) for p in mod.EXCLUDE))


@pytest.mark.parametrize("reader,own", [("attn_fwd_roofline", [B1_64, B7_64]),
                                        ("mlp_fwd_roofline", [B2]),
                                        ("swiglu_fwd_roofline", [S1]),
                                        ("rope_roofline", [R1])])
def test_the_accepted_readers_keep_their_kernels_and_not_the_new_ones(reader, own):
    assert all(_matches(reader, n) for n in own)
    assert not any(_matches(reader, n) for n in NEW)


@pytest.mark.parametrize("reader,own", [("attn_hd112_fwd_roofline", [B1_112]),
                                        ("postnorm_gemm_roofline", P1),
                                        ("postnorm_rows_roofline", [P2])])
def test_the_new_readers_take_their_kernels_alone(reader, own):
    others = [n for n in [B1_64, B7_64, B2, S1, R1, *NEW] if n not in own]
    assert all(_matches(reader, n) for n in own)
    assert not any(_matches(reader, n) for n in others)


def test_the_trace_summary_groups_the_new_kernels():
    want = {B1_112: "B1 packed_attention_hd112", P1[0]: "P1 eva_postnorm_gemm",
            P1[2]: "P1 eva_postnorm_gemm", P2: "P2 ln_residual_rows",
            B1_64: "B1 packed_attention", B2: "B2 ln_mlp_residual"}
    assert {n: trace_summary.kernel_group(n) for n in want} == want


# --------------------------------------------------------------------------
# On the card
# --------------------------------------------------------------------------

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _ulps(out, want, base=None, max_tol=BF16_MAX_ULPS):
    torch.cuda.synchronize()
    max_ulps, rms_ulps = bf16_error(out, want, base)
    return max_ulps <= max_tol and rms_ulps <= BF16_RMS_ULPS, (max_ulps, rms_ulps)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,heads,seq_len,vv,valid_len", [
    (16, 16, 1370, False, None),
    (2, 16, 1370, True, 1300),
    (2, 4, 1, False, None),
    (2, 4, 127, False, None),
    (2, 4, 129, False, 1),
    (2, 4, 200, True, None),
    (1, 16, 8192, False, None),
])
def test_the_112_instance_matches_its_plain_versions_on_the_card(dev, dtype, b, heads, seq_len,
                                                                 vv, valid_len):
    """B1 at heads of 112 against the twin (bf16 ulps) and the plain
    version of its walk (2 ulps); the last head's second box reads past the
    section (TMA's zeros), the others' the next head's columns, which no
    product may take: a planted scale of 64^-0.5 fails."""
    gen = torch.Generator(device=dev).manual_seed(seq_len + 112)
    qkv = torch.randn((b, seq_len, 3 * heads * 112), generator=gen, device=dev).to(dtype)
    scale = 112 ** -0.5
    before = profiling.counters()
    out = pa.flash_mha_packed(qkv, heads, scale, vv=vv, valid_len=valid_len)
    assert _build.launches(before) == {"packed_attention_hd112": 1}
    twin = pa.flash_mha_packed_reference(qkv, heads, scale, vv=vv, valid_len=valid_len)
    walk = pa.flash_mha_packed_stages(qkv, heads, scale, vv, valid_len)
    if dtype == torch.float32:
        err = (out - twin).abs().max().item()
        assert err <= 1e-4 * max(1.0, twin.abs().max().item()), err
        return
    ok, err = _ulps(out, twin)
    assert ok, err
    ok, err = _ulps(out, walk, max_tol=WALK_MAX_ULPS)
    assert ok, err
    if min(seq_len, valid_len or seq_len) > 1:         # one key: softmax is 1 at any scale
        wrong = pa.flash_mha_packed_reference(qkv, heads, 64 ** -0.5, vv=vv,
                                              valid_len=valid_len)
        assert not _ulps(out, wrong)[0]


@pytest.mark.cuda
def test_the_112_instance_writes_the_log_sum_exp_on_the_card(dev):
    gen = torch.Generator(device=dev).manual_seed(3)
    qkv = torch.randn((2, 1370, 3 * 16 * 112), generator=gen, device=dev).to(torch.bfloat16)
    out, lse = pa._forward(qkv, 16, 112 ** -0.5, False, None, with_lse=True)
    want = pa.packed_lse_reference(qkv, 16, 112 ** -0.5)
    torch.cuda.synchronize()
    assert ((lse - want).abs() / want.abs().clamp_min(1.0)).max().item() <= 1e-5
    assert torch.equal(out, pa._forward(qkv, 16, 112 ** -0.5, False, None))


@pytest.mark.cuda
def test_other_head_widths_are_refused_on_the_card(dev):
    qkv = torch.zeros((1, 300, 3 * 4 * 96), device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head width 96"):
        pa.flash_mha_packed(qkv, 4, 96 ** -0.5)
    q = torch.zeros((16, 8282, 112), device=dev, dtype=torch.bfloat16)
    from aa_clip_iqm_tpu_torch.ops import flash_attention as fa
    with pytest.raises(ValueError, match="head width 112"):
        fa.flash_mha(q[None], q[None], q[None], 112 ** -0.5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,why", [(torch.float32, "float32"), (torch.bfloat16, "width 112")])
def test_the_block_raises_on_the_card_where_its_kernels_refuse(dev, tiny, dtype, why):
    """The tiny tower's block on the card, in float32 or at width 112,
    raises under ``use_pallas`` rather than run the chain; autograd's
    calls and ``use_pallas=False`` keep the chain."""
    v = tiny[0].clip.vision
    blk = tree_map(lambda t: t.detach().to(dev, dtype), tiny[1]["visual"]["blocks"][0])
    x = torch.randn(2, v.grid ** 2 + 1, v.width, device=dev).to(dtype)
    before = profiling.counters()
    with torch.no_grad(), pytest.raises(ValueError, match=why):
        tclip._run_eva_postnorm_block(blk, x, v.heads, eps=v.ln_eps)
    after = profiling.counters()
    for route in ("postnorm.fused", "postnorm.chain"):
        assert after.get(route, 0) == before.get(route, 0)
    with torch.no_grad():
        tclip._run_eva_postnorm_block(blk, x, v.heads, eps=v.ln_eps, use_pallas=False)
    tclip._run_eva_postnorm_block(blk, x.requires_grad_(True), v.heads, eps=v.ln_eps)


def _rows_inputs(dev, m, d, seed=4):
    g = torch.Generator(device=dev).manual_seed(seed)
    z = torch.randn(m, d, generator=g, device=dev) * 0.3 + 0.1
    x = (2 * torch.randn(m, d, generator=g, device=dev)).to(torch.bfloat16)
    bias = 0.02 * torch.randn(d, generator=g, device=dev)
    ln = {"scale": 1 + 0.02 * torch.randn(d, generator=g, device=dev),
          "bias": 0.02 * torch.randn(d, generator=g, device=dev)}
    return z, bias, ln, x


@pytest.mark.cuda
@pytest.mark.parametrize("m,d", [(21920, 1792), (77, 112), (3, 2048), (1, 128)])
def test_the_row_pass_matches_its_plain_version_on_the_card(dev, m, d):
    z, bias, ln, x = _rows_inputs(dev, m, d)
    before = profiling.counters()
    got = postnorm.ln_residual_rows(z, bias, ln, x)
    assert _build.launches(before) == {"ln_residual_rows": 1}
    want = postnorm.ln_residual_rows_reference(z, bias, ln, x)
    ok, err = _ulps(got, want, x)
    assert ok, err
    assert not _ulps(got, postnorm.ln_residual_rows_reference(z, bias, ln, x, eps=0.05), x)[0]
    assert not _ulps(got, postnorm.ln_residual_rows_reference(z, 0 * bias, ln, x), x)[0]


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n,act", [(21920, 1792, 5376, None), (21920, 1792, 15360, gelu),
                                       (300, 1792, 1792, None)])
def test_the_block_s_products_match_their_plain_versions_on_the_card(dev, m, k, n, act):
    g = torch.Generator(device=dev).manual_seed(n)
    a = torch.randn(m, k, generator=g, device=dev).to(torch.bfloat16)
    w = (torch.randn(k, n, generator=g, device=dev) * k ** -0.5).to(torch.bfloat16)
    b = 0.02 * torch.randn(n, generator=g, device=dev)
    ok, err = _ulps(postnorm.gemm_act(a, w, b, act), gemm_bias_act_reference(a, w, b, act))
    assert ok, err
    got = postnorm.gemm_f32(a, w)
    want = gemm_f32_reference(a, w)
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() <= 1e-5 * want.abs().max().item()


def _bf16_block(dev, d=1792, h=15360, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)

    def w(i, o):
        return (torch.randn(i, o, generator=g, device=dev) * i ** -0.5).to(torch.bfloat16)

    def vec(n, mean=0.0):
        return mean + 0.02 * torch.randn(n, generator=g, device=dev)

    return {"ln_1": {"scale": vec(d, 1.0), "bias": vec(d)},
            "attn": {"qkv": {"w": w(d, 3 * d)}, "q": {"b": vec(d)}, "v": {"b": vec(d)},
                     "out": {"w": w(d, d), "b": vec(d)}},
            "ln_2": {"scale": vec(d, 1.0), "bias": vec(d)},
            "mlp": {"c_fc": {"w": w(d, h), "b": vec(h)}, "c_proj": {"w": w(h, d), "b": vec(d)}}}


def _f32(tree):
    return {k: _f32(v) if isinstance(v, dict) else v.float() for k, v in tree.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("b,seed", [(2, 0), (2, 1)])
def test_the_bf16_block_matches_the_chain_s_function_on_the_card(dev, b, seed):
    """The block's kernels at EVA02-CLIP-E/14+'s widths (1370 tokens)
    against the chain's function, the same stock calls in float32 on the
    same bf16 input and weights: within the kernels' bf16 ulps and no
    further from it (RMS) than the bf16 chain is, with the launches the
    route promises; the pre-norm order fails."""
    blk = _bf16_block(dev, seed=seed)
    x = torch.randn(b, 1370, 1792, generator=torch.Generator(device=dev).manual_seed(9),
                    device=dev).to(torch.bfloat16)
    before = profiling.counters()
    with torch.no_grad():
        got = tclip._run_eva_postnorm_block(blk, x, 16, eps=1e-6)
    assert _build.launches(before) == {"eva_postnorm_gemm": 2, "eva_postnorm_gemm_f32": 2,
                                       "ln_residual_rows": 2, "packed_attention_hd112": 1}
    with torch.no_grad():
        exact = tclip._run_eva_postnorm_block(_f32(blk), x.float(), 16, eps=1e-6,
                                              use_pallas=False)
        chain = tclip._run_eva_postnorm_block(blk, x, 16, eps=1e-6, use_pallas=False)
        wrong = prenorm_block(blk, x, 16, eps=1e-6)
    ok, err = _ulps(got, exact, x)
    chain_err = bf16_error(chain, exact, x)
    assert ok and err[1] <= chain_err[1], (err, chain_err)
    assert not _ulps(wrong, exact, x)[0]
