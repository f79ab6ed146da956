"""SigLIP So400m/14 on the port (``configs.SiglipVisionConfig``,
``SiglipTextConfig``), on the CPU.

The tiny config ``configs.tiny_siglip_config`` (``build_model_config(
"tiny-siglip-test")``): width 144, 2 heads of 72, hidden int(144 * 3.7362) =
538 (no multiple of 128, so the kernels' padding runs), 3 blocks, 56 px (16
rows, no class row); a text tower of 3 such blocks on 16 tokens. The port
in float32 is held to the benchmark's plain reference
(``benchmark/reference/siglip.py``) on seeded random weights: anchors, maps
and scores; the attention-pool head to ``torch.nn.MultiheadAttention``
followed by its MLP; the positional-embedding resize without a class row;
the last-position text pooling; the configuration's refusals. Planted
faults (the exact GELU in the tanh GELU's place, a class row dropped from
the taps, heads scaled by 64^-0.5, the hidden tail dropped) must fail the
same comparison. The benchmark's readers of the new kernels and
``tools.trace_summary`` group them by their names on the card.

The card's tests of these widths (B1 at heads of 72, the tanh-GELU
epilogue, B2 at 1152 / 4304) are ``cuda``-marked, in
``tests/test_torch_cuda_kernels.py``.
"""
import json
import math
import os
import re

import numpy as np
import pytest
import torch

from aa_clip_iqm_tpu_torch import configs as tconfigs
from aa_clip_iqm_tpu_torch.loader import build_model_config, init_trainable, random_backbone
from aa_clip_iqm_tpu_torch.models import adapters as tadapters
from aa_clip_iqm_tpu_torch.models import clip as tclip
from aa_clip_iqm_tpu_torch.ops import attention as tattn
from aa_clip_iqm_tpu_torch.ops import fused_mlp, layers
from aa_clip_iqm_tpu_torch.ops.attn_block import check_halves
from aa_clip_iqm_tpu_torch.serving import AnomalyDetector
from aa_clip_iqm_tpu_torch.tokenizer import tokenize_padded
from aa_clip_iqm_tpu_torch.tools import trace_summary
from aa_clip_iqm_tpu_torch.utils import profiling
from benchmark import inputs
from benchmark.harness import load_module
from benchmark.reference import model as ref
from benchmark.reference import siglip as rsig

IMG = 56
SIGLIP = "ViT-SO400M-14-SigLIP-384"
# The reference's configuration dict for the tiny model.
REF_CFG = {
    "img_size": IMG, "patch_size": 14, "embed_dim": 32,
    "vision": {"width": 144, "layers": 3, "head_width": 72, "mlp_ratio": 3.7362},
    "text": {"width": 144, "layers": 3, "heads": 2, "context_length": 16,
             "vocab_size": 32000},
    "adapter": {"image_adapt_until": 1, "text_adapt_until": 1, "image_adapt_weight": 0.1,
                "text_adapt_weight": 0.1, "levels": [2, 3], "relu": False},
    "iqm": {"hidden_size": 16, "num_hidden_layers": 2, "num_attention_heads": 2,
            "intermediate_size": 32, "layer_norm_eps": 1e-12, "fuse": [0.4, 0.3, 0.3],
            "text_encoder_hidden_size": 32},
    "fusion": {"text_weight": 0.6, "iqm_weight": 0.4},
}


@pytest.fixture(scope="module")
def tiny():
    """(config, frozen, trainable): float32 weights drawn as the benchmark
    draws them (random biases and LayerNorms)."""
    cfg = build_model_config("tiny-siglip-test", img_size=IMG)
    frozen = inputs.fill(random_backbone(cfg, device="meta", dtype=torch.float32), 3, "cpu")
    trainable = inputs.fill(init_trainable(cfg, device="meta", dtype=torch.float32), 4, "cpu")
    return cfg, frozen, trainable


def _images(n, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (n, 3, IMG, IMG), dtype=np.uint8)


def _rel(a, b):
    """The relative error of a against b, or inf where their shapes differ."""
    a, b = torch.as_tensor(a).double(), torch.as_tensor(b).double()
    if a.shape != b.shape:
        return math.inf
    return ((a - b).norm() / b.norm().clamp_min(1e-30)).item()


def _program(tiny, names, images):
    """The port's anchors, maps and scores (the detector, eager on the CPU)."""
    cfg, frozen, trainable = tiny
    det = AnomalyDetector(frozen, trainable, cfg, "MVTec", img_size=IMG, adapted_text=True,
                          compute_dtype=torch.float32, device="cpu", batch_buckets=(len(names),))
    maps, scores = det.predict_multi(images, names)
    return det.anchors, maps, scores


def _reference(tiny, names, images, anchors, tower=rsig.vision):
    """The reference's anchors, and its maps and scores on ``anchors``."""
    _, frozen, trainable = tiny
    with torch.no_grad(), rsig.in_clips_place(tower):
        ref_anchors = ref.text_anchors(frozen, trainable, REF_CFG, "cpu")
        anc = torch.stack([anchors[c].float() for c in names])
        maps, scores = ref.predict(frozen, trainable, REF_CFG, torch.from_numpy(images), anc,
                                   frozen["visual"]["positional_embedding"].float(), 1)
    return ref_anchors, maps, scores


def _errors(tiny, names=("bottle", "cable", "screw"), seed=0):
    """(anchor error, map error, score error) of the port against the
    reference on the same weights, images and classes."""
    images = _images(len(names), seed)
    anchors, maps, scores = _program(tiny, list(names), images)
    ref_anchors, rmaps, rscores = _reference(tiny, names, images, anchors)
    anchor_err = max(_rel(anchors[c], r) for c, r in ref_anchors.items())
    return anchor_err, _rel(maps, rmaps), float(np.abs(scores - rscores.numpy()).max())


# --------------------------------------------------------------------------
# The configuration
# --------------------------------------------------------------------------

def test_the_registry_states_siglip_s_settings():
    c = tconfigs.get_model_config(SIGLIP, img_size=518)
    v, t = c.vision, c.text
    assert isinstance(v, tconfigs.SiglipVisionConfig) and isinstance(t, tconfigs.SiglipTextConfig)
    assert (v.width, v.layers, v.head_width, v.heads, v.mlp_hidden) == (1152, 27, 72, 16, 4304)
    assert (v.class_token, v.pool, v.ln_pre, v.ln_eps, v.num_patches) == (False, "map", False,
                                                                           1e-6, 1369)
    assert (t.causal, t.pool, t.head_bias, t.ln_eps, t.mlp_hidden) == (False, "last", True, 1e-6,
                                                                        4304)
    assert (t.context_length, t.vocab_size, t.heads, c.act, c.embed_dim) == (64, 32000, 16,
                                                                             "gelu_tanh", 1152)
    assert tconfigs.is_port_model(SIGLIP) and SIGLIP not in tconfigs.list_models()
    mc = build_model_config(SIGLIP, img_size=518)
    assert mc.iqm.text_encoder_hidden_size == 1152


def test_clip_s_configs_state_their_settings_unchanged():
    c = tconfigs.get_model_config("ViT-L-14-336")
    assert (c.vision.class_token, c.vision.pool, c.vision.ln_pre, c.vision.ln_eps) == (
        True, "token", True, 1e-5)
    assert (c.text.causal, c.text.pool, c.text.head_bias, c.text.ln_eps, c.text.mlp_hidden) == (
        True, "eot", False, 1e-5, 3072)
    e = tconfigs.get_model_config("EVA02-CLIP-bigE-14-plus").vision
    assert (e.class_token, e.ln_pre, e.ln_eps) == (True, False, 1e-6)


@pytest.mark.parametrize("section,key,value", [
    ("vision_cfg", "class_token", True),
    ("vision_cfg", "timm_pool", "avg"),
    ("vision_cfg", "act", "gelu"),
    ("text_cfg", "no_causal_mask", False),
    ("text_cfg", "pool_type", "argmax"),
    ("text_cfg", "proj_bias", False),
])
def test_another_combination_of_siglip_s_settings_raises(tmp_path, monkeypatch, section, key,
                                                         value):
    with open(os.path.join(tconfigs._PORT_CONFIG_DIR, SIGLIP + ".json")) as f:
        raw = json.load(f)
    raw[section][key] = value
    (tmp_path / "Mixed-SigLIP.json").write_text(json.dumps(raw))
    monkeypatch.setattr(tconfigs, "_PORT_CONFIG_DIR", str(tmp_path))
    with pytest.raises(NotImplementedError, match=f"{section}.{key}"):
        tconfigs.get_model_config("Mixed-SigLIP")


def test_the_tiny_config_pads_its_hidden_width():
    cfg = tconfigs.tiny_siglip_config()
    v = cfg.clip.vision
    assert (v.width, v.heads, v.head_width, v.mlp_hidden, v.num_patches) == (144, 2, 72, 538, 16)
    assert cfg.clip.text.mlp_hidden == 538 and 538 % 128


# --------------------------------------------------------------------------
# The port against the reference
# --------------------------------------------------------------------------

def test_port_matches_the_reference(tiny):
    anchor_err, map_err, score_err = _errors(tiny)
    assert anchor_err <= 1e-5 and map_err <= 1e-5 and score_err <= 1e-6, (anchor_err, map_err,
                                                                             score_err)


def test_stock_route_matches_the_reference(tiny):
    """``use_pallas=False`` (layer_norm, linear, SDPA) gives the same."""
    cfg, frozen, trainable = tiny
    images = torch.from_numpy(_images(2)).float() / 255.0
    with torch.no_grad():
        got = [tclip.vision_forward(frozen["visual"], cfg.clip.vision, images, out_layers=(2, 3),
                                    act_name="gelu_tanh", use_pallas=p)[:2] for p in (True, False)]
    assert _rel(got[0][0], got[1][0]) <= 1e-6
    assert all(_rel(a, b) <= 1e-6 for a, b in zip(got[0][1], got[1][1]))


def test_map_head_matches_multihead_attention_then_its_mlp(tiny):
    cfg, frozen, _ = tiny
    p, d, heads = frozen["visual"]["map"], 144, 2
    z = torch.randn(3, 16, d, generator=torch.Generator().manual_seed(1))
    mha = torch.nn.MultiheadAttention(d, heads, batch_first=True)
    with torch.no_grad():
        mha.in_proj_weight.copy_(p["attn"]["qkv"]["w"].t())
        mha.in_proj_bias.copy_(p["attn"]["qkv"]["b"])
        mha.out_proj.weight.copy_(p["attn"]["out"]["w"].t())
        mha.out_proj.bias.copy_(p["attn"]["out"]["b"])
        probe = p["probe"]["w"][None].expand(3, -1, -1)
        o = mha(probe, z, z, need_weights=False)[0]
        mlp = torch.nn.Sequential(torch.nn.Linear(d, 538), torch.nn.GELU(approximate="tanh"),
                                  torch.nn.Linear(538, d))
        mlp[0].weight.copy_(p["mlp"]["c_fc"]["w"].t())
        mlp[0].bias.copy_(p["mlp"]["c_fc"]["b"])
        mlp[2].weight.copy_(p["mlp"]["c_proj"]["w"].t())
        mlp[2].bias.copy_(p["mlp"]["c_proj"]["b"])
        norm = torch.nn.functional.layer_norm(o, (d,), p["ln"]["scale"], p["ln"]["bias"], 1e-6)
        want = (o + mlp(norm))[:, 0]
        before = profiling.counters().get("pool.map", 0)
        got = tclip.map_head(p, z, heads, layers.gelu_tanh, 1e-6)
    assert profiling.counters()["pool.map"] - before == 1
    assert _rel(got, want) <= 1e-6
    assert _rel(rsig.map_head(p, z, heads)[:, 0], want) <= 1e-6


def test_pos_embed_resize_without_a_class_row():
    rng = np.random.default_rng(2)
    grid = rng.standard_normal((9, 144)).astype(np.float32)
    cls = rng.standard_normal((1, 144)).astype(np.float32)
    got = tclip.resize_pos_embed_np(grid, 4, class_token=False)
    assert got.shape == (16, 144)
    with pytest.raises(ValueError, match="not square"):     # the default is a class row
        tclip.resize_pos_embed_np(grid, 4)
    with_cls = tclip.resize_pos_embed_np(np.concatenate([cls, grid]), 4)
    np.testing.assert_array_equal(with_cls[0], cls[0])
    np.testing.assert_allclose(got, with_cls[1:], rtol=0, atol=0)
    want = rsig.resize_pos_embed(torch.from_numpy(grid), 4).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert tclip.resize_pos_embed_np(grid, 3, class_token=False) is grid


def test_text_tower_is_bidirectional_and_pools_the_last_position(tiny):
    cfg, frozen, _ = tiny
    t = cfg.clip.text
    tokens = torch.from_numpy(tokenize_padded(["a photo of a damaged bottle.", "a cable"],
                                              t.context_length, t.vocab_size)).long()
    assert (tokens[:, -1] == 1).all() and tokens.shape == (2, 16)
    with torch.no_grad():
        got = tclip.text_forward(frozen["text"], t, tokens, act_name="gelu_tanh",
                                 final_proj=lambda pooled: pooled)
        p = frozen["text"]
        x = p["token_embedding"][tokens] + p["positional_embedding"]
        for blk in p["blocks"]:
            x = rsig.block(blk, x, t.heads)
        want = ref.ln(p["ln_final"], x, 1e-6)[:, -1]
        head = tclip.text_forward(frozen["text"], t, tokens, act_name="gelu_tanh")
    assert _rel(got, want) <= 1e-6
    assert _rel(head, want @ p["head"]["w"] + p["head"]["b"]) <= 1e-6
    # An earlier token moves the pooled row: no causal mask.
    moved = tokens.clone()
    moved[:, 0] += 1
    with torch.no_grad():
        other = tclip.text_forward(frozen["text"], t, moved, act_name="gelu_tanh",
                                   final_proj=lambda pooled: pooled)
    assert _rel(other, got) > 1e-4


def test_prompt_ids_are_the_reference_s():
    sentences = ["a photo of a flawless bottle.", "a cropped photo of the damaged screw."]
    got = tokenize_padded(sentences, 64, 32000)
    np.testing.assert_array_equal(got, rsig.tokenize(sentences, 64, 32000))
    assert got.max() < 32000 and got.shape == (2, 64)
    long = tokenize_padded(["word " * 100], 64, 32000)
    assert long.shape == (1, 64) and long[0, -1] == 1


def test_counters_count_the_blocks_halves_and_the_pool(tiny):
    cfg, frozen, _ = tiny
    before = profiling.counters()
    with torch.no_grad():
        tclip.vision_forward(frozen["visual"], cfg.clip.vision, torch.zeros(1, 3, IMG, IMG),
                             act_name="gelu_tanh")
    after = profiling.counters()
    n = cfg.clip.vision.layers
    assert after["blocks.siglip"] - before.get("blocks.siglip", 0) == n
    assert after["siglip.fused"] - before.get("siglip.fused", 0) == 2 * n
    assert after.get("siglip.chain", 0) == before.get("siglip.chain", 0)
    assert after["pool.map"] - before.get("pool.map", 0) == 1
    x = torch.zeros(1, 3, IMG, IMG, requires_grad=True)
    tclip.vision_forward(frozen["visual"], cfg.clip.vision, x, act_name="gelu_tanh")
    assert profiling.counters()["siglip.chain"] - after.get("siglip.chain", 0) == 2 * n


def test_padding_of_the_hidden_width_is_exact(tiny):
    cfg, frozen, _ = tiny
    blk = frozen["visual"]["blocks"][0]
    padded = fused_mlp.padded_hidden(blk["mlp"])
    assert padded["c_fc"]["w"].shape == (144, 768) and padded["c_proj"]["w"].shape == (768, 144)
    assert fused_mlp.padded_hidden(blk["mlp"]) is padded
    x = torch.randn(2, 16, 144, generator=torch.Generator().manual_seed(3))
    got = fused_mlp.ln_mlp_residual(blk["ln_2"], padded, x, layers.gelu_tanh, 1e-6)
    want = fused_mlp.ln_mlp_residual_reference(blk["ln_2"], blk["mlp"], x, layers.gelu_tanh, 1e-6)
    assert _rel(got, want) <= 1e-6
    # A width a B2 path takes, or weights that need a gradient, stay as they are.
    vitl = {"c_fc": {"w": torch.zeros(8, 256), "b": torch.zeros(256)},
            "c_proj": {"w": torch.zeros(256, 8), "b": torch.zeros(8)}}
    assert fused_mlp.padded_hidden(vitl) is vitl
    grad = {k: {n: t.clone().requires_grad_(True) for n, t in v.items()}
            for k, v in blk["mlp"].items()}
    assert fused_mlp.padded_hidden(grad) is grad


def test_anchors_drop_the_text_tower_s_padded_copies(tiny):
    """The text tower runs at set-up alone: after the anchors its padded MLP
    copies are gone from the layouts, and the vision tower's stay."""
    from aa_clip_iqm_tpu_torch.prompts import compute_frozen_anchors

    cfg, frozen, trainable = tiny
    vis = frozen["visual"]["blocks"][0]["mlp"]
    kept = fused_mlp.padded_hidden(vis)
    anchors = compute_frozen_anchors(frozen, trainable, cfg, "MVTec", adapted=True)
    assert all(a.shape == (cfg.clip.embed_dim, 2) for a in anchors.values())
    made = {id(v[0]()) for k, v in layers._LAYOUTS.items() if k[0] is fused_mlp._pad_hidden}
    assert not made & {id(b["mlp"]["c_fc"]["w"]) for b in frozen["text"]["blocks"]}
    assert id(vis["c_fc"]["w"]) in made and fused_mlp.padded_hidden(vis) is kept


def test_stage_one_raises(tiny):
    cfg, frozen, _ = tiny
    with pytest.raises(NotImplementedError, match="value-value"):
        tclip.dual_vision_features(frozen["visual"], cfg.clip.vision, torch.zeros(1, 3, IMG, IMG),
                                   out_layers=(2, 3), vv_from=2, act_name="gelu_tanh")


def test_the_halves_gate_raises_on_the_card_s_refusals():
    from torch._subclasses.fake_tensor import FakeTensorMode

    check_halves(torch.zeros(1, 16, 144), {"qkv": {"w": torch.zeros(144, 432)},
                                           "out": {"w": torch.zeros(144, 144)}})
    with FakeTensorMode():
        def e(*shape, dtype=torch.bfloat16):
            return torch.empty(*shape, dtype=dtype, device="cuda")

        attn = {"qkv": {"w": e(1152, 3456)}, "out": {"w": e(1152, 1152)}}
        check_halves(e(2, 1369, 1152), attn)
        with pytest.raises(ValueError, match="not bf16"):
            check_halves(e(2, 1369, 1152, dtype=torch.float32), attn)
        narrow = {"qkv": {"w": e(144, 432)}, "out": {"w": e(144, 144)}}
        with pytest.raises(ValueError, match="multiple of 128"):
            check_halves(e(2, 16, 144), narrow)


def test_b1_takes_heads_of_72():
    qkv = torch.zeros(1, 1369, 3 * 16 * 72)
    assert tattn.packed_ok(qkv, 16, None, 16 * 72)
    assert not tattn.packed_ok(qkv[:, :255], 16, None, 16 * 72)
    assert not tattn.packed_ok(torch.zeros(1, 8282, 3 * 16 * 72), 16, None, 16 * 72)


# --------------------------------------------------------------------------
# Planted faults: each must fail the comparison
# --------------------------------------------------------------------------

def _fails(tiny):
    anchor_err, map_err, score_err = _errors(tiny)
    return anchor_err > 1e-5 or map_err > 1e-5 or score_err > 1e-6


def test_fault_erf_gelu_in_the_tanh_gelu_s_place(tiny, monkeypatch):
    monkeypatch.setitem(layers.ACTIVATIONS, "gelu_tanh", layers.gelu)
    assert _fails(tiny)


def test_fault_a_class_row_dropped_from_the_taps(tiny, monkeypatch):
    real = tclip.vision_forward

    def dropped(*args, **kwargs):
        pooled, taps, x = real(*args, **kwargs)
        return pooled, [t[:, 1:] for t in taps], x
    monkeypatch.setattr(tclip, "vision_forward", dropped)
    cfg, frozen, trainable = tiny
    images = torch.from_numpy(_images(2)).float() / 255.0
    anchors = torch.randn(2, 32, 2, generator=torch.Generator().manual_seed(5))
    with torch.no_grad():
        got = tadapters.encode_image_adapted(frozen, trainable, cfg, images, anchors)
        monkeypatch.setattr(tclip, "vision_forward", real)
        want = tadapters.encode_image_adapted(frozen, trainable, cfg, images, anchors)
    assert _rel(got.seg_tokens[0], want.seg_tokens[0]) == math.inf
    assert _rel(got.det_token, want.det_token) > 1e-3


def test_fault_heads_scaled_by_64(tiny, monkeypatch):
    real = tattn.attend_qkv

    def attend(qkv, num_heads, attn_mask=None, valid_len=None, use_pallas=True):
        if attn_mask is not None:
            return real(qkv, num_heads, attn_mask=attn_mask, valid_len=valid_len,
                        use_pallas=use_pallas)
        return tattn.flash_mha_packed(qkv, num_heads, 64 ** -0.5, valid_len=valid_len)
    monkeypatch.setattr(tattn, "attend_qkv", attend)
    assert _fails(tiny)


def test_fault_the_hidden_tail_dropped(tiny, monkeypatch):
    """A kernel that ignores the ragged tail: the last 80 hidden columns."""
    def dropped(mlp):
        c_fc, c_proj = mlp["c_fc"], mlp["c_proj"]
        h = c_fc["w"].shape[-1] - 80
        return fused_mlp._pad_hidden(c_fc["w"][:, :h], c_fc["b"][:h], c_proj["w"][:h],
                                     c_proj["b"])
    monkeypatch.setattr(tclip, "padded_hidden", dropped)
    assert _fails(tiny)


# --------------------------------------------------------------------------
# The benchmark's readers and the trace summary, by kernel name
# --------------------------------------------------------------------------

B1_64 = ("void aaclip::attn_fwd::(anonymous namespace)::attention_wgmma_kernel<packed_attention>"
         "(aaclip::attn_fwd::(anonymous namespace)::Maps, __nv_bfloat16*, float*, "
         "aaclip::attn_fwd::(anonymous namespace)::Layout, int, int, float)")
B1_112 = B1_64.replace("<packed_attention>", "<packed_attention_hd112>")
B1_72 = B1_64.replace("<packed_attention>", "<packed_attention_hd72>")
B7 = B1_64.replace("<packed_attention>", "<flash_attention>")
B2 = ("void aaclip::gemm90::(anonymous namespace)::gemm_bias_act_kernel<(anonymous namespace)::"
      "ln_mlp_residual_stage, 256, 0>(CUtensorMap, CUtensorMap, CUtensorMap, CUtensorMap, "
      "aaclip::gemm90::(anonymous namespace)::Operands, int, int, int)")
B2_TANH = B2.replace("ln_mlp_residual_stage, 256, 0", "ln_mlp_residual_stage, 256, 3")
B8 = B2.replace("ln_mlp_residual_stage, 256, 0", "ln_attn_residual_stage, 256, 2")


def _matches(reader, name):
    mod = load_module("metrics", reader)
    return (any(re.search(p, name) for p in mod.INCLUDE)
            and not any(re.search(p, name) for p in mod.EXCLUDE))


@pytest.mark.parametrize("reader,own,others", [
    ("attn_hd72_fwd_roofline", [B1_72], [B1_64, B1_112, B7, B2, B2_TANH, B8]),
    ("siglip_mlp_fwd_roofline", [B2_TANH, B2], [B1_64, B1_72, B1_112, B7, B8]),
    ("attn_fwd_roofline", [B1_64, B7], [B1_72, B1_112, B2, B8]),
    ("attn_hd112_fwd_roofline", [B1_112], [B1_64, B1_72, B7]),
])
def test_readers_take_their_kernels_alone(reader, own, others):
    assert all(_matches(reader, n) for n in own)
    assert not any(_matches(reader, n) for n in others)


def test_the_trace_summary_groups_the_72_instance():
    want = {B1_72: "B1 packed_attention_hd72", B1_112: "B1 packed_attention_hd112",
            B1_64: "B1 packed_attention", B2_TANH: "B2 ln_mlp_residual"}
    assert {n: trace_summary.kernel_group(n) for n in want} == want
