"""EVA02-CLIP's vision tower in the port against the benchmark's plain
float32 reference (``benchmark/reference/eva02.py``), and its kernels
against their plain versions.

On the CPU at a tiny EVA-02 config (``configs.tiny_eva02_config``: width
64, 4 heads of 16, 4 blocks, hidden 170, a 4 x 4 grid at 56 px against a
rotary reference grid of 3), in float32, on seeded random weights made as
the benchmark makes them (``benchmark/inputs.fill``): one block, the tower,
the anchors, and the detector's maps and scores; the stock chain and the
autograd route; patch dropout's gathered rotary rows; the rotary table; the
MLP kernel's plain stages (padding, the folded sub-LN) against the plain
MLP in bf16 ulps; the registry and the loader. Planted faults (the rotation
applied from the class row on, the rotation left off k, the sub-LN averaged
over the padded width) must fail the same tolerances.

Tolerances: the port and the reference compute the same float32 function
with sums in other orders (the reference's patch embedding is a conv2d,
its attention a few heads at a time), so each element may differ by a few
float32 ulps of its row's scale, compounded over 4 blocks: max |port - ref|
<= 1e-4 * max(1, max |ref|) holds them with room, and every planted fault
moves elements by 1e-2 or more of that scale. In bf16 the kernels' stages
are held to the plain MLP in bf16 ulps (``ops/compare.py``).

Marked ``cuda`` (skipped without a card): the rotation kernel and
``ln_swiglu_residual`` against their plain versions at EVA02-CLIP-L's
widths, in bf16 ulps, with the planted faults failing there too. This file
imports no JAX, so on a machine with a card:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_eva02.py -q
"""
import dataclasses
import json

import numpy as np
import pytest
import torch
from torch.utils._pytree import tree_map

from aa_clip_iqm_tpu_torch import configs as tconfigs
from aa_clip_iqm_tpu_torch.loader import (build_model_config, init_trainable,
                                          load_frozen_backbone, random_backbone)
from aa_clip_iqm_tpu_torch.models import clip as tclip
from aa_clip_iqm_tpu_torch.ops import _build
from aa_clip_iqm_tpu_torch.ops import rope as trope
from aa_clip_iqm_tpu_torch.ops import swiglu
from aa_clip_iqm_tpu_torch.ops.compare import BF16_MAX_ULPS, BF16_RMS_ULPS, bf16_error
from aa_clip_iqm_tpu_torch.ops.layers import layer_norm
from aa_clip_iqm_tpu_torch.serving import AnomalyDetector
from aa_clip_iqm_tpu_torch.tools import trace_summary
from aa_clip_iqm_tpu_torch.utils import profiling
from benchmark import inputs
from benchmark.reference import eva02 as ref
from benchmark.reference import model as ref_model

IMG = 56
F32_TOL = 1e-4
CPU = torch.device("cpu")


def _close(out, want, tol=F32_TOL) -> bool:
    want = want.float()
    return (out.float() - want).abs().max().item() <= tol * max(1.0, want.abs().max().item())


@pytest.fixture(scope="module")
def tiny():
    torch.set_num_threads(1)
    cfg = build_model_config("tiny-eva02-test", img_size=IMG)
    frozen = inputs.fill(random_backbone(cfg, device="meta", dtype=torch.float32), 11, CPU)
    trainable = inputs.fill(init_trainable(cfg, device="meta", dtype=torch.float32), 12, CPU)
    return cfg, frozen, trainable


def _ref_cfg(cfg):
    """The benchmark configuration file's keys that the reference reads."""
    v, a = cfg.clip.vision, cfg.adapter
    return {"vision": {"width": v.width, "head_width": v.head_width,
                       "rope_ref_grid": v.rope_ref_grid},
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


def _tower(tiny, images, use_pallas=True):
    cfg, frozen, trainable = tiny
    a = cfg.adapter
    return tclip.vision_forward(frozen["visual"], cfg.clip.vision, images,
                                out_layers=tuple(a.levels),
                                adapters=trainable["image_adapter"]["layer_adapters"],
                                adapter_weight=a.image_adapt_weight,
                                adapt_until=a.image_adapt_until, use_pallas=use_pallas)


def _ref_tower(tiny, images):
    cfg, frozen, trainable = tiny
    return ref.vision(frozen["visual"], _ref_cfg(cfg), images,
                      trainable["image_adapter"]["layer_adapters"],
                      frozen["visual"]["positional_embedding"])


def _tower_matches(tiny, images) -> bool:
    cfg, frozen, _ = tiny
    with torch.no_grad():
        pooled, taps, x = _tower(tiny, images)
        rtaps, rx = _ref_tower(tiny, images)
    eps = cfg.clip.vision.ln_eps
    tokens = [layer_norm(frozen["visual"]["ln_post"], t[:, 1:], eps=eps) for t in taps]
    return (_close(x, rx) and _close(pooled, ref.pooled(frozen["visual"], rx))
            and all(_close(t, r) for t, r in zip(tokens, rtaps)))


# --------------------------------------------------------------------------
# The port against the reference
# --------------------------------------------------------------------------

def test_block_matches_reference(tiny):
    cfg, frozen, _ = tiny
    v = cfg.clip.vision
    x = torch.randn(2, v.num_patches + 1, v.width, generator=torch.Generator().manual_seed(3))
    table = trope.rope_table(v.grid, v.rope_ref_grid, v.head_width, CPU)
    cos, sin = ref.rope_cos_sin(v.grid, v.rope_ref_grid, v.head_width)
    blk = frozen["visual"]["blocks"][1]
    with torch.no_grad():
        got = tclip._run_eva02_block(blk, x, v.heads, rope=table, eps=v.ln_eps)
        want = ref.block(blk, x, v.heads, cos, sin)
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
        assert _close(det.anchors[c], w), c


def test_detector_maps_and_scores_match_reference(tiny):
    cfg, frozen, trainable = tiny
    det = AnomalyDetector(frozen, trainable, cfg, "MVTec", img_size=IMG,
                          compute_dtype=torch.float32, batch_buckets=(4,), device="cpu")
    names = det.class_names()[:3]
    u8 = np.random.default_rng(5).integers(0, 256, (3, 3, IMG, IMG), np.uint8)
    maps, scores = det.predict_multi(u8, names)
    anchors = torch.stack([det.anchors[c].float() for c in names])
    with torch.no_grad():
        rmaps, rscores = ref.predict(frozen, trainable, _ref_cfg(cfg), torch.from_numpy(u8),
                                     anchors, frozen["visual"]["positional_embedding"])
    assert _close(torch.from_numpy(maps), rmaps)
    assert _close(torch.from_numpy(scores), rscores)
    # The swap of the reference's tower lasts the call alone.
    assert ref_model.vision is not ref.vision


@pytest.mark.parametrize("route", ["stock", "autograd"])
def test_chain_routes_match_reference(tiny, route):
    """``use_pallas=False`` and a forward under autograd run the stock chain
    (no rotation kernel, no MLP kernel): the same function."""
    images = _images(2, seed=1)
    before = profiling.counters().get("mlp.swiglu_chain", 0)
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
    assert profiling.counters()["mlp.swiglu_chain"] - before == tiny[0].clip.vision.layers


@pytest.mark.parametrize("needs_grad,route", [(None, "mlp.swiglu_fused"),
                                              ("x", "mlp.swiglu_chain"),
                                              ("weight", "mlp.swiglu_chain")])
def test_the_block_takes_the_chain_only_where_a_gradient_is_recorded(tiny, needs_grad, route):
    """With gradients enabled, a block whose x and weights need none (an
    inference call that did not turn autograd off) keeps the kernels'
    route; one whose x or a weight needs a gradient runs the stock chain."""
    cfg, frozen, _ = tiny
    v = cfg.clip.vision
    blk = tree_map(lambda t: t.detach().clone(), frozen["visual"]["blocks"][0])
    x = torch.randn(2, v.grid ** 2 + 1, v.width, generator=torch.Generator().manual_seed(6))
    if needs_grad == "x":
        x.requires_grad_(True)
    elif needs_grad == "weight":
        blk["mlp"]["w3"]["w"].requires_grad_(True)
    table = trope.rope_table(v.grid, v.rope_ref_grid, v.head_width, CPU)
    cos, sin = ref.rope_cos_sin(v.grid, v.rope_ref_grid, v.head_width)
    before = profiling.counters()
    assert torch.is_grad_enabled()
    got = tclip._run_eva02_block(blk, x, v.heads, rope=table, eps=v.ln_eps)
    after = profiling.counters()
    other = ({"mlp.swiglu_fused", "mlp.swiglu_chain"} - {route}).pop()
    assert after[route] - before.get(route, 0) == 1
    assert after.get(other, 0) == before.get(other, 0)
    assert got.requires_grad == (needs_grad is not None)
    with torch.no_grad():
        want = ref.block(blk, x.detach(), v.heads, cos, sin)
    assert _close(got.detach(), want)


def test_the_trace_summary_groups_the_eva02_kernels():
    want = {"void layer_norm_rows_kernel<ln_swiglu_residual_stage>": "ln_swiglu_residual",
            "swiglu_dual_kernel<ln_swiglu_residual_stage>": "ln_swiglu_residual",
            "swiglu_out_kernel<ln_swiglu_residual_stage, 256>": "ln_swiglu_residual",
            "layer_norm_rows_kernel<eva02_layer_norm>": "ln_swiglu_residual_layer_norm",
            "rope_qk_kernel": "rope_qk"}
    assert {n: trace_summary.kernel_group(n).split()[-1] for n in want} == want


def test_patch_dropout_gathers_the_rotary_rows(tiny):
    cfg, frozen, _ = tiny
    v = cfg.clip.vision
    keep = torch.tensor([[0, 5, 6, 15], [2, 3, 9, 10]])
    x = torch.randn(2, keep.shape[1] + 1, v.width, generator=torch.Generator().manual_seed(4))
    table = trope.rope_table(v.grid, v.rope_ref_grid, v.head_width, CPU)[:, keep]
    cos, sin = ref.rope_cos_sin(v.grid, v.rope_ref_grid, v.head_width)
    blk = frozen["visual"]["blocks"][0]
    with torch.no_grad():
        got = tclip._run_eva02_block(blk, x, v.heads, rope=table, eps=v.ln_eps)
        for b in range(2):
            want = ref.block(blk, x[b:b + 1], v.heads, cos[keep[b]], sin[keep[b]])
            assert _close(got[b:b + 1], want)
        _, taps, _ = tclip.vision_forward(frozen["visual"], v, _images(2), out_layers=(2,),
                                          keep_idx=keep)
    assert taps[0].shape == (2, keep.shape[1] + 1, v.width)


@pytest.mark.parametrize("grid,ref_grid,head_dim", [(4, 3, 16), (37, 16, 64), (24, 16, 64)])
def test_rope_table_matches_reference(grid, ref_grid, head_dim):
    table = trope.rope_table(grid, ref_grid, head_dim, CPU)
    cos, sin = ref.rope_cos_sin(grid, ref_grid, head_dim)
    assert table.shape == (2, grid * grid, head_dim)
    assert torch.allclose(table[0], cos, atol=1e-6) and torch.allclose(table[1], sin, atol=1e-6)
    # A pair of neighbouring dims shares its angle; the class row has none.
    assert torch.equal(table[:, :, 0::2], table[:, :, 1::2])


# --------------------------------------------------------------------------
# Planted faults: each must fail the tolerance the port passes
# --------------------------------------------------------------------------

def _rope_from_the_class_row(qkv, table, num_heads):
    """The table aligned to the sequence's start: the class row takes patch
    0's angles and each patch its predecessor's."""
    l, w = qkv.shape[1], qkv.shape[-1] // 3
    hd = w // num_heads
    turned = trope.rotate(qkv[:, :-1, :2 * w].unflatten(-1, (2 * num_heads, hd)),
                          table[0][None, :, None, :], table[1][None, :, None, :])
    out = qkv.clone()
    out[:, :l - 1, :2 * w] = turned.flatten(-2)
    return out


def _rope_off_k(qkv, table, num_heads):
    w = qkv.shape[-1] // 3
    out = trope.rope_qk_reference(qkv, table, num_heads)
    out[..., w:2 * w] = qkv[..., w:2 * w]
    return out


@pytest.mark.parametrize("fault", [_rope_from_the_class_row, _rope_off_k])
def test_planted_rotation_faults_fail(tiny, monkeypatch, fault):
    monkeypatch.setattr(tclip, "rope_qk", fault)
    assert not _tower_matches(tiny, _images(2))


# --------------------------------------------------------------------------
# The MLP kernel's plain stages
# --------------------------------------------------------------------------

def _mlp(d, h, dtype, seed=1):
    g = torch.Generator().manual_seed(seed)

    def r(*shape, std=1.0):
        return torch.randn(*shape, generator=g) * std

    mlp = {"w12": {"w": r(d, 2 * h, std=d ** -0.5).to(dtype), "b": r(2 * h, std=0.02)},
           "ln": {"scale": 1 + r(h, std=0.02), "bias": r(h, std=0.02)},
           "w3": {"w": r(h, d, std=h ** -0.5).to(dtype), "b": r(d, std=0.02)}}
    ln = {"scale": 1 + r(d, std=0.02), "bias": r(d, std=0.02)}
    return ln, mlp


def test_lay_out_pads_and_folds():
    ln, mlp = _mlp(64, 170, torch.float32)
    ops = swiglu.lay_out(*swiglu.leaves(mlp))
    assert (ops.h, ops.hp) == (170, 256)
    assert ops.w12t.shape == (512, 64) and ops.w3t.shape == (64, 256)
    assert not ops.w12t[170:256].any() and not ops.w12t[426:].any()
    assert not ops.b12[170:256].any() and not ops.w3t[:, 170:].any()
    assert torch.equal(ops.w12t[256:426], mlp["w12"]["w"][:, 170:].t())
    w3f = mlp["w3"]["w"] * mlp["ln"]["scale"][:, None]
    assert torch.allclose(ops.s3, w3f.sum(0), atol=1e-5)
    assert torch.allclose(ops.b3, mlp["w3"]["b"] + mlp["ln"]["bias"] @ mlp["w3"]["w"], atol=1e-5)


@pytest.mark.parametrize("d,h,m", [(64, 170, 77), (128, 340, 300), (1024, 2730, 256)])
def test_stages_match_the_plain_mlp(d, h, m):
    """The kernel's stages (padding, the folded sub-LN, its roundings)
    against the plain chain, also at EVA02-CLIP-L's widths (h 2730 padded to
    2816): in float32 within F32_TOL, in bf16 within the kernels' ulps."""
    for dtype in (torch.float32, torch.bfloat16):
        ln, mlp = _mlp(d, h, dtype)
        x = torch.randn(m, d, generator=torch.Generator().manual_seed(2)).to(dtype)
        want = swiglu.ln_swiglu_residual_reference(ln, mlp, x)
        got = swiglu.ln_swiglu_residual_stages(ln, mlp, x)
        if dtype == torch.float32:
            assert _close(got, want)
        else:
            max_ulps, rms_ulps = bf16_error(got, want, x)
            assert max_ulps <= BF16_MAX_ULPS and rms_ulps <= BF16_RMS_ULPS, (max_ulps, rms_ulps)


def test_planted_sub_ln_over_the_padded_width_fails():
    ln, mlp = _mlp(64, 170, torch.bfloat16)
    x = torch.randn(77, 64, generator=torch.Generator().manual_seed(2)).to(torch.bfloat16)
    ops = swiglu.lay_out(*swiglu.leaves(mlp))
    ops.h = ops.hp
    got = swiglu.ln_swiglu_residual_stages(ln, mlp, x, ops=ops)
    max_ulps, rms_ulps = bf16_error(got, swiglu.ln_swiglu_residual_reference(ln, mlp, x), x)
    assert max_ulps > BF16_MAX_ULPS and rms_ulps > BF16_RMS_ULPS


def test_the_layer_norm_pass_is_the_plain_layer_norm_on_the_cpu_only():
    """On the CPU the plain version; on a device it cannot run on it raises,
    as the other wrappers do, and never falls back."""
    g = torch.Generator().manual_seed(3)
    ln = {"scale": 1 + 0.02 * torch.randn(64, generator=g), "bias": torch.randn(64, generator=g)}
    x = torch.randn(5, 64, generator=g)
    assert torch.equal(swiglu.layer_norm_rows(ln, x, 1e-6), layer_norm(ln, x, eps=1e-6))
    with pytest.raises(ValueError, match="layer_norm_rows"):
        swiglu.layer_norm_rows(ln, torch.empty(5, 64, device="meta"))


def test_the_mlp_wrapper_runs_the_plain_twin_on_the_cpu():
    ln, mlp = _mlp(64, 170, torch.float32)
    x = torch.randn(2, 9, 64)
    assert torch.equal(swiglu.ln_swiglu_residual(ln, mlp, x),
                       swiglu.ln_swiglu_residual_reference(ln, mlp, x))


# --------------------------------------------------------------------------
# Registry and loader
# --------------------------------------------------------------------------

def test_registry_gives_the_published_widths():
    cfg = tconfigs.get_model_config("EVA02-CLIP-L-14-336")
    v, t = cfg.vision, cfg.text
    assert isinstance(v, tconfigs.Eva02VisionConfig)
    assert (v.image_size, v.patch_size, v.width, v.layers, v.heads, v.head_width) == (
        336, 14, 1024, 24, 16, 64)
    assert (v.mlp_hidden, v.rope_ref_grid, v.ln_eps, cfg.embed_dim) == (2730, 16, 1e-6, 768)
    assert (t.width, t.layers, t.heads, t.context_length, t.vocab_size) == (768, 12, 12, 77, 49408)
    assert cfg.act == "gelu"
    assert "EVA02-CLIP-L-14-336" not in tconfigs.list_models()


def test_build_model_config_at_518_keeps_the_widths_and_iqm():
    mc = build_model_config("EVA02-CLIP-L-14-336", img_size=518)
    assert mc.clip.vision.grid == 37 and mc.clip.vision.mlp_hidden == 2730
    assert mc.iqm.text_encoder_hidden_size == mc.clip.embed_dim == 768
    assert mc.adapter.levels == (6, 12, 18, 24)


def test_a_config_asking_for_another_block_is_refused(tmp_path, monkeypatch):
    raw = {"embed_dim": 8, "text_cfg": {"context_length": 77, "vocab_size": 49408, "width": 8,
                                        "heads": 2, "layers": 1},
           "vision_cfg": {"image_size": 28, "layers": 1, "width": 64, "head_width": 16,
                          "mlp_ratio": 2.6667, "patch_size": 14, "rope": True,
                          "pt_hw_seq_len": 16, "intp_freq": True, "naiveswiglu": True,
                          "subln": False}}
    (tmp_path / "Other.json").write_text(json.dumps(raw))
    monkeypatch.setattr(tconfigs, "_PORT_CONFIG_DIR", str(tmp_path))
    with pytest.raises(NotImplementedError, match="subln"):
        tconfigs.get_model_config("Other")


def test_with_image_size_makes_another_rotary_table(tiny):
    cfg, frozen, _ = tiny
    v = cfg.clip.vision
    bigger = cfg.clip.with_image_size(70).vision
    assert isinstance(bigger, tconfigs.Eva02VisionConfig) and bigger.grid == 5
    before = profiling.counters().get("rope.tables", 0)
    trope.rope_table(v.grid, v.rope_ref_grid, v.head_width, CPU)
    trope.rope_table(bigger.grid, bigger.rope_ref_grid, bigger.head_width, CPU)
    trope.rope_table(bigger.grid, bigger.rope_ref_grid, bigger.head_width, CPU)
    assert profiling.counters().get("rope.tables", 0) - before <= 1
    t = trope.rope_table(bigger.grid, bigger.rope_ref_grid, bigger.head_width, CPU)
    assert t.shape == (2, 25, v.head_width)


def test_random_backbone_is_the_eva02_tree_and_fills():
    cfg = build_model_config("tiny-eva02-test", img_size=IMG)
    frozen = random_backbone(cfg, seed=0, device="cpu", dtype=torch.float32)
    vis = frozen["visual"]
    assert "ln_pre" not in vis and "proj" not in vis
    assert vis["head"]["w"].shape == (64, 32) and vis["patch_embed"]["b"].shape == (64,)
    blk = vis["blocks"][0]
    assert blk["attn"]["qkv"]["w"].shape == (64, 192) and "b" not in blk["attn"]["qkv"]
    assert blk["mlp"]["w12"]["w"].shape == (64, 340) and blk["mlp"]["ln"]["scale"].shape == (170,)
    # Every leaf has a rule in the benchmark's weight maker.
    inputs.fill(random_backbone(cfg, device="meta"), 0, CPU)


def test_loader_refuses_a_checkpoint_it_cannot_read(tmp_path):
    cfg = build_model_config("tiny-eva02-test", img_size=IMG)
    pt = tmp_path / "EVA02_CLIP_L_336_psz14_s6B.pt"
    pt.write_bytes(b"")
    with pytest.raises(NotImplementedError, match="EVA-CLIP checkpoint"):
        load_frozen_backbone(cfg, str(pt), device="cpu")


def test_eva02_counters_count_blocks_and_routes(tiny):
    cfg = tiny[0]
    before = profiling.counters()
    with torch.no_grad():
        _tower(tiny, _images(1))
    after = profiling.counters()
    n = cfg.clip.vision.layers
    assert after["blocks.eva02"] - before.get("blocks.eva02", 0) == n
    assert after["mlp.swiglu_fused"] - before.get("mlp.swiglu_fused", 0) == n


def test_the_tiny_float32_tower_keeps_the_attention_chain(tiny):
    """The tiny tower (float32, width 64) fails ``ln_attn_halves_ok``: each
    block's attention half stays on the chain and counts so."""
    before = profiling.counters()
    with torch.no_grad():
        _tower(tiny, _images(1))
    after = profiling.counters()
    n = tiny[0].clip.vision.layers
    assert after["attn.proj_chain"] - before.get("attn.proj_chain", 0) == n
    assert after.get("attn.proj_fused", 0) == before.get("attn.proj_fused", 0)


@pytest.mark.parametrize("what", ["tiny tower", "bf16 block"])
def test_the_stock_route_counts_no_attention_route(tiny, what):
    """``use_pallas=False`` counts neither ``attn.proj_fused`` nor
    ``attn.proj_chain``, as CLIP's block on the stock route does: the
    share's denominator is the blocks that could take the halves."""
    keys = ("attn.proj_fused", "attn.proj_chain")
    before = profiling.counters()
    with torch.no_grad():
        if what == "tiny tower":
            _tower(tiny, _images(1), use_pallas=False)
            n = tiny[0].clip.vision.layers
        else:
            x = torch.randn(2, 17, 128, generator=torch.Generator().manual_seed(8))
            tclip._run_eva02_block(_bf16_block(), x.to(torch.bfloat16), 2,
                                   rope=trope.rope_table(4, 3, 64, CPU), eps=1e-6,
                                   use_pallas=False)
            n = 1
    after = profiling.counters()
    assert all(after.get(k, 0) == before.get(k, 0) for k in keys)
    assert after["blocks.eva02"] - before.get("blocks.eva02", 0) == n


def _bf16_block(d=128, h=192, seed=0):
    """An EVA-02 block of a width that B8's halves take (two heads of 64),
    bf16, on seeded random weights."""
    g = torch.Generator().manual_seed(seed)

    def w(*shape, scale):
        return (torch.randn(shape, generator=g) * scale).to(torch.bfloat16)

    def ln(n):
        return {"scale": 1 + w(n, scale=0.1), "bias": w(n, scale=0.1)}

    return {"ln_1": ln(d),
            "attn": {"qkv": {"w": w(d, 3 * d, scale=d ** -0.5)}, "q": {"b": w(d, scale=0.05)},
                     "v": {"b": w(d, scale=0.05)}, "ln": ln(d),
                     "out": {"w": w(d, d, scale=d ** -0.5), "b": w(d, scale=0.05)}},
            "ln_2": ln(d),
            "mlp": {"w12": {"w": w(d, 2 * h, scale=d ** -0.5), "b": w(2 * h, scale=0.05)},
                    "ln": ln(h), "w3": {"w": w(h, d, scale=h ** -0.5), "b": w(d, scale=0.05)}}}


@pytest.mark.parametrize("needs_grad,route", [(None, "attn.proj_fused"),
                                              ("x", "attn.proj_chain"),
                                              ("weight", "attn.proj_chain")])
def test_a_bf16_block_takes_b8_s_halves_where_nothing_is_recorded(needs_grad, route,
                                                                  monkeypatch):
    """A bf16 EVA-02 block of width 128 whose call autograd does not record
    runs LN1 and the ``[q | 0 | v]`` projection on B8's front and the
    out-projection with the residual on its back, around the rotation, the
    attention and the sub-LN: held to the chain (x recorded) in bf16 ulps.
    A recorded call runs the chain, and neither half."""
    from aa_clip_iqm_tpu_torch.ops import attn_block

    calls = []

    def spy(name):
        real = getattr(tclip, name)

        def call(*a, **k):
            calls.append(name)
            return real(*a, **k)
        monkeypatch.setattr(tclip, name, call)

    spy("ln_attn_front")
    spy("ln_attn_back")
    blk = _bf16_block()
    x = torch.randn(2, 17, 128, generator=torch.Generator().manual_seed(7)).to(torch.bfloat16)
    table = trope.rope_table(4, 3, 64, CPU)
    chain = tclip._run_eva02_block(blk, x.clone().requires_grad_(True), 2, rope=table,
                                   eps=1e-6).detach()
    if needs_grad == "x":
        x.requires_grad_(True)
    elif needs_grad == "weight":
        blk["attn"]["out"]["w"].requires_grad_(True)
    before = profiling.counters()
    calls.clear()
    got = tclip._run_eva02_block(blk, x, 2, rope=table, eps=1e-6)
    after = profiling.counters()
    other = ({"attn.proj_fused", "attn.proj_chain"} - {route}).pop()
    assert after[route] - before.get(route, 0) == 1
    assert after.get(other, 0) == before.get(other, 0)
    assert calls == (["ln_attn_front", "ln_attn_back"] if needs_grad is None else [])
    got = got.detach()
    if needs_grad is None:
        max_ulps, rms_ulps = bf16_error(got, chain, x)
        assert max_ulps <= BF16_MAX_ULPS and rms_ulps <= BF16_RMS_ULPS, (max_ulps, rms_ulps)
        # The front is the chain's LN1 and projection bit for bit.
        attn = blk["attn"]
        qkv_p = {"w": attn["qkv"]["w"], "b": tclip._qkv_bias(attn["q"]["b"], attn["v"]["b"])}
        assert torch.equal(attn_block.ln_attn_front(blk["ln_1"], qkv_p, x, 1e-6),
                           tclip.linear(qkv_p, layer_norm(blk["ln_1"], x, eps=1e-6)))
    else:
        assert torch.equal(got, chain)


# --------------------------------------------------------------------------
# On the card
# --------------------------------------------------------------------------

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _ulps_ok(out, want, base=None):
    torch.cuda.synchronize()
    max_ulps, rms_ulps = bf16_error(out, want, base)
    return max_ulps <= BF16_MAX_ULPS and rms_ulps <= BF16_RMS_ULPS, (max_ulps, rms_ulps)


@pytest.mark.cuda
@pytest.mark.parametrize("b,grid,per_sample", [(32, 37, False), (3, 37, True), (2, 5, False)])
def test_rope_kernel_matches_plain_on_the_card(dev, b, grid, per_sample):
    g = torch.Generator(device=dev).manual_seed(7)
    l, w, heads = grid * grid + 1, 1024, 16
    qkv = torch.randn(b, l, 3 * w, generator=g, device=dev).to(torch.bfloat16)
    table = trope.rope_table(grid, 16, 64, dev)
    if per_sample:
        keep = torch.stack([torch.randperm(grid * grid, device=dev)[:l - 1].sort().values
                            for _ in range(b)])
        table = table[:, keep]
    want = trope.rope_qk_reference(qkv, table, heads)
    before = profiling.counters()
    got = trope.rope_qk(qkv.clone(), table, heads)
    assert _build.launches(before) == {"rope_qk": 1}
    ok, err = _ulps_ok(got, want)
    assert ok, err
    assert torch.equal(got[:, 0], qkv[:, 0]) and torch.equal(got[..., 2 * w:], qkv[..., 2 * w:])
    wrong = _rope_off_k(qkv, table, heads)
    assert not _ulps_ok(wrong, want)[0]


@pytest.mark.cuda
@pytest.mark.parametrize("m,d,h", [(10960, 1024, 2730), (300, 1024, 2730), (77, 128, 340),
                                   (1, 256, 128)])
def test_ln_swiglu_residual_matches_its_stages_on_the_card(dev, m, d, h):
    ln, mlp = _mlp(d, h, torch.bfloat16)
    ln = {k: t.to(dev) for k, t in ln.items()}
    mlp = {k: {n: t.to(dev) for n, t in p.items()} for k, p in mlp.items()}
    x = torch.randn(m, d, generator=torch.Generator().manual_seed(2)).to(dev, torch.bfloat16)
    before = profiling.counters()
    got = swiglu.ln_swiglu_residual(ln, mlp, x)
    assert _build.launches(before) == {"ln_swiglu_residual": 1}
    stages = swiglu.ln_swiglu_residual_stages(ln, mlp, x)
    ok, err = _ulps_ok(got, stages, x)
    assert ok, err
    ops = swiglu.lay_out(*swiglu.leaves(mlp))
    ops.h = ops.hp
    if ops.hp != h:
        assert not _ulps_ok(got, swiglu.ln_swiglu_residual_stages(ln, mlp, x, ops=ops), x)[0]
    # A second call reads the same laid-out weights.
    assert torch.equal(swiglu.ln_swiglu_residual(ln, mlp, x), got)


def _f32(tree):
    return {k: _f32(v) if isinstance(v, dict) else v.float() for k, v in tree.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("m,seed", [(10960, 1), (10960, 2), (43840, 1)])
def test_ln_swiglu_residual_matches_the_stock_chain_on_the_card(dev, m, seed):
    """The kernel against the stock chain it stands for (LayerNorm, cuBLAS,
    SiLU, multiply, LayerNorm, cuBLAS, add) at the offline cells' rows
    (batch 8 and 32 at 518 px) and EVA02-CLIP-L's widths. The bf16 chain
    rounds both products, g and LN_ffn(g) where the kernel rounds g alone,
    so the two differ by the chain's roundings, which vary with the weights'
    draw (0.65 to 1.02 ulps RMS over seeds). So both are held to the chain's
    function, the same stock calls in float32 on the same bf16 input and
    weights: the kernel within the kernels' bf16 ulps and no further from it
    (RMS) than the bf16 chain is; the sub-LN over the padded width fails."""
    d, h = 1024, 2730
    ln, mlp = _mlp(d, h, torch.bfloat16, seed=seed)
    ln = {k: t.to(dev) for k, t in ln.items()}
    mlp = {k: {n: t.to(dev) for n, t in p.items()} for k, p in mlp.items()}
    x = torch.randn(m, d, generator=torch.Generator().manual_seed(3)).to(dev, torch.bfloat16)
    exact = swiglu.ln_swiglu_residual_reference(_f32(ln), _f32(mlp), x.float())
    chain = swiglu.ln_swiglu_residual_reference(ln, mlp, x)
    got = swiglu.ln_swiglu_residual(ln, mlp, x)
    ok, err = _ulps_ok(got, exact, x)
    chain_err = bf16_error(chain, exact, x)
    assert ok and err[1] <= chain_err[1], (err, chain_err, bf16_error(got, chain, x))
    ops = swiglu.lay_out(*swiglu.leaves(mlp))
    ops.h = ops.hp
    assert not _ulps_ok(swiglu.ln_swiglu_residual_stages(ln, mlp, x, ops=ops), exact, x)[0]


@pytest.mark.cuda
def test_the_layer_norm_pass_refuses_what_it_cannot_take_on_the_card(dev):
    ln = {"scale": torch.ones(64, device=dev), "bias": torch.zeros(64, device=dev)}
    x = torch.randn(8, 64, device=dev)
    for bad in (x, x.to(torch.bfloat16).t(), x[:, :60].to(torch.bfloat16).contiguous()):
        with pytest.raises(ValueError, match="layer_norm_rows"):
            swiglu.layer_norm_rows(ln, bad)


@pytest.mark.cuda
@pytest.mark.parametrize("m,d", [(43840, 1024), (77, 64)])
def test_layer_norm_pass_matches_layer_norm_on_the_card(dev, m, d):
    g = torch.Generator(device=dev).manual_seed(5)
    ln = {"scale": 1 + 0.02 * torch.randn(d, generator=g, device=dev),
          "bias": 0.02 * torch.randn(d, generator=g, device=dev)}
    x = (3 * torch.randn(m, d, generator=g, device=dev) + 1).to(torch.bfloat16)
    ok, err = _ulps_ok(swiglu.layer_norm_rows(ln, x, 1e-6), layer_norm(ln, x, eps=1e-6))
    assert ok, err
