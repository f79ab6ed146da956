"""The port against the fixtures recorded from the EXECUTED reference program.

The counterpart of tests/test_reference_fixtures.py for the port, case for
case but the two ModifiedResNet ones (not ported), at the same tolerances.
The weights are regenerated from the recorded key/shape manifests
(tests/fixture_weights.py) and carried by the port's own converter,
``torch_state_dict_to_params``, then ``params_from_jax`` onto the CPU in
float32. Everything runs on the CPU, where each kernel wrapper runs its
plain version.
"""
import json
import os

import numpy as np
import pytest
import torch

from fixture_weights import synth_state_dict

from aa_clip_iqm_tpu_torch.configs import (
    AdapterConfig,
    CLIPConfig,
    IQMConfig,
    ModelConfig,
    TextConfig,
    VisionConfig,
)
from aa_clip_iqm_tpu_torch.evaluation import scoring
from aa_clip_iqm_tpu_torch.models import adapters as adapters_mod
from aa_clip_iqm_tpu_torch.models import clip as clip_mod
from aa_clip_iqm_tpu_torch.models import iqm as iqm_mod
from aa_clip_iqm_tpu_torch.models.convert import params_from_jax, torch_state_dict_to_params
from aa_clip_iqm_tpu_torch.ops import losses, metrics
from aa_clip_iqm_tpu_torch.ops.attention import vv_attention_batch_axis
from aa_clip_iqm_tpu_torch.ops.layers import ACTIVATIONS, layer_norm, linear, mlp_block

FIXTURE_DIR = os.path.join(os.path.dirname(__file__), "fixtures")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    torch.set_num_threads(1)


def _load(name):
    with np.load(os.path.join(FIXTURE_DIR, name + ".npz")) as data:
        return {k: data[k] for k in data.files}


def _meta(fx, key):
    return json.loads(bytes(fx[key]).decode("utf-8"))


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _np(x):
    return x.detach().float().numpy()


def _clip_config(raw) -> CLIPConfig:
    v, t = raw["vision_cfg"], raw["text_cfg"]
    return CLIPConfig(
        embed_dim=raw["embed_dim"],
        vision=VisionConfig(
            image_size=v["image_size"], patch_size=v["patch_size"],
            width=v["width"], layers=v["layers"], head_width=v["head_width"],
            output_dim=raw["embed_dim"]),
        text=TextConfig(
            context_length=t["context_length"], vocab_size=t["vocab_size"],
            width=t["width"], heads=t["heads"], layers=t["layers"],
            output_dim=raw["embed_dim"]),
        act="gelu",       # the live reference path builds CLIP without quick_gelu
    )


def _frozen(sd, clip_cfg):
    """The port's frozen dict from a state dict, through its own converter."""
    params = torch_state_dict_to_params(sd, clip_cfg)
    frozen, _ = params_from_jax(params, None, ModelConfig(clip=clip_cfg),
                                device="cpu", dtype=torch.float32)
    return frozen


# --------------------------------------------------------------------------
# Small-config CLIP towers
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def small_clip():
    fx = _load("small_clip")
    cfg = _clip_config(_meta(fx, "config_json"))
    return fx, cfg, _frozen(synth_state_dict(_meta(fx, "manifest_json")), cfg)


def test_vision_forward_matches_executed_reference(small_clip):
    fx, cfg, params = small_clip
    out_layers = tuple(int(v) for v in fx["out_layers"])
    pooled, taps, _ = clip_mod.vision_forward(
        params["visual"], cfg.vision, _t(fx["image"]), out_layers=out_layers,
        act_name=cfg.act)
    np.testing.assert_allclose(_np(pooled), fx["pooled"], rtol=2e-5, atol=2e-5)
    for i in range(len(out_layers)):
        np.testing.assert_allclose(_np(taps[i]), fx[f"tap_{i}"], rtol=2e-5, atol=2e-5)


def test_encode_image_matches_executed_reference(small_clip):
    """CLIP.encode_image on the ViT tower: the pooled embedding."""
    fx, cfg, params = small_clip
    pooled = clip_mod.encode_image(params, cfg, _t(fx["image"]))
    np.testing.assert_allclose(_np(pooled), fx["pooled"], rtol=2e-5, atol=2e-5)


def test_text_forward_matches_executed_reference(small_clip):
    fx, cfg, params = small_clip
    out = clip_mod.text_forward(params["text"], cfg.text, _t(fx["tokens"]),
                                act_name=cfg.act)
    np.testing.assert_allclose(_np(out), fx["text_out"], rtol=2e-5, atol=2e-5)


# --------------------------------------------------------------------------
# Tokenizer + prompt engine (recorded with the reference's own vocabulary
# file and its own prompt crossing / pooling code)
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tokenizer_fx():
    fx = _load("tokenizer")
    return fx, _meta(fx, "config_json")


def test_prompt_sentences_match_executed_reference(tokenizer_fx):
    from aa_clip_iqm_tpu_torch import prompts

    fx, raw = tokenizer_fx
    for ds, cls in raw["classes"]:
        groups = prompts.class_prompt_sentences(ds, cls)
        assert [list(g) for g in groups] == raw["sentences"][f"{ds}__{cls}"]


def test_prompt_tokens_match_executed_reference(tokenizer_fx):
    from aa_clip_iqm_tpu_torch import prompts
    from aa_clip_iqm_tpu_torch.tokenizer import tokenize

    fx, raw = tokenizer_fx
    for ds, cls in raw["classes"]:
        key = f"{ds}__{cls}"
        tokens = prompts.class_prompt_tokens(ds, cls, device="cpu")
        for gi, kind in enumerate(("normal", "abnormal")):
            np.testing.assert_array_equal(tokenize(raw["sentences"][key][gi]),
                                          fx[f"tokens_{key}_{kind}"])
            np.testing.assert_array_equal(tokens[gi].numpy(), fx[f"tokens_{key}_{kind}"])


def test_tokenize_extra_texts_match_executed_reference(tokenizer_fx):
    from aa_clip_iqm_tpu_torch.tokenizer import tokenize

    fx, raw = tokenizer_fx
    np.testing.assert_array_equal(tokenize(raw["extra_texts"]), fx["tokens_extra"])
    np.testing.assert_array_equal(tokenize([raw["long_text"]], truncate=True),
                                  fx["tokens_truncated"])


def test_class_anchor_matches_executed_reference(tokenizer_fx):
    """Prompts -> tokens -> text tower -> normalize, mean-pool, normalize,
    stack, against the anchors the reference program computed."""
    from aa_clip_iqm_tpu_torch import prompts

    fx, raw = tokenizer_fx
    cfg = _clip_config(raw["clip"])
    params = _frozen(synth_state_dict(_meta(fx, "manifest_json")), cfg)

    def encode(tokens):
        return clip_mod.text_forward(params["text"], cfg.text, tokens, act_name=cfg.act)

    for ds, cls in raw["classes"]:
        anchor = prompts.compute_class_anchor(encode, ds, cls, device="cpu")
        np.testing.assert_allclose(_np(anchor), fx[f"anchor_{ds}__{cls}"],
                                   rtol=2e-5, atol=2e-5)


# --------------------------------------------------------------------------
# Surgery with the executed batch-axis value-value attention
# --------------------------------------------------------------------------

def _executed_surgery_tower(params, cfg, images, out_layers, vv_from):
    """The vision tower with the executed reference's surgery: blocks
    [vv_from, layers) run the batch-axis value-value attention."""
    vis = params["visual"]
    act = ACTIVATIONS[cfg.act]
    x = clip_mod.embed_patches(vis, cfg.vision, images, torch.float32)
    x, taps = clip_mod.run_blocks(vis["blocks"], x, cfg.vision.heads, act,
                                  out_layers=out_layers, stop=vv_from)
    for i in range(vv_from, cfg.vision.layers):
        block = vis["blocks"][i]
        h = layer_norm(block["ln_1"], x)
        x = x + vv_attention_batch_axis(block["attn"], h, cfg.vision.heads)
        x = x + mlp_block(block["mlp"], layer_norm(block["ln_2"], x), act)
        if i + 1 in out_layers:
            taps.append(x)
    pooled = linear({"w": vis["proj"]}, layer_norm(vis["ln_post"], x[:, 0]))
    return pooled, taps


def test_surgery_batch_axis_matches_executed_reference(small_clip):
    _, cfg, params = small_clip
    fx = _load("small_clip_surgery")
    vv_from = clip_mod.surgery_vv_from(cfg.vision.layers,
                                       _meta(fx, "config_json")["dpam_layer"])
    out_layers = tuple(int(v) for v in fx["out_layers"])
    pooled, taps = _executed_surgery_tower(params, cfg, _t(fx["image"]),
                                           out_layers, vv_from)
    np.testing.assert_allclose(_np(pooled), fx["pooled"], rtol=2e-5, atol=2e-5)
    assert len(taps) == len(out_layers)
    for i in range(len(out_layers)):
        np.testing.assert_allclose(_np(taps[i]), fx[f"tap_{i}"], rtol=2e-5, atol=2e-5)


def test_surgery_differs_from_token_axis_vv(small_clip):
    """The executed batch-axis semantics is not the token-axis value-value
    surgery of the shipped pipeline."""
    _, cfg, params = small_clip
    fx = _load("small_clip_surgery")
    vv_from = clip_mod.surgery_vv_from(cfg.vision.layers,
                                       _meta(fx, "config_json")["dpam_layer"])
    _, taps, _ = clip_mod.vision_forward(
        params["visual"], cfg.vision, _t(fx["image"]),
        out_layers=(cfg.vision.layers,), act_name=cfg.act, vv_from=vv_from)
    assert not np.allclose(_np(taps[-1]), fx["tap_2"], atol=1e-3)


# --------------------------------------------------------------------------
# IQM
# --------------------------------------------------------------------------

def _lin(sd, prefix):
    p = {"w": sd[prefix + ".weight"].T}
    if prefix + ".bias" in sd:
        p["b"] = sd[prefix + ".bias"]
    return p


def _ln(sd, prefix):
    return {"scale": sd[prefix + ".weight"], "bias": sd[prefix + ".bias"]}


def map_iqm_state_dict(sd, n_layers: int, freq: int):
    """Reference IQM module keys -> the IQM pytree (numpy, JAX layout)."""
    def attn(prefix):
        return {"q": _lin(sd, prefix + ".attention.query"),
                "k": _lin(sd, prefix + ".attention.key"),
                "v": _lin(sd, prefix + ".attention.value"),
                "out_dense": _lin(sd, prefix + ".output.dense"),
                "out_ln": _ln(sd, prefix + ".output.LayerNorm")}

    layers = []
    for i in range(n_layers):
        pre = f"encoder.layer.{i}"
        layer = {"self": attn(pre + ".attention")}
        if i % freq == 0:
            layer["cross"] = attn(pre + ".crossattention")
            layer["text_cross"] = attn(pre + ".text_crossattention")
        layer["ffn_q"] = {"intermediate": _lin(sd, pre + ".intermediate_query.dense"),
                          "output": _lin(sd, pre + ".output_query.dense"),
                          "ln": _ln(sd, pre + ".output_query.LayerNorm")}
        layers.append(layer)
    return {"layernorm": _ln(sd, "layernorm"), "layers": layers}


def _torch_tree(tree):
    """A numpy tree (dicts and lists) -> float32 CPU tensors."""
    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_torch_tree(v) for v in tree]
    return _t(np.asarray(tree, np.float32))


@pytest.mark.parametrize("name", ["small_iqm", "small_iqm_freq2"])
def test_iqm_forward_matches_executed_reference(name):
    fx = _load(name)
    kw = _meta(fx, "config_json")
    cfg = IQMConfig(
        hidden_size=kw["hidden_size"], num_hidden_layers=kw["num_hidden_layers"],
        num_attention_heads=kw["num_attention_heads"],
        intermediate_size=kw["intermediate_size"],
        encoder_hidden_size=kw["encoder_hidden_size"],
        text_encoder_hidden_size=kw["text_encoder_hidden_size"],
        cross_attention_frequency=kw["cross_attention_frequency"])
    sd = synth_state_dict(_meta(fx, "manifest_json"))
    params = _torch_tree(map_iqm_state_dict(sd, cfg.num_hidden_layers,
                                            cfg.cross_attention_frequency))
    out = iqm_mod.iqm_forward(params, cfg, _t(fx["queries"]), _t(fx["visual"]),
                              _t(fx["text"]))
    np.testing.assert_allclose(_np(out), fx["out"], rtol=2e-5, atol=2e-5)


# --------------------------------------------------------------------------
# AdaptedCLIP at the live ViT-L geometry
# --------------------------------------------------------------------------

def map_adapted_trainable(sd, cfg: ModelConfig):
    """Reference AdaptedCLIP trainable keys -> the trainable pytree (numpy,
    JAX layout: layer axes stacked). The lazily created
    visual/text_feature_proj take the values the recorder injected."""
    a = cfg.adapter
    n_levels = len(a.levels)
    iqm_sd = {k[len("iqm."):]: v for k, v in sd.items() if k.startswith("iqm.")}
    return {
        "image_adapter": {
            "layer_adapters": {"w": np.stack(
                [sd[f"image_adapter.layer_adapters.{i}.fc.0.weight"].T
                 for i in range(a.image_adapt_until)])},
            "seg_proj": [{"w": sd[f"image_adapter.seg_proj.{i}.fc.weight"].T}
                         for i in range(n_levels)],
            "det_proj": {"w": sd["image_adapter.det_proj.fc.weight"].T},
        },
        "text_adapter": {
            "layers": {"w": np.stack([sd[f"text_adapter.{i}.fc.0.weight"].T
                                      for i in range(a.text_adapt_until)])},
            "proj": {"w": sd[f"text_adapter.{a.text_adapt_until}.fc.0.weight"].T},
        },
        "iqm": map_iqm_state_dict(iqm_sd, cfg.iqm.num_hidden_layers,
                                  cfg.iqm.cross_attention_frequency),
        "class_query_mlp": {"fc1": _lin(sd, "class_query_mlp.0"),
                            "fc2": _lin(sd, "class_query_mlp.2")},
        "query_adapters": [{"w": sd[f"query_adapters.{i}.fc.weight"].T}
                           for i in range(n_levels)],
        "pos_embedding": sd["pos_embedding"][:, :2, :],
        "visual_feature_proj": _lin(sd, "visual_feature_proj"),
        "text_feature_proj": _lin(sd, "text_feature_proj"),
        "query_proj": {"w": np.zeros((cfg.iqm.hidden_size, cfg.clip.embed_dim), np.float32),
                       "b": np.zeros((cfg.clip.embed_dim,), np.float32)},
        "iqm_layer_norm": _ln(sd, "iqm_layer_norm"),
    }


@pytest.fixture(scope="module")
def adapted_full():
    fx = _load("adapted_full")
    raw = _meta(fx, "config_json")
    clip_cfg = _clip_config(raw)
    cfg = ModelConfig(
        clip=clip_cfg,
        adapter=AdapterConfig(),   # the live defaults: until 3/6, 4 levels, no relu
        iqm=IQMConfig(
            hidden_size=raw["iqm"]["hidden_size"],
            num_hidden_layers=raw["iqm"]["num_layers"],
            num_attention_heads=raw["iqm"]["num_heads"],
            encoder_hidden_size=raw["iqm"]["hidden_size"],
            text_encoder_hidden_size=clip_cfg.text.width))
    sd = synth_state_dict(_meta(fx, "manifest_json"))
    trainable_np = map_adapted_trainable(sd, cfg)
    frozen_np = torch_state_dict_to_params(sd, clip_cfg)
    del sd
    frozen, trainable = params_from_jax(frozen_np, trainable_np, cfg,
                                        device="cpu", dtype=torch.float32)
    return fx, cfg, frozen, trainable


def test_adapted_forward_matches_executed_reference(adapted_full):
    fx, cfg, frozen, trainable = adapted_full
    b = fx["image"].shape[0]
    anchors = _t(fx["anchors"])[None].expand(b, *fx["anchors"].shape)
    with torch.no_grad():
        out = adapters_mod.encode_image_adapted(frozen, trainable, cfg, _t(fx["image"]),
                                                text_anchors=anchors)
    for i in range(len(cfg.adapter.levels)):
        np.testing.assert_allclose(_np(out.seg_tokens[i]), fx[f"seg_{i}"],
                                   rtol=5e-4, atol=5e-5)
    np.testing.assert_allclose(_np(out.det_token), fx["det_token"], rtol=5e-4, atol=5e-5)
    np.testing.assert_allclose(_np(out.iqm_queries), fx["iqm_out"], rtol=5e-4, atol=5e-4)


def test_adapted_encode_text_matches_executed_reference(adapted_full):
    fx, cfg, frozen, trainable = adapted_full
    tokens = _t(fx["tokens"])
    with torch.no_grad():
        out = adapters_mod.encode_text_adapted(frozen, trainable, cfg, tokens)
        frozen_out = adapters_mod.encode_text_frozen(frozen, cfg, tokens)
    np.testing.assert_allclose(_np(out), fx["text_out"], rtol=5e-4, atol=5e-5)
    np.testing.assert_allclose(_np(frozen_out), fx["text_frozen"], rtol=5e-4, atol=5e-5)


# --------------------------------------------------------------------------
# forward_utils math (similarity map, seg loss, metrics)
# --------------------------------------------------------------------------

def test_similarity_map_train_matches_executed_reference():
    fx = _load("forward_utils")
    b = fx["feats"].shape[0]
    anchors = _t(fx["anchors"])[None].expand(b, *fx["anchors"].shape)
    sim = scoring.similarity_map_train(_t(fx["feats"]), anchors,
                                       fx["sim_train"].shape[-1])
    np.testing.assert_allclose(_np(sim), fx["sim_train"], rtol=2e-5, atol=2e-6)


def test_seg_loss_matches_executed_reference():
    fx = _load("forward_utils")
    loss = losses.seg_loss(_t(fx["sim_train"]), _t(fx["mask"]))
    np.testing.assert_allclose(float(loss), float(fx["seg_loss"]), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("domain,key", [("Industrial", "metrics_industrial"),
                                        ("Medical", "metrics_medical")])
def test_metrics_eval_matches_executed_reference(domain, key):
    fx = _load("forward_utils")
    res = metrics.metrics_eval(fx["pixel_label"], fx["image_label"], fx["pixel_preds"],
                               fx["image_preds"], "x", domain, device="cpu")
    got = np.asarray([res["pixel AUC"], res["pixel AP"], res["image AUC"], res["image AP"]])
    np.testing.assert_allclose(got, fx[key], atol=0.011)


# --------------------------------------------------------------------------
# The eval driver's map math (the reference's get_predictions, executed)
# --------------------------------------------------------------------------

def test_eval_maps_match_executed_reference():
    """IQM query maps through the executed fresh-Linear projection, sigmoid
    cosine differences, align_corners=False upsampling, the 0.6/0.4 fusion
    and the (B, B, 2)-broadcast image score; the text maps are recorded
    inputs."""
    fx = _load("eval_maps")
    cfg = _meta(fx, "config_json")
    img = cfg["img"]
    q_proj = torch.einsum("bqd,fd->bqf", _t(fx["queries"]), _t(fx["proj_w"])) \
        + _t(fx["proj_b"])
    iqm_maps, text_maps = [], []
    for i in range(cfg["levels"]):
        iqm_maps.append(scoring.iqm_score_map(_t(fx[f"feat_{i}"]), q_proj, img,
                                              align_corners=False))
        text_maps.append(_t(fx[f"text_map_{i}"])[:, 0])
    final = scoring.fuse_maps(text_maps, iqm_maps)
    np.testing.assert_allclose(_np(final), fx["preds"][:, 0], rtol=2e-5, atol=2e-6)

    b = fx["det"].shape[0]
    anchors = _t(fx["anchors"])[None].expand(b, *fx["anchors"].shape)
    score = scoring.image_logit_reference_eval(_t(fx["det"]), anchors)
    # Channel 0 of the recorded (B, 2) image preds: the NORMAL anchor.
    np.testing.assert_allclose(_np(score), fx["preds_image"][:, 0], rtol=1e-5, atol=1e-6)
