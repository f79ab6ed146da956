"""The port's model registry and its other two configs against the JAX
package's, on the CPU: the registry (C3: every config, ``list_models``,
``with_image_size``), ``encode_image``'s ``use_pallas`` and the prompt
helpers (C4), ViT-B-16-plus-240 at full width with 2 layers, and the
ModifiedResNet tower of RN50 (its bottleneck, attention pool and whole tower
at RN50 widths at 64 px, the executed-reference fixture, the OpenAI state
dict converter, the .pt -> .npz cache read by both packages and JAX's
refusals). Weights come from the JAX initializers and reach the port
through ``models.convert.params_from_jax``; everything is float32, where
each kernel wrapper runs its plain version.
"""
import dataclasses
import json
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aa_clip_iqm_tpu import configs as jconfigs
from aa_clip_iqm_tpu import loader as jloader
from aa_clip_iqm_tpu import prompts as jprompts
from aa_clip_iqm_tpu.models import clip as jclip
from aa_clip_iqm_tpu.models import convert as jconvert
from aa_clip_iqm_tpu.models import modified_resnet as jmr
from aa_clip_iqm_tpu_torch import configs as tconfigs
from aa_clip_iqm_tpu_torch import loader as tloader
from aa_clip_iqm_tpu_torch import prompts as tprompts
from aa_clip_iqm_tpu_torch.models import clip as tclip
from aa_clip_iqm_tpu_torch.models import convert as tconvert
from aa_clip_iqm_tpu_torch.models import modified_resnet as tmr
from aa_clip_iqm_tpu_torch.ops import fused_mlp, quant as tquant
from aa_clip_iqm_tpu_torch.tokenizer import tokenize
from fixture_weights import synth_state_dict
from torch_ref import make_rn_state_dict

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    torch.set_num_threads(1)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close_rel(out, ref, rtol):
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(np.asarray(out, np.float32), ref, rtol=rtol,
                               atol=rtol * np.abs(ref).max())


def _bridge(frozen, cfg):
    """JAX params -> the port's float32 tensors on the CPU."""
    tf, _ = tconvert.params_from_jax(_np(frozen), None, cfg, device="cpu",
                                     dtype=torch.float32)
    return tf


# --------------------------------------------------------------------------
# C3: the registry
# --------------------------------------------------------------------------

def test_list_models_matches_jax():
    assert tconfigs.list_models() == jconfigs.list_models()
    assert tconfigs.list_models() == ["RN50", "ViT-B-16-plus-240", "ViT-L-14-336"]


@pytest.mark.parametrize("name", ["RN50", "ViT-B-16-plus-240", "ViT-L-14-336"])
@pytest.mark.parametrize("img_size", [None, 448])
def test_get_model_config_matches_jax(name, img_size):
    got = tconfigs.get_model_config(name, img_size=img_size)
    want = jconfigs.get_model_config(name, img_size=img_size)
    assert type(got.vision).__name__ == type(want.vision).__name__
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    if name == "ViT-B-16-plus-240":
        assert (got.vision.width, got.vision.heads, got.vision.patch_size) == (896, 14, 16)
    if name == "RN50":
        assert got.vision.num_heads == want.vision.num_heads == 32
        assert got.vision.final_channels == 2048 and got.vision.reduction == 32


@pytest.mark.parametrize("name", ["RN50", "ViT-B-16-plus-240", "ViT-L-14-336"])
def test_with_image_size_matches_jax(name):
    got = tconfigs.get_model_config(name).with_image_size(320)
    want = jconfigs.get_model_config(name).with_image_size(320)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.vision.image_size == 320


def test_registry_files_are_the_ports_own_copies():
    port = os.path.join(os.path.dirname(tconfigs.__file__), "registry", "model_configs")
    jax_dir = os.path.join(os.path.dirname(jconfigs.__file__), "registry", "model_configs")
    for name in jconfigs.list_models():
        with open(os.path.join(port, name + ".json")) as f, \
                open(os.path.join(jax_dir, name + ".json")) as g:
            assert json.load(f) == json.load(g)


# --------------------------------------------------------------------------
# C4: encode_image's use_pallas and the prompt helpers
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny():
    cfg = jconfigs.tiny_test_config(56)
    tcfg = tconfigs.tiny_test_config(56)
    frozen = jclip.init_clip_params(jax.random.PRNGKey(0), cfg.clip)
    return cfg, tcfg, frozen, _bridge(frozen, tcfg)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_encode_image_use_pallas_matches_jax(tiny, use_pallas):
    """``use_pallas=False`` reaches the stock route (no kernel wrapper); both
    routes match JAX's ``encode_image`` with the same flag."""
    cfg, tcfg, frozen, tf = tiny
    imgs = np.random.default_rng(1).standard_normal((2, 3, 56, 56)).astype(np.float32)
    want = jclip.encode_image(frozen, cfg.clip, jnp.asarray(imgs), use_pallas=False)
    calls = {"n": 0}
    real = fused_mlp.ln_mlp_residual

    def counting(*a, **k):
        calls["n"] += 1
        return real(*a, **k)

    tclip.ln_mlp_residual = counting
    try:
        got = tclip.encode_image(tf, tcfg.clip, torch.from_numpy(imgs), use_pallas=use_pallas)
    finally:
        tclip.ln_mlp_residual = real
    assert calls["n"] == (tcfg.clip.vision.layers if use_pallas else 0)
    _close_rel(got.numpy(), want, 1e-4)


def test_prompt_helpers_match_jax(tiny):
    cfg, tcfg, frozen, tf = tiny

    def jenc(tokens):
        return jclip.text_forward(frozen["text"], cfg.clip.text, tokens)

    def tenc(tokens):
        return tclip.text_forward(tf["text"], tcfg.clip.text, tokens)

    want = jprompts.compute_all_anchors(jenc, "BTAD")
    got = tprompts.compute_all_anchors(tenc, "BTAD", device="cpu")
    assert list(got) == list(want)
    for c in want:
        assert got[c].shape == want[c].shape
        _close_rel(got[c].numpy(), want[c], 1e-4)
    sent = tprompts.per_sentence_embeddings(tenc, "BTAD", "01", device="cpu")
    _close_rel(sent.numpy(), jprompts.per_sentence_embeddings(jenc, "BTAD", "01"), 1e-4)
    names = ["02", "01", "02"]
    stacked = tprompts.stack_batch_anchors(got, names)
    assert stacked.shape == (3, cfg.clip.embed_dim, 2)
    _close_rel(stacked.numpy(), jprompts.stack_batch_anchors(want, names), 1e-4)


# --------------------------------------------------------------------------
# ViT-B-16-plus-240 at full width, 2 layers
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def vit_b16_plus():
    def cut(c):
        return dataclasses.replace(c, vision=dataclasses.replace(c.vision, layers=2),
                                   text=dataclasses.replace(c.text, layers=2))

    cfg = cut(jconfigs.get_model_config("ViT-B-16-plus-240"))
    tcfg = cut(tconfigs.get_model_config("ViT-B-16-plus-240"))
    frozen = jclip.init_clip_params(jax.random.PRNGKey(3), cfg)
    tf, _ = tconvert.params_from_jax(_np(frozen), None, tconfigs.ModelConfig(clip=tcfg),
                                     device="cpu", dtype=torch.float32)
    return cfg, tcfg, frozen, tf


@pytest.mark.parametrize("img", [240, 512])
def test_vit_b16_plus_encode_image_matches_jax(vit_b16_plus, img):
    """896 wide, 14 heads of 64: at 240 px 226 tokens (the plain attention),
    at 512 px 1025 (the packed attention's plain version); each block's MLP
    through B2's plain version at d 896, h 3584."""
    cfg, tcfg, frozen, tf = vit_b16_plus
    jc, tc = cfg.with_image_size(img), tcfg.with_image_size(img)
    jf = dict(frozen, visual=dict(frozen["visual"], positional_embedding=jnp.asarray(
        jclip.resize_pos_embed_np(np.asarray(frozen["visual"]["positional_embedding"]),
                                  jc.vision.grid))))
    tvis = dict(tf["visual"], positional_embedding=torch.from_numpy(
        np.array(jf["visual"]["positional_embedding"])))
    imgs = np.random.default_rng(img).standard_normal((1, 3, img, img)).astype(np.float32)
    want = jclip.encode_image(jf, jc, jnp.asarray(imgs))
    got = tclip.encode_image(dict(tf, visual=tvis), tc, torch.from_numpy(imgs))
    assert got.shape == (1, 640)
    _close_rel(got.numpy(), want, 1e-4)


def test_vit_b16_plus_text_forward_matches_jax(vit_b16_plus):
    cfg, tcfg, frozen, tf = vit_b16_plus
    tokens = np.asarray(tokenize(["a photo of a flawless bottle.",
                                  "a photo of a damaged screw."]), np.int64)
    want = jclip.text_forward(frozen["text"], cfg.text, jnp.asarray(tokens, jnp.int32))
    got = tclip.text_forward(tf["text"], tcfg.text, torch.from_numpy(tokens))
    assert got.shape == (2, 640)
    _close_rel(got.numpy(), want, 1e-4)


# --------------------------------------------------------------------------
# A13: the ModifiedResNet tower (RN50)
# --------------------------------------------------------------------------

RN50_64 = jconfigs.get_model_config("RN50", img_size=64)
TRN50_64 = tconfigs.get_model_config("RN50", img_size=64)


@pytest.fixture(scope="module")
def rn50():
    """RN50's vision tower at 64 px from JAX's initializer, with random
    BatchNorm statistics, as numpy and as the port's tensors."""
    params = _np(jmr.init_resnet_params(jax.random.PRNGKey(5), RN50_64.vision))
    rng = np.random.default_rng(5)

    def randomize(tree):
        if isinstance(tree, dict):
            if set(tree) == {"scale", "bias", "mean", "var"}:
                c = tree["mean"].shape
                return {"scale": (1 + 0.1 * rng.standard_normal(c)).astype(np.float32),
                        "bias": (0.1 * rng.standard_normal(c)).astype(np.float32),
                        "mean": (0.1 * rng.standard_normal(c)).astype(np.float32),
                        "var": (1 + rng.random(c)).astype(np.float32)}
            return {k: randomize(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [randomize(v) for v in tree]
        return tree

    params = randomize(params)
    tparams = tconvert._convert(params, "cpu", torch.float32)
    return params, tparams


def test_rn50_bottleneck_matches_jax(rn50):
    """Stage 2's first bottleneck (256 -> 512 channels, stride 2: the
    anti-aliased average pool and the downsample branch)."""
    params, tparams = rn50
    x = np.random.default_rng(6).standard_normal((2, 256, 16, 16)).astype(np.float32)
    want = jmr.bottleneck_forward(params["layers"][1][0], jnp.asarray(x), stride=2)
    got = tmr.bottleneck_forward(tparams["layers"][1][0], torch.from_numpy(x), stride=2)
    assert got.shape == (2, 512, 8, 8)
    _close_rel(got.numpy(), want, 1e-4)


def test_rn50_attention_pool_matches_jax(rn50):
    params, tparams = rn50
    x = np.random.default_rng(7).standard_normal((2, 2048, 2, 2)).astype(np.float32)
    want = jmr.attention_pool_forward(params["attnpool"], jnp.asarray(x), 32)
    got = tmr.attention_pool_forward(tparams["attnpool"], torch.from_numpy(x), 32)
    assert got.shape == (2, 1024)
    _close_rel(got.numpy(), want, 1e-4)


def test_rn50_tower_matches_jax(rn50):
    params, tparams = rn50
    imgs = np.random.default_rng(8).standard_normal((2, 3, 64, 64)).astype(np.float32)
    want, wfeats = jmr.resnet_forward(params, RN50_64.vision, jnp.asarray(imgs))
    got, feats = tmr.resnet_forward(tparams, TRN50_64.vision, torch.from_numpy(imgs))
    assert [tuple(f.shape) for f in feats] == [f.shape for f in wfeats]
    for f, w in zip(feats, wfeats):
        _close_rel(f.numpy(), w, 1e-4)
    _close_rel(got.numpy(), want, 1e-4)
    frozen = {"visual": tparams}
    enc = tclip.encode_image(frozen, TRN50_64, torch.from_numpy(imgs))
    assert torch.equal(enc, got)


@pytest.fixture(scope="module")
def small_resnet():
    with np.load(os.path.join(FIXTURES, "small_resnet.npz")) as data:
        fx = {k: data[k] for k in data.files}
    raw = json.loads(bytes(fx["config_json"]).decode("utf-8"))
    v, t = raw["vision_cfg"], raw["text_cfg"]
    cfg = tconfigs.CLIPConfig(
        embed_dim=raw["embed_dim"],
        vision=tconfigs.ResNetVisionConfig(
            image_size=v["image_size"], layers=tuple(v["layers"]), width=v["width"],
            output_dim=raw["embed_dim"], heads=v["width"] * 32 // v["head_width"]),
        text=tconfigs.TextConfig(
            context_length=t["context_length"], vocab_size=t["vocab_size"],
            width=t["width"], heads=t["heads"], layers=t["layers"],
            output_dim=raw["embed_dim"]),
        act="gelu")
    sd = synth_state_dict(json.loads(bytes(fx["manifest_json"]).decode("utf-8")))
    params = tconvert.torch_state_dict_to_params(sd, cfg)
    frozen, _ = tconvert.params_from_jax(params, None, tconfigs.ModelConfig(clip=cfg),
                                         device="cpu", dtype=torch.float32)
    return fx, cfg, frozen


def test_small_resnet_vision_matches_executed_reference(small_resnet):
    """tests/fixtures/small_resnet.npz at the JAX test's tolerance
    (tests/test_reference_fixtures.py)."""
    fx, cfg, frozen = small_resnet
    pooled = tclip.encode_image(frozen, cfg, torch.from_numpy(fx["image"]))
    np.testing.assert_allclose(pooled.numpy(), fx["pooled"], rtol=2e-5, atol=2e-5)


def test_small_resnet_text_matches_executed_reference(small_resnet):
    fx, cfg, frozen = small_resnet
    out = tclip.text_forward(frozen["text"], cfg.text, torch.from_numpy(fx["tokens"]).long(),
                             act_name=cfg.act)
    np.testing.assert_allclose(out.numpy(), fx["text_out"], rtol=2e-5, atol=2e-5)


def _flat(tree):
    return dict(tconvert._flatten(jax.tree.map(np.asarray, tree)))


@pytest.mark.parametrize("img", [224, 64])
def test_resnet_state_dict_to_params_matches_jax(img):
    """An OpenAI RN50-layout state dict (224 px grid) through both
    converters: every leaf bit for bit, the attention pool's positional
    embedding resized alike at 64 px."""
    sd = make_rn_state_dict(np.random.default_rng(9), layers=(3, 4, 6, 3), width=64,
                            embed_dim=1024, image_size=224, t_layers=2, t_width=64)
    jcfg = jconfigs.get_model_config("RN50", img_size=img)
    tcfg = tconfigs.get_model_config("RN50", img_size=img)
    jcfg = dataclasses.replace(jcfg, text=dataclasses.replace(jcfg.text, width=64, layers=2,
                                                              vocab_size=1000))
    tcfg = dataclasses.replace(tcfg, text=dataclasses.replace(tcfg.text, width=64, layers=2,
                                                              vocab_size=1000))
    got = _flat(tconvert.torch_state_dict_to_params(sd, tcfg))
    want = _flat(jconvert.torch_state_dict_to_params(sd, jcfg))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["visual/attnpool/positional_embedding"].shape == ((img // 32) ** 2 + 1, 2048)


@pytest.fixture(scope="module")
def tiny_rn(tmp_path_factory):
    """A tiny RN tower's OpenAI .pt and the configs that read it."""
    vis = dict(image_size=64, layers=(1, 1, 1, 1), width=16, output_dim=32, heads=4)
    text = dict(width=32, heads=4, layers=2, vocab_size=1000, output_dim=32)
    jcfg = jconfigs.ModelConfig(clip=jconfigs.CLIPConfig(
        embed_dim=32, vision=jconfigs.ResNetVisionConfig(**vis), text=jconfigs.TextConfig(**text)))
    tcfg = tconfigs.ModelConfig(clip=tconfigs.CLIPConfig(
        embed_dim=32, vision=tconfigs.ResNetVisionConfig(**vis), text=tconfigs.TextConfig(**text)))
    sd = make_rn_state_dict(np.random.default_rng(10), layers=vis["layers"], width=16,
                            embed_dim=32, image_size=64)
    path = str(tmp_path_factory.mktemp("rn") / "rn.pt")
    torch.save({k: torch.as_tensor(np.asarray(v)) for k, v in sd.items()}, path)
    return path, jcfg, tcfg


def test_pt_to_npz_cache_is_read_by_both_packages(tiny_rn, tmp_path, monkeypatch):
    """The port's converter tool writes the cache that JAX's loader reads,
    and the port's loader serves the same tensors from JAX's cache and from
    its own; at another image size both resize the attention pool's
    positional embedding alike. The tool reads the registry's config by
    name: it is pointed at the tiny tower's here."""
    from aa_clip_iqm_tpu_torch.tools import convert_backbone

    path, jcfg, tcfg = tiny_rn
    monkeypatch.setattr(tconfigs, "get_model_config",
                        lambda name, img_size=None: tcfg.clip.with_image_size(img_size))
    out = str(tmp_path / "rn.64.npz")
    assert convert_backbone.main(["--pt", path, "--model_name", "RN-tiny", "--img_size", "64",
                                  "--out", out]) == 0
    want = jloader.load_frozen_backbone(jcfg, path, cache_npz=False)
    got = _flat(jloader.load_frozen_backbone(jcfg, out))
    assert got.keys() == _flat(want).keys()
    for k, v in _flat(want).items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    direct = tloader.load_frozen_backbone(tcfg, path, device="cpu", dtype=torch.float32,
                                          cache_npz=False)
    jnpz = str(tmp_path / "jax.npz")
    jconvert.save_params_npz(want, jnpz)
    from_jax = tloader.load_frozen_backbone(tcfg, jnpz, device="cpu", dtype=torch.float32)
    for (k, a), (_, b) in zip(sorted(_flat_t(direct).items()), sorted(_flat_t(from_jax).items())):
        assert torch.equal(a, b), k
    big_j = dataclasses.replace(jcfg, clip=jcfg.clip.with_image_size(96))
    big_t = dataclasses.replace(tcfg, clip=tcfg.clip.with_image_size(96))
    jres = np.asarray(jloader.load_frozen_backbone(big_j, jnpz)["visual"]["attnpool"]
                      ["positional_embedding"])
    tres = tloader.load_frozen_backbone(big_t, jnpz, device="cpu", dtype=torch.float32)
    assert jres.shape == (10, 512)
    np.testing.assert_array_equal(tres["visual"]["attnpool"]["positional_embedding"].numpy(),
                                  jres)


def _flat_t(tree):
    return {k: torch.as_tensor(v) for k, v in tconvert._flatten(tree)}


def test_tiny_rn_encode_image_matches_jax(tiny_rn):
    path, jcfg, tcfg = tiny_rn
    jf = jloader.load_frozen_backbone(jcfg, path, cache_npz=False)
    tf = tloader.load_frozen_backbone(tcfg, path, device="cpu", dtype=torch.float32,
                                      cache_npz=False)
    imgs = np.random.default_rng(11).standard_normal((2, 3, 64, 64)).astype(np.float32)
    _close_rel(tclip.encode_image(tf, tcfg.clip, torch.from_numpy(imgs)).numpy(),
               jclip.encode_image(jf, jcfg.clip, jnp.asarray(imgs)), 1e-4)


def test_rn50_model_config_and_random_backbone_match_jax():
    """build_model_config's ResNet branch (backbone only, the reduction
    check) and the port's seeded RN50 weights with JAX's shapes."""
    got = tloader.build_model_config("RN50", img_size=224)
    want = jloader.build_model_config("RN50", img_size=224)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    for loader in (tloader, jloader):
        with pytest.raises(ValueError, match="reduction 32"):
            loader.build_model_config("RN50", img_size=100)
    meta = tloader.random_backbone(got, device="meta")
    shapes = jax.eval_shape(lambda: jclip.init_clip_params(jax.random.PRNGKey(0), want.clip))
    flat_jax = {k: tuple(v.shape) for k, v in _walk(shapes) if k != "logit_scale"}
    flat_jax = {k: s[1:] if "/blocks/" in k else s for k, s in flat_jax.items()}
    flat_meta = {re.sub(r"/blocks/\d+/", "/blocks/", k): tuple(v.shape)
                 for k, v in _walk(meta)}
    assert flat_meta == flat_jax


def _walk(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _walk(v, f"{prefix}{k}/")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _walk(v, f"{prefix}{i}/")
    else:
        yield prefix[:-1], tree


def test_refusals_match_jax(tiny_rn):
    """AdaptedCLIP on an RN config raises ValueError in both packages, and
    so does an int8 tier on an RN backbone."""
    path, jcfg, tcfg = tiny_rn
    from aa_clip_iqm_tpu.models import adapters as jadapters
    from aa_clip_iqm_tpu.ops import quant as jquant

    with pytest.raises(ValueError, match="ViT"):
        jadapters.init_adapter_params(jax.random.PRNGKey(0), jcfg)
    with pytest.raises(ValueError, match="ViT"):
        tloader.init_trainable(tcfg, device="cpu")
    jf = jloader.load_frozen_backbone(jcfg, path, cache_npz=False)
    tf = tloader.load_frozen_backbone(tcfg, path, device="cpu", dtype=torch.float32,
                                      cache_npz=False)
    with pytest.raises(ValueError, match="ViT tower only"):
        jquant.quantize_backbone_tier(jf, "int8")
    with pytest.raises(ValueError, match="ViT tower only"):
        tquant.quantize_backbone_tier(tf, "int8")
