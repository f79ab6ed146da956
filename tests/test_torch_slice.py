"""The ported zero-shot serving slice as a whole vs the JAX package, on
tiny_test_config(56) on the CPU: towers, adapted encoding, anchors,
make_predict_fn and AnomalyDetector. Parameters come from the JAX
initializers and reach the port through models.convert.params_from_jax."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aa_clip_iqm_tpu.configs import tiny_test_config
from aa_clip_iqm_tpu.evaluation.predict import make_predict_fn as jmake_predict
from aa_clip_iqm_tpu.models import adapters as jadapters
from aa_clip_iqm_tpu.models import clip as jclip
from aa_clip_iqm_tpu.serving import AnomalyDetector as JaxDetector
from aa_clip_iqm_tpu.train.driver import compute_frozen_anchors as jax_anchors
from aa_clip_iqm_tpu_torch import configs as tconfigs
from aa_clip_iqm_tpu_torch.evaluation.predict import make_predict_fn
from aa_clip_iqm_tpu_torch.loader import build_model_config, init_trainable, random_backbone
from aa_clip_iqm_tpu_torch.models import adapters as tadapters
from aa_clip_iqm_tpu_torch.models import clip as tclip
from aa_clip_iqm_tpu_torch.models.convert import (
    init_adapter_params_np,
    init_clip_params_np,
    params_from_jax,
)
from aa_clip_iqm_tpu_torch.ops import _build
from aa_clip_iqm_tpu_torch.prompts import compute_frozen_anchors
from aa_clip_iqm_tpu_torch.serving import AnomalyDetector
from aa_clip_iqm_tpu_torch.utils import profiling

IMG = 56


@pytest.fixture(scope="module")
def model():
    torch.set_num_threads(1)
    cfg = tiny_test_config(IMG)
    frozen = jclip.init_clip_params(jax.random.PRNGKey(0), cfg.clip)
    trainable = jadapters.init_adapter_params(jax.random.PRNGKey(1), cfg)
    tcfg = tconfigs.tiny_test_config(IMG)
    tf, tt = params_from_jax(jax.tree.map(np.asarray, frozen),
                             jax.tree.map(np.asarray, trainable), tcfg,
                             device="cpu", dtype=torch.float32)
    anchors = jax_anchors(frozen, trainable, cfg, "MVTec", adapted=True)
    return cfg, frozen, trainable, tcfg, tf, tt, anchors


def _close_rel(out, ref, rtol):
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(np.asarray(out, np.float32), ref, rtol=rtol,
                               atol=rtol * np.abs(ref).max())


def _images(seed, n):
    return np.random.default_rng(seed).integers(0, 256, (n, 3, IMG, IMG),
                                                dtype=np.uint8)


def _anchor_batch(anchors, names):
    return np.stack([np.asarray(anchors[c]) for c in names])


def test_towers_match_jax(model):
    cfg, frozen, _, tcfg, tf, _, _ = model
    imgs = np.random.default_rng(0).standard_normal((2, 3, IMG, IMG)).astype(np.float32)
    jp, jtaps, jx = jclip.vision_forward(frozen["visual"], cfg.clip.vision,
                                         jnp.asarray(imgs), out_layers=(2, 4),
                                         vv_from=3)
    tp, ttaps, tx = tclip.vision_forward(tf["visual"], tcfg.clip.vision,
                                         torch.from_numpy(imgs), out_layers=(2, 4),
                                         vv_from=3)
    for t, j in zip([tp, tx, *ttaps], [jp, jx, *jtaps]):
        _close_rel(t.numpy(), j, 1e-4)
    tokens = np.array(jax.random.randint(jax.random.PRNGKey(2), (3, 77), 1, 400))
    tokens[:, 9] = 49407
    jt = jclip.text_forward(frozen["text"], cfg.clip.text, jnp.asarray(tokens))
    tt = tclip.text_forward(tf["text"], tcfg.clip.text, torch.from_numpy(tokens).long())
    _close_rel(tt.numpy(), jt, 1e-4)


def test_encode_image_adapted_matches_jax(model):
    cfg, frozen, trainable, tcfg, tf, tt, anchors = model
    imgs = np.random.default_rng(1).standard_normal((2, 3, IMG, IMG)).astype(np.float32)
    anc = _anchor_batch(anchors, ["bottle", "cable"])
    jo = jadapters.encode_image_adapted(frozen, trainable, cfg, jnp.asarray(imgs),
                                        text_anchors=jnp.asarray(anc))
    to = tadapters.encode_image_adapted(tf, tt, tcfg, torch.from_numpy(imgs),
                                        text_anchors=torch.from_numpy(anc))
    for t, j in zip(to.seg_tokens, jo.seg_tokens):
        _close_rel(t.numpy(), j, 1e-4)
    _close_rel(to.det_token.numpy(), jo.det_token, 1e-4)
    _close_rel(to.iqm_queries.numpy(), jo.iqm_queries, 1e-4)
    _close_rel(to.cls_raw.numpy(), jo.cls_raw, 1e-4)


@pytest.mark.parametrize("adapted", [True, False])
def test_anchors_match_jax(model, adapted):
    cfg, frozen, trainable, tcfg, tf, tt, anchors = model
    ref = (anchors if adapted
           else jax_anchors(frozen, trainable, cfg, "MVTec", adapted=False))
    before = profiling.counters()
    out = compute_frozen_anchors(tf, tt, tcfg, "MVTec", adapted=adapted)
    assert _build.launches(before) == {}
    assert list(out) == list(ref)
    for c in ref:
        assert out[c].shape == (tcfg.clip.embed_dim, 2)
        np.testing.assert_allclose(out[c].numpy(), np.asarray(ref[c]),
                                   rtol=1e-4, atol=1e-5)


def test_make_predict_fn_matches_jax(model):
    cfg, frozen, trainable, tcfg, tf, tt, anchors = model
    imgs = _images(2, 2)
    anc = _anchor_batch(anchors, ["bottle", "grid"])
    jmap, jlogit = jmake_predict(cfg, IMG, "Industrial", compute_dtype=jnp.float32)(
        frozen, trainable, jnp.asarray(imgs), jnp.asarray(anc))
    before = profiling.counters()
    tmap, tlogit = make_predict_fn(tcfg, IMG, "Industrial")(
        tf, tt, torch.from_numpy(imgs), torch.from_numpy(anc))
    assert _build.launches(before) == {}
    assert tmap.shape == (2, IMG, IMG) and tlogit.shape == (2,)
    assert tmap.dtype == torch.float32
    _close_rel(tmap.numpy(), jmap, 1e-4)
    _close_rel(tlogit.numpy(), jlogit, 1e-4)


def test_make_predict_fn_bf16_matches_jax(model):
    """bf16 compute on both sides. The frameworks round bf16 at slightly
    different points (cuBLAS-style bf16 products before the fp32 bias add
    here, fp32 products there), so the maps agree to 2% of their range."""
    cfg, frozen, trainable, tcfg, _, _, anchors = model
    tf, tt = params_from_jax(jax.tree.map(np.asarray, frozen),
                             jax.tree.map(np.asarray, trainable), tcfg,
                             device="cpu", dtype=torch.bfloat16)
    imgs = _images(3, 2)
    anc = _anchor_batch(anchors, ["bottle", "grid"])
    jmap, jlogit = jmake_predict(cfg, IMG, "Industrial", compute_dtype=jnp.bfloat16)(
        frozen, trainable, jnp.asarray(imgs), jnp.asarray(anc))
    tmap, tlogit = make_predict_fn(tcfg, IMG, "Industrial",
                                   compute_dtype=torch.bfloat16)(
        tf, tt, torch.from_numpy(imgs), torch.from_numpy(anc))
    assert tmap.dtype == torch.float32
    _close_rel(tmap.numpy(), jmap, 2e-2)
    np.testing.assert_allclose(tlogit.numpy(), np.asarray(jlogit), atol=2e-2)


def test_detector_matches_jax(model):
    cfg, frozen, trainable, tcfg, tf, tt, _ = model
    jdet = JaxDetector(frozen, trainable, cfg, "MVTec", img_size=IMG,
                       compute_dtype=jnp.float32, use_pallas=False)
    tdet = AnomalyDetector(tf, tt, tcfg, "MVTec", img_size=IMG,
                           compute_dtype=torch.float32, device="cpu")
    assert tdet.class_names() == jdet.class_names()
    imgs = _images(4, 3)                      # pads to bucket 8
    tmaps, tscores = tdet.predict(imgs, "screw")
    jmaps, jscores = jdet.predict(imgs, "screw")
    assert tmaps.shape == (3, IMG, IMG) and tscores.shape == (3,)
    _close_rel(tmaps, jmaps, 1e-4)
    _close_rel(tscores, jscores, 1e-4)
    names = ["bottle", "zipper", "tile"]
    tmaps, tscores = tdet.predict_multi(imgs, names)
    jmaps, jscores = jdet.predict_multi(imgs, names)
    _close_rel(tmaps, jmaps, 1e-4)
    _close_rel(tscores, jscores, 1e-4)
    empty_maps, empty_scores = tdet.predict(imgs[:0], "screw")
    assert empty_maps.shape == (0, IMG, IMG) and empty_scores.shape == (0,)
    with pytest.raises(KeyError, match="unknown class"):
        tdet.predict(imgs, "nope")


def test_detector_splits_oversize_batches(model):
    _, _, _, tcfg, tf, tt, _ = model
    det = AnomalyDetector(tf, tt, tcfg, "MVTec", img_size=IMG,
                          compute_dtype=torch.float32, batch_buckets=(1, 2),
                          device="cpu")
    imgs = _images(5, 3)
    maps, scores = det.predict(imgs, "bottle")
    one, _ = det.predict(imgs[2:], "bottle")
    assert maps.shape == (3, IMG, IMG) and scores.shape == (3,)
    np.testing.assert_allclose(maps[2:], one, rtol=1e-5, atol=1e-5)


def test_random_init_has_jax_shapes():
    cfg = tiny_test_config(IMG)
    tcfg = tconfigs.tiny_test_config(IMG)

    def shapes(tree):
        return jax.tree.map(np.shape, tree)

    jf = jax.eval_shape(lambda: jclip.init_clip_params(jax.random.PRNGKey(0), cfg.clip))
    jt = jax.eval_shape(lambda: jadapters.init_adapter_params(jax.random.PRNGKey(1), cfg))
    assert shapes(init_clip_params_np(tcfg, 0)) == shapes(jf)
    assert shapes(init_adapter_params_np(tcfg, 1)) == shapes(jt)
    frozen = random_backbone(tcfg, seed=0, device="cpu", dtype=torch.float32)
    trainable = init_trainable(tcfg, seed=1, device="cpu", dtype=torch.float32)
    maps, scores = make_predict_fn(tcfg, IMG, "Industrial")(
        frozen, trainable, torch.from_numpy(_images(6, 1)),
        torch.ones((1, tcfg.clip.embed_dim, 2)) * 0.1)
    assert torch.isfinite(maps).all() and torch.isfinite(scores).all()


def test_build_model_config_matches_jax():
    from aa_clip_iqm_tpu.loader import build_model_config as jbuild

    j = jbuild("ViT-L-14-336", img_size=518)
    t = build_model_config("ViT-L-14-336", img_size=518)
    assert repr(t) == repr(j)
    assert t.clip.vision.heads == 16 and t.clip.vision.grid == 37
    with pytest.raises(ValueError, match="multiple of the patch size"):
        build_model_config("ViT-L-14-336", img_size=520)
