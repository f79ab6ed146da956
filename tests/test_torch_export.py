"""The port's export path (serving.export_predictor / ExportedPredictor) on
the CPU, against the JAX package's: the cases of tests/test_serving.py's
export tests one for one (bad batch sizes; the round trip in both weight
modes; micro-batching over an artifact; bf16 weights; the quantized tier;
the int8 round trip), each port artifact held to the port's detector and to
JAX's ExportedPredictor on the same weights (models/convert.params_from_jax)
at JAX's rtol 1e-4 / atol 1e-5. Then what only the port has: a load in a
fresh process, the aaclip:: nodes of each program, the device check, and
the device constants that a trace must not leave behind.

Both packages compute in float32 on tiny_test_config(56), with MVTec's
class vocabulary. Every subprocess and future has its own timeout."""
import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aa_clip_iqm_tpu import configs as jconfigs
from aa_clip_iqm_tpu import serving as jserving
from aa_clip_iqm_tpu.models import adapters as jadapters
from aa_clip_iqm_tpu.models.clip import init_clip_params
from aa_clip_iqm_tpu_torch import configs as tconfigs
from aa_clip_iqm_tpu_torch.loader import init_trainable, random_backbone
from aa_clip_iqm_tpu_torch.models import clip as tclip
from aa_clip_iqm_tpu_torch.models.convert import params_from_jax, tree_map
from aa_clip_iqm_tpu_torch.ops import interp
from aa_clip_iqm_tpu_torch.serving import (
    AnomalyDetector,
    ExportedPredictor,
    MicroBatchingService,
    _flatten_tree,
    export_predictor,
)
from aa_clip_iqm_tpu_torch.tools.aot_smoke import aaclip_nodes

IMG = 56
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 300          # seconds, for every subprocess and future
RTOL, ATOL = 1e-4, 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def weights():
    """Seeded JAX weights (numpy) and the same in the port's layout."""
    cfg = jconfigs.tiny_test_config(IMG)
    jf = jax.tree.map(np.asarray, init_clip_params(jax.random.PRNGKey(0), cfg.clip))
    jt = jax.tree.map(np.asarray, jadapters.init_adapter_params(jax.random.PRNGKey(1), cfg))
    tf, tt = params_from_jax(jf, jt, tconfigs.tiny_test_config(IMG), device="cpu",
                             dtype=torch.float32)
    return jf, jt, tf, tt


def _dets(weights, quantize=None, trainable_dtype=None):
    """(port detector, JAX detector) on the same weights."""
    jf, jt, tf, tt = weights
    if trainable_dtype is not None:
        jt = jax.tree.map(lambda x: jnp.asarray(x, jnp.bfloat16), jt)
        tt = tree_map(lambda t: t.to(torch.bfloat16), tt)
    tdet = AnomalyDetector(tf, tt, tconfigs.tiny_test_config(IMG), "MVTec", img_size=IMG,
                           adapted_text=True, compute_dtype=torch.float32, device="cpu",
                           quantize=quantize)
    jdet = jserving.AnomalyDetector(jf, jt, jconfigs.tiny_test_config(IMG), "MVTec",
                                    img_size=IMG, adapted_text=True,
                                    compute_dtype=np.float32, use_pallas=False,
                                    quantize=quantize)
    return tdet, jdet


def _images(seed, n):
    return np.random.default_rng(seed).standard_normal((n, 3, IMG, IMG)).astype(np.float32)


def _close(out, ref):
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), rtol=RTOL, atol=ATOL)


def _close_int8(out, ref):
    """The int8 tier across packages: its quantizers are discontinuous, so a
    last-bit difference upstream (the two LayerNorms sum in other orders)
    flips a rounding now and then by a whole step of 1/127 of a row's
    largest value. As tests/test_torch_quant.py holds the quantized towers,
    the maps are held to 2e-2 of their range, not to float32 rounding (these
    inputs read about 5e-3); within one package they stay at RTOL/ATOL."""
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(out), ref, rtol=0,
                               atol=2e-2 * float(np.abs(ref).max()))


def _export_both(tdet, jdet, tmp_path, batch_sizes, weights="external"):
    tout, jout = str(tmp_path / "port"), str(tmp_path / "jax")
    export_predictor(tdet, tout, batch_sizes=batch_sizes, weights=weights)
    jserving.export_predictor(jdet, jout, batch_sizes=batch_sizes, weights=weights)
    return ExportedPredictor(tout), jserving.ExportedPredictor(jout), tout


def test_export_predictor_rejects_bad_batch_sizes(weights, tmp_path):
    tdet, _ = _dets(weights)
    for bad in ((), (0,), (4, -1)):
        with pytest.raises(ValueError, match="batch_sizes"):
            export_predictor(tdet, str(tmp_path / "exp"), batch_sizes=bad)
    with pytest.raises(ValueError, match="weights"):
        export_predictor(tdet, str(tmp_path / "exp"), weights="inline")


@pytest.mark.parametrize("mode", ["external", "baked"])
def test_exported_predictor_roundtrip(weights, tmp_path, mode):
    """The artifact reloads without model code and reproduces the port's
    detector and JAX's artifact, bucket padding and oversize splits
    included, in both weight modes; the manifest keeps JAX's keys."""
    tdet, jdet = _dets(weights)
    pred, jpred, out = _export_both(tdet, jdet, tmp_path, (1, 2), mode)
    assert pred.class_names() == jpred.class_names() == tdet.class_names()
    assert pred.img_size == IMG
    with open(os.path.join(out, "manifest.json")) as f:
        manifest = json.load(f)
    jkeys = set(jpred.manifest) - {"platforms"}
    assert jkeys <= set(manifest)
    assert {"device", "device_name", "fused_attn"} <= set(manifest)
    assert manifest["device"] == "cpu" and manifest["weights"] == mode
    assert manifest["batch_sizes"] == [1, 2] and manifest["bf16_keys"] == []
    assert sorted(os.listdir(out)) == sorted(
        ["anchors.npz", "manifest.json", "predict_b1.pt2", "predict_b2.pt2"]
        + (["weights.npz"] if mode == "external" else []))
    images = _images(3, 3)
    ref_maps, ref_scores = tdet.predict(images, "bottle")
    for n in (1, 2, 3):        # 3 > the largest bucket: split
        maps, scores = pred.predict(images[:n], "bottle")
        assert maps.shape == (n, IMG, IMG)
        _close(maps, ref_maps[:n])
        _close(scores, ref_scores[:n])
        jmaps, jscores = jpred.predict(images[:n], "bottle")
        _close(maps, jmaps)
        _close(scores, jscores)
    names = ["bottle", "screw", "carpet"]
    _close(pred.predict_multi(images, names)[0], jpred.predict_multi(images, names)[0])
    with pytest.raises(KeyError, match="unknown class"):
        pred.predict(images[:1], "nope")
    with pytest.raises(KeyError, match="unknown class"):
        pred.predict_multi(images[:1], ["nope"])


def test_micro_batching_over_exported(weights, tmp_path):
    """MicroBatchingService serves an artifact as it serves a detector; the
    programs refuse other image sizes."""
    tdet, jdet = _dets(weights)
    pred, jpred, _ = _export_both(tdet, jdet, tmp_path, (1, 2))
    images = _images(4, 2)
    ref_maps, ref_scores = tdet.predict(images, "bottle")
    jmaps, _ = jpred.predict(images, "bottle")
    svc = MicroBatchingService(pred, max_batch=2, max_latency_ms=50.0)
    try:
        futs = [svc.submit(images[i], "bottle") for i in range(2)]
        for i, fut in enumerate(futs):
            amap, score = fut.result(timeout=TIMEOUT)
            _close(amap, ref_maps[i])
            _close(score, ref_scores[i])
            _close(amap, jmaps[i])
    finally:
        svc.close()
    with pytest.raises(ValueError, match="shape-specialized"):
        pred.predict(images[:, :, : IMG // 2], "bottle")


def test_exported_predictor_bf16_weights(weights, tmp_path):
    """bf16 leaves survive weights.npz (stored as float32, listed in the
    manifest's bf16_keys, restored to bf16 for the program's signature)."""
    tdet, jdet = _dets(weights, trainable_dtype=torch.bfloat16)
    pred, jpred, out = _export_both(tdet, jdet, tmp_path, (2,))
    with open(os.path.join(out, "manifest.json")) as f:
        manifest = json.load(f)
    assert manifest["bf16_keys"] and all(k.startswith("trainable/")
                                         for k in manifest["bf16_keys"])
    assert set(manifest["bf16_keys"]) == {
        k for k, v in _flatten_tree({"trainable": tdet.trainable}).items()
        if v.dtype == torch.bfloat16}
    images = _images(5, 2)
    ref_maps, ref_scores = tdet.predict(images, "bottle")
    maps, scores = pred.predict(images, "bottle")
    _close(maps, ref_maps)
    _close(scores, ref_scores)
    _close(maps, jpred.predict(images, "bottle")[0])


def test_export_predictor_quantized(weights, tmp_path):
    """The int8 tier exports (tools/export_model.py --quantize_backbone):
    the int8 w_q leaves and float32 scales ride weights.npz, and the artifact
    reproduces the quantized detector."""
    tdet, jdet = _dets(weights, quantize="int8")
    pred, jpred, _ = _export_both(tdet, jdet, tmp_path, (2,))
    images = _images(6, 2)
    ref_maps, ref_scores = tdet.predict(images, "bottle")
    maps, scores = pred.predict(images, "bottle")
    _close(maps, ref_maps)
    _close(scores, ref_scores)
    jmaps, jscores = jpred.predict(images, "bottle")
    _close_int8(maps, jmaps)
    _close_int8(scores, jscores)


def test_export_roundtrip_int8_detector(weights, tmp_path):
    """The int8 detector exports and reloads like the float one, in both
    weight modes."""
    tdet, jdet = _dets(weights, quantize="int8")
    images = _images(7, 3)
    ref_maps, ref_scores = tdet.predict(images, "screw")
    for mode in ("external", "baked"):
        out = str(tmp_path / mode)
        export_predictor(tdet, out, batch_sizes=(2,), weights=mode)
        maps, scores = ExportedPredictor(out).predict(images, "screw")
        _close(maps, ref_maps)
        _close(scores, ref_scores)
    jserving.export_predictor(jdet, str(tmp_path / "jax"), batch_sizes=(2,))
    _close_int8(maps,
                jserving.ExportedPredictor(str(tmp_path / "jax")).predict(images, "screw")[0])


# --------------------------------------------------------------------------
# What only the port has
# --------------------------------------------------------------------------

def test_artifact_loads_in_a_fresh_process(weights, tmp_path):
    """A new interpreter with no model code imported loads the artifact
    through ExportedPredictor (its import registers the aaclip:: ops) and
    gives the detector's maps."""
    tdet, _ = _dets(weights)
    out = str(tmp_path / "exp")
    export_predictor(tdet, out, batch_sizes=(2,))
    images = _images(8, 2)
    np.save(str(tmp_path / "images.npy"), images)
    code = (
        "import sys, numpy as np\n"
        f"sys.path.insert(0, {ROOT!r})\n"
        "from aa_clip_iqm_tpu_torch.serving import ExportedPredictor\n"
        f"pred = ExportedPredictor({out!r}, device='cpu')\n"
        f"maps, scores = pred.predict(np.load({str(tmp_path / 'images.npy')!r}), 'screw')\n"
        f"np.savez({str(tmp_path / 'out.npz')!r}, maps=maps, scores=scores)\n"
        "print(sorted(m for m in sys.modules if m.startswith('jax')))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, env=env, timeout=TIMEOUT)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip().splitlines()[-1] == "[]"
    got = np.load(str(tmp_path / "out.npz"))
    ref_maps, ref_scores = tdet.predict(images, "screw")
    _close(got["maps"], ref_maps)
    _close(got["scores"], ref_scores)


def _wide_config(img=224):
    """tiny_test_config with a vision tower of 8 heads of 16 (width 128) at
    224 px: 257 tokens, so attention takes the packed route (B1) and the
    fused half-block's gate (B8) and the int8 MLP's (B3) hold."""
    cfg = tconfigs.tiny_test_config(img)
    vision = dataclasses.replace(cfg.clip.vision, width=128, head_width=16, layers=2)
    return dataclasses.replace(cfg, clip=dataclasses.replace(cfg.clip, vision=vision))


@pytest.mark.parametrize("quantize,fused,want", [
    (None, False, {"flash_mha_packed": 2, "ln_mlp_residual": 2}),
    ("int8", False, {"flash_mha_packed": 2, "ln_mlp_residual_int8": 2}),
    (None, True, {"ln_attn_residual": 2, "ln_mlp_residual": 2}),
])
def test_programs_hold_the_aaclip_ops(tmp_path, monkeypatch, quantize, fused, want):
    """Each exported graph calls the kernels as aaclip:: ops, one per block
    of the vision tower, and reproduces the detector (bf16 compute)."""
    cfg = _wide_config()
    det = AnomalyDetector(random_backbone(cfg, device="cpu", dtype=torch.bfloat16),
                          init_trainable(cfg, device="cpu", dtype=torch.bfloat16), cfg,
                          "MVTec", img_size=224, compute_dtype=torch.bfloat16, device="cpu",
                          batch_buckets=(2,), quantize=quantize)
    monkeypatch.setattr(tclip, "FUSED_ATTN", fused)
    out = str(tmp_path / "exp")
    export_predictor(det, out, batch_sizes=(2,))
    program = torch.export.load(os.path.join(out, "predict_b2.pt2"))
    assert dict(aaclip_nodes(program)) == want
    with open(os.path.join(out, "manifest.json")) as f:
        assert json.load(f)["fused_attn"] is fused
    images = np.random.default_rng(9).standard_normal((2, 3, 224, 224)).astype(np.float32)
    np.testing.assert_array_equal(ExportedPredictor(out).predict(images, "bottle")[0],
                                  det.predict(images, "bottle")[0])


def test_artifact_refuses_another_device_type(weights, tmp_path):
    tdet, _ = _dets(weights)
    out = str(tmp_path / "exp")
    export_predictor(tdet, out, batch_sizes=(1,))
    with pytest.raises(ValueError, match="exported for cpu"):
        ExportedPredictor(out, device="cuda")
    manifest = json.load(open(os.path.join(out, "manifest.json")))
    manifest["device"] = "cuda"
    with open(os.path.join(out, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    with pytest.raises(ValueError, match="exported for cuda"):
        ExportedPredictor(out, device="cpu")


def test_eager_predicts_after_an_export_stay_real(weights, tmp_path):
    """The device constants (the blur/upsample operators, the normalization
    mean and std) are cached once; a trace must leave no fake tensor in
    that cache: eager predicts after an export, on the same detector and on
    a fresh one, return real arrays equal to those from before it."""
    interp._device_operator.cache_clear()
    tdet, _ = _dets(weights)
    u8 = np.random.default_rng(10).integers(0, 256, (2, 3, IMG, IMG), dtype=np.uint8)
    f32 = _images(11, 2)
    before = [tdet.predict(u8, "bottle"), tdet.predict(f32, "screw")]
    export_predictor(tdet, str(tmp_path / "exp"), batch_sizes=(1, 2))
    assert all(type(t) is torch.Tensor for t in interp._DEVICE_CONSTANTS.values())
    fresh, _ = _dets(weights)
    for det in (tdet, fresh):
        after = [det.predict(u8, "bottle"), det.predict(f32, "screw")]
        for (m0, s0), (m1, s1) in zip(before, after):
            assert type(m1) is np.ndarray and type(s1) is np.ndarray
            np.testing.assert_array_equal(m1, m0)
            np.testing.assert_array_equal(s1, s0)
    # A trace that is the first to ask for a constant does not keep it.
    interp._device_operator.cache_clear()
    export_predictor(fresh, str(tmp_path / "exp2"), batch_sizes=(1,))
    assert not interp._DEVICE_CONSTANTS
    np.testing.assert_array_equal(fresh.predict(u8, "bottle")[0], before[0][0])
