"""The ported evaluation slice as a whole vs the JAX package, on the CPU:
weights -> quantize -> anchors -> per-class sweep -> AUROC/AP table, on the
tiny config over a synthetic dataset on disk that both packages read."""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aa_clip_iqm_tpu import configs as jconfigs
from aa_clip_iqm_tpu.data import datasets as jdatasets
from aa_clip_iqm_tpu.data import synthetic as jsynthetic
from aa_clip_iqm_tpu.evaluation import predict as jpredict
from aa_clip_iqm_tpu.evaluation import scoring as jscoring
from aa_clip_iqm_tpu.models import adapters as jadapters
from aa_clip_iqm_tpu.models import clip as jclip
from aa_clip_iqm_tpu.models import convert as jconvert
from aa_clip_iqm_tpu.ops import pallas_mlp as pm
from aa_clip_iqm_tpu.ops import quant as jquant
from aa_clip_iqm_tpu.train.driver import compute_frozen_anchors as jax_anchors
from aa_clip_iqm_tpu_torch import configs as tconfigs
from aa_clip_iqm_tpu_torch import loader as tloader
from aa_clip_iqm_tpu_torch.cli import bench as tbench
from aa_clip_iqm_tpu_torch.cli import evaluate as tcli
from aa_clip_iqm_tpu_torch.data import datasets as tdatasets
from aa_clip_iqm_tpu_torch.data import synthetic as tsynthetic
from aa_clip_iqm_tpu_torch.evaluation import predict as tpredict
from aa_clip_iqm_tpu_torch.evaluation import scoring as tscoring
from aa_clip_iqm_tpu_torch.models import clip as tclip
from aa_clip_iqm_tpu_torch.models import convert as tconvert
from aa_clip_iqm_tpu_torch.models.convert import params_from_jax
from aa_clip_iqm_tpu_torch.ops import quant as tquant
from aa_clip_iqm_tpu_torch.prompts import compute_frozen_anchors

IMG = 56
CLASSES = ("widget", "gadget")
BATCH = 8                      # 11 images a class: one batch of 8, a tail of 3


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """A synthetic dataset written by the port's generator at the model's
    image size (so neither package resizes), registered with both."""
    root = str(tmp_path_factory.mktemp("synth"))
    tsynthetic.generate(root, n_normal=5, n_anomalous=6, size=IMG,
                        class_names=CLASSES, seed=3)
    meta_root = tsynthetic.register_synthetic(root, CLASSES)
    assert jsynthetic.register_synthetic(root, CLASSES) == meta_root
    return root, meta_root


def _config(width):
    def widen(cfg):
        return dataclasses.replace(cfg, clip=dataclasses.replace(
            cfg.clip, vision=dataclasses.replace(cfg.clip.vision, width=width)))

    return widen(jconfigs.tiny_test_config(IMG)), widen(tconfigs.tiny_test_config(IMG))


@pytest.fixture(scope="module")
def models():
    out = {}
    for width in (64, 128):
        cfg, tcfg = _config(width)
        frozen = jclip.init_clip_params(jax.random.PRNGKey(0), cfg.clip)
        trainable = jadapters.init_adapter_params(jax.random.PRNGKey(1), cfg)
        out[width] = (cfg, frozen, trainable, tcfg,
                      jax.tree.map(np.asarray, frozen),
                      jax.tree.map(np.asarray, trainable))
    return out


def _sweep(models, data, width, tier, dtype, monkeypatch, fused=False):
    """(JAX rows, port rows, JAX maps, port maps of the first class)."""
    cfg, frozen, trainable, tcfg, frozen_np, trainable_np = models[width]
    _, meta_root = data
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    if fused:
        # The JAX package reaches its fused int8 kernel only on a TPU or in
        # interpret mode.
        monkeypatch.setattr(pm, "INTERPRET", True)
    jfrozen = jquant.quantize_backbone_auto(frozen, tier, cfg=cfg)
    janchors = jax_anchors(jfrozen, trainable, cfg, "Synth", adapted=False,
                           compute_dtype=jdt)
    jsets = jdatasets.get_dataset("Synth", IMG, None, -1, "test",
                                  metadata_root=meta_root, device_normalize=True)
    jcfg = jconfigs.EvalConfig(dataset="Synth", img_size=IMG, batch_size=BATCH)
    jrows = jpredict.evaluate_dataset(jfrozen, trainable, cfg, jcfg, jsets, janchors,
                                      compute_dtype=jdt, use_pallas=fused)

    tf, tt = params_from_jax(frozen_np, trainable_np, tcfg, device="cpu", dtype=tdt)
    tf = tquant.quantize_backbone_auto(tf, tier, cfg=tcfg)
    tanchors = compute_frozen_anchors(tf, tt, tcfg, "Synth", adapted=False,
                                      compute_dtype=tdt)
    tsets = tdatasets.get_dataset("Synth", IMG, "test", metadata_root=meta_root,
                                  device_normalize=True)
    ecfg = tconfigs.EvalConfig(dataset="Synth", img_size=IMG, batch_size=BATCH)
    trows = tpredict.evaluate_dataset(tf, tt, tcfg, ecfg, tsets, tanchors,
                                      compute_dtype=tdt)

    jfn = jpredict.make_predict_fn(cfg, IMG, "Industrial", compute_dtype=jdt,
                                   use_pallas=fused)
    jp = jpredict.predict_class(jfn, jfrozen, trainable, jsets["widget"],
                                janchors["widget"], BATCH)
    tfn = tpredict.make_predict_fn(tcfg, IMG, "Industrial", compute_dtype=tdt)
    tp = tpredict.predict_class(tfn, tf, tt, tsets["widget"], tanchors["widget"], BATCH)
    assert tp["file_names"] == jp["file_names"]
    np.testing.assert_array_equal(tp["labels"], jp["labels"])
    np.testing.assert_array_equal(tp["masks"], jp["masks"])
    return jrows, trows, jp, tp


def _map_diff(tp, jp):
    """RMS of the difference of the maps over how much the maps vary."""
    d = tp["maps"].astype(np.float64) - jp["maps"]
    return float(np.sqrt((d ** 2).mean()) / jp["maps"].std())


# Tolerances per case: maps (RMS difference / std of the JAX maps), pixel
# metrics and image metrics (points of the table). float32 without
# quantization repeats the JAX arithmetic, so the rows agree to the table's
# own rounding (0.01 + float noise). bf16 rounds at other places in the two
# frameworks (measured here: up to 4% of the maps' range, 0.16 of their
# std), and a quantizer is discontinuous (a last-bit difference flips a
# rounding by one step of 1/127; measured 0.011), so those maps agree to a
# part of their variation and the pixel metrics to about a point (measured
# up to 1.1). With 11 images a class, one swapped pair of image scores moves
# an image metric by 1/30 = 3.33 points, which is what their tolerance allows.
CASES = [
    # width, tier, dtype, fused, maps, pixel rows, image rows
    (64, None, "float32", False, 1e-4, 0.02, 0.02),
    (64, "int8", "float32", False, 5e-2, 1.0, 3.4),
    (64, "int8_mlp", "float32", False, 5e-2, 1.0, 3.4),
    (64, None, "bfloat16", False, 0.25, 2.0, 3.4),
    (64, "int8", "bfloat16", False, 0.25, 2.0, 3.4),
    (64, "int8_mlp", "bfloat16", False, 0.25, 2.0, 3.4),
    (128, "int8", "bfloat16", True, 0.25, 2.0, 3.4),     # through the fused int8 MLP
]


@pytest.mark.parametrize("width,tier,dtype,fused,map_tol,pixel_tol,image_tol", CASES)
def test_evaluate_dataset_matches_jax(models, data, monkeypatch, width, tier,
                                      dtype, fused, map_tol, pixel_tol, image_tol):
    hits = []
    real = tclip.ln_mlp_residual_int8
    monkeypatch.setattr(tclip, "ln_mlp_residual_int8",
                        lambda *a, **k: hits.append(1) or real(*a, **k))
    jrows, trows, jp, tp = _sweep(models, data, width, tier, dtype, monkeypatch, fused)
    assert bool(hits) == fused
    assert [r["class name"] for r in trows] == ["widget", "gadget", "Average"]
    assert [r["class name"] for r in jrows] == [r["class name"] for r in trows]
    rel = _map_diff(tp, jp)
    assert rel <= map_tol, rel
    np.testing.assert_allclose(tp["image_scores"], jp["image_scores"],
                               atol=1e-6 if map_tol <= 1e-4 else 5e-3)
    for jr, tr in zip(jrows, trows):
        for k in tpredict.METRIC_KEYS:
            tol = pixel_tol if k.startswith("pixel") else image_tol
            assert 0.0 <= tr[k] <= 100.0
            assert abs(tr[k] - jr[k]) <= tol, (tr["class name"], k, tr[k], jr[k])
    assert tpredict.results_table(trows) == jpredict.results_table(trows)


def test_tail_buckets_and_predict_class_modes(models, data):
    assert tpredict._tail_buckets(32) == jpredict._tail_buckets(32) == (1, 2, 4, 8, 16, 32)
    assert tpredict._tail_buckets(6) == jpredict._tail_buckets(6) == (1, 2, 4, 6)
    assert tpredict._bucket(17) == jpredict._bucket(17) == 32
    _, _, _, tcfg, frozen_np, trainable_np = models[64]
    tf, tt = params_from_jax(frozen_np, trainable_np, tcfg, device="cpu",
                             dtype=torch.float32)
    anchors = compute_frozen_anchors(tf, tt, tcfg, "Synth", adapted=False)
    ds = tdatasets.get_dataset("Synth", IMG, "test", metadata_root=data[1],
                               device_normalize=True)["gadget"]
    seen = []
    inner = tpredict.make_predict_fn(tcfg, IMG, "Industrial")

    def spy(frozen, trainable, images, anchors_b):
        seen.append(tuple(images.shape))
        assert images.dtype == torch.uint8          # collate keeps uint8
        return inner(frozen, trainable, images, anchors_b)

    host = tpredict.predict_class(spy, tf, tt, ds, anchors["gadget"], BATCH)
    assert seen == [(8, 3, IMG, IMG), (4, 3, IMG, IMG)]     # tail of 3 -> bucket 4
    dev = tpredict.predict_class(inner, tf, tt, ds, anchors["gadget"], BATCH,
                                 device_resident=True)
    assert isinstance(dev["maps"], torch.Tensor) and dev["masks"].dtype == torch.bool
    assert host["maps"].shape == (11, IMG, IMG) and host["masks"].shape == (11, 1, IMG, IMG)
    np.testing.assert_array_equal(dev["maps"].numpy(), host["maps"])
    np.testing.assert_array_equal(dev["masks"].numpy(), host["masks"][:, 0] != 0)
    np.testing.assert_array_equal(dev["image_scores"].numpy(), host["image_scores"])
    seen.clear()
    tpredict.predict_class(spy, tf, tt, ds, anchors["gadget"], BATCH, buckets=(BATCH,))
    assert seen == [(8, 3, IMG, IMG)] * 2
    # Host metrics and device metrics of one sweep agree.
    ecfg = tconfigs.EvalConfig(dataset="Synth", img_size=IMG, batch_size=BATCH)
    sets = tdatasets.get_dataset("Synth", IMG, "test", metadata_root=data[1],
                                 device_normalize=True)
    rows_d = tpredict.evaluate_dataset(tf, tt, tcfg, ecfg, sets, anchors)
    rows_h = tpredict.evaluate_dataset(tf, tt, tcfg, ecfg, sets, anchors,
                                       device_resident=False)
    for d, h in zip(rows_d, rows_h):
        for k in tpredict.METRIC_KEYS:
            assert abs(d[k] - h[k]) <= 0.0101


def test_reference_eval_mode(models, data):
    """image_score_mode="reference_eval": the scoring function equals the JAX
    one, and a one-image tail batch raises as there."""
    rng = np.random.default_rng(0)
    det = rng.standard_normal((3, 32)).astype(np.float32)
    anc = rng.standard_normal((3, 32, 2)).astype(np.float32)
    np.testing.assert_allclose(
        tscoring.image_logit_reference_eval(torch.from_numpy(det), torch.from_numpy(anc)).numpy(),
        np.asarray(jscoring.image_logit_reference_eval(jnp.asarray(det), jnp.asarray(anc))),
        rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="batch >= 2"):
        tscoring.image_logit_reference_eval(torch.from_numpy(det[:1]), torch.from_numpy(anc[:1]))
    with pytest.raises(ValueError, match="unknown image_score_mode"):
        tpredict.make_predict_fn(models[64][3], IMG, "Industrial", image_score_mode="x")
    _, _, _, tcfg, frozen_np, trainable_np = models[64]
    tf, tt = params_from_jax(frozen_np, trainable_np, tcfg, device="cpu",
                             dtype=torch.float32)
    anchors = compute_frozen_anchors(tf, tt, tcfg, "Synth", adapted=False)
    ds = tdatasets.get_dataset("Synth", IMG, "test", metadata_root=data[1],
                               device_normalize=True)["widget"]
    fn = tpredict.make_predict_fn(tcfg, IMG, "Industrial", image_score_mode="reference_eval")
    preds = tpredict.predict_class(fn, tf, tt, ds, anchors["widget"], 4,
                                   image_score_mode="reference_eval")
    assert preds["image_scores"].shape == (11,)
    assert len(set(np.round(preds["image_scores"][:4], 6))) == 1    # one score a batch
    with pytest.raises(ValueError, match="needs >= 2 valid samples"):
        tpredict.predict_class(fn, tf, tt, ds, anchors["widget"], 5,
                               image_score_mode="reference_eval")


ROWS = [
    [{"class name": "bottle", "pixel AUC": 91.23, "pixel AP": 50.0, "image AUC": 0.0,
      "image AP": 12.35},
     {"class name": "metal_nut", "pixel AUC": 57.31, "pixel AP": 3.12, "image AUC": 100.0,
      "image AP": 99.99},
     {"class name": "Average", "pixel AUC": 74.27, "pixel AP": 26.560000000000002,
      "image AUC": 50.0, "image AP": 56.17}],
    [{"class name": "a", "pixel AUC": round(0.91234, 4) * 100, "pixel AP": 100.0,
      "image AUC": 33.333333, "image AP": 66.675},
     {"class name": "Average", "pixel AUC": 91.23000000000002, "pixel AP": 100.0,
      "image AUC": 33.333333, "image AP": 66.675}],
    [{"class name": "a_rather_long_class_name", "pixel AUC": float("nan"), "pixel AP": 1e-7,
      "image AUC": 5.0, "image AP": 12345678.5},
     {"class name": "Average", "pixel AUC": 1.5, "pixel AP": 0.25, "image AUC": 5.0,
      "image AP": 0.0}],
    [],
]


@pytest.mark.parametrize("rows", ROWS, ids=["plain", "trimmed", "odd", "empty"])
def test_results_table_string_equal(rows):
    """The table without pandas is, character for character, the JAX
    package's pandas table."""
    assert tpredict.results_table(rows) == jpredict.results_table(rows)


def test_npz_cache_and_load_frozen_backbone(tmp_path, models):
    """The .npz weight cache has the JAX package's key scheme: either
    package reads the other's file, and load_frozen_backbone serves it."""
    cfg, frozen, _, tcfg, frozen_np, _ = models[64]
    jpath, tpath = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    jconvert.save_params_npz(frozen, jpath)
    tconvert.save_params_npz(frozen_np, tpath)
    a, b = tconvert.load_params_npz(jpath), jconvert.load_params_npz(tpath)
    ref = dict(tconvert._flatten(frozen_np))
    assert dict(tconvert._flatten(a)).keys() == ref.keys()
    for k, v in tconvert._flatten(jax.tree.map(np.asarray, b)):
        np.testing.assert_array_equal(v, ref[k])
    direct, _ = params_from_jax(frozen_np, None, tcfg, device="cpu", dtype=torch.float32)
    for path in (jpath, tpath):
        loaded = tloader.load_frozen_backbone(tcfg, path, device="cpu", dtype=torch.float32)
        want = dict(tconvert._flatten(direct))
        got = dict(tconvert._flatten(loaded))
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
    # The port's own layout (blocks as a list) round-trips too.
    tconvert.save_params_npz(direct, tpath)
    again = tloader.load_frozen_backbone(tcfg, tpath, device="cpu", dtype=torch.float32)
    assert len(again["visual"]["blocks"]) == tcfg.clip.vision.layers
    assert torch.equal(again["visual"]["blocks"][1]["mlp"]["c_fc"]["w"],
                       direct["visual"]["blocks"][1]["mlp"]["c_fc"]["w"])
    cwd = os.getcwd()
    os.chdir(tmp_path)           # no checkpoint to be found from here
    try:
        if tconvert.find_backbone() is None:
            with pytest.raises(FileNotFoundError, match="No CLIP backbone"):
                tloader.load_frozen_backbone(tcfg)
            rnd = tloader.load_frozen_backbone(tcfg, allow_random=True, device="cpu",
                                               dtype=torch.float32)
            assert rnd["visual"]["proj"].shape == (64, 32)
    finally:
        os.chdir(cwd)
    # A .pt goes to the OpenAI converter (tests/test_torch_convert.py); a
    # missing one fails to open.
    with pytest.raises(FileNotFoundError):
        tloader.load_frozen_backbone(tcfg, str(tmp_path / "ViT-L-14-336px.pt"), device="cpu")
    # A cache saved at another grid (4 x 4 here, 5 x 5 wanted) has its
    # positional embedding resized bicubically, as the JAX loader does.
    from aa_clip_iqm_tpu import loader as jloader

    resized = tloader.load_frozen_backbone(tconfigs.tiny_test_config(70), jpath, device="cpu",
                                           dtype=torch.float32)
    jresized = jloader.load_frozen_backbone(jconfigs.tiny_test_config(70), jpath)
    np.testing.assert_allclose(resized["visual"]["positional_embedding"].numpy(),
                               np.asarray(jresized["visual"]["positional_embedding"]),
                               rtol=1e-6, atol=1e-6)


def test_datasets_match_jax(data):
    root, meta_root = data
    for normalize in (True, False):
        jsets = jdatasets.get_dataset("Synth", IMG, None, -1, "test",
                                      metadata_root=meta_root, device_normalize=normalize)
        tsets = tdatasets.get_dataset("Synth", IMG, "test", metadata_root=meta_root,
                                      device_normalize=normalize)
        assert list(tsets) == list(jsets) == list(CLASSES)
        for c in CLASSES:
            assert len(tsets[c]) == len(jsets[c]) == 11
            for tb, jb in zip(tsets[c].batches(4), jsets[c].batches(4)):
                assert tb["n_valid"] == jb["n_valid"] and tb["file_name"] == jb["file_name"]
                assert tb["image"].dtype == (np.uint8 if normalize else np.float32)
                for k in ("image", "mask", "label"):
                    np.testing.assert_array_equal(tb[k], jb[k])
    assert len(tdatasets.load_metadata(os.path.join(meta_root, "Synth", "full-shot.jsonl"))) == 22
    with pytest.raises(KeyError, match="not found"):
        tdatasets.get_dataset("Nope", IMG)
    with pytest.raises(ValueError, match="not found"):
        tdatasets.get_dataset("Synth", IMG, stage="visualize")
    text_ds, image_ds = tdatasets.get_dataset("Synth", IMG, stage="train",
                                              metadata_root=meta_root,
                                              training_mode="full_shot")
    assert len(text_ds) == len(image_ds) == 22 and text_ds.text and not image_ds.text
    # Resizing decode (PIL bicubic / nearest) keeps shapes and binary masks.
    item = tdatasets.SingleClassTestDataset(os.path.join(root, "Synth"),
                                            os.path.join(meta_root, "Synth", "full-shot.jsonl"),
                                            28, "widget")[10]
    assert item["image"].shape == (3, 28, 28) and item["mask"].shape == (1, 28, 28)
    assert set(np.unique(item["mask"])) <= {0.0, 1.0} and item["label"] == 1


def test_prefetch_order_errors_and_abandon():
    assert list(tdatasets.prefetch(iter(range(7)), depth=2)) == list(range(7))

    def boom():
        yield 1
        raise RuntimeError("decode failed")

    with pytest.raises(RuntimeError, match="decode failed"):
        list(tdatasets.prefetch(boom()))
    gen = tdatasets.prefetch(iter(range(100)), depth=1)
    assert next(gen) == 0
    gen.close()


@pytest.mark.parametrize("tier", [None, "int8"])
def test_cli_evaluate_end_to_end(data, tmp_path, capsys, tier):
    root, meta_root = data
    args = ["--model_name", "tiny-test", "--img_size", str(IMG), "--dataset", "Synth",
            "--random_backbone", "--no_adapters", "--device", "cpu",
            "--image_batch_size", str(BATCH), "--metadata_root", meta_root,
            "--save_path", str(tmp_path / "out"), "--compute_dtype", "float32"]
    if tier:
        args += ["--quantize_backbone", tier]
    rows = tcli.main(args)
    printed = capsys.readouterr().out
    assert tpredict.results_table(rows) in printed
    assert [r["class name"] for r in rows] == ["widget", "gadget", "Average"]
    for r in rows:
        for k in tpredict.METRIC_KEYS:
            assert np.isfinite(r[k]) and 0.0 <= r[k] <= 100.0
    assert os.path.isfile(tmp_path / "out" / "test.log")
    # Without --no_adapters it restores a trainer's checkpoint; there is none.
    with pytest.raises(FileNotFoundError, match="no stage-2 image-adapter checkpoint"):
        tcli.main([a for a in args if a != "--no_adapters"])
    with pytest.raises(SystemExit):
        tcli.main(args + ["--quantize_backbone", "int8-attn"])


# argv fragments for the model-config flags: each sets some of them away
# from their defaults (a real model name: only configs are built).
CONFIG_ARGVS = {
    "defaults": [],
    "relu": ["--relu"],
    "adapt_weights": ["--text_adapt_weight", "0.3", "--image_adapt_weight", "0.05"],
    "adapt_untils": ["--text_adapt_until", "2", "--image_adapt_until", "4"],
    "iqm_sizes": ["--iqm_hidden_size", "256", "--iqm_num_layers", "3",
                  "--iqm_num_heads", "4"],
    "all_at_336": ["--img_size", "336", "--relu", "--text_adapt_weight", "0.2",
                   "--image_adapt_weight", "0.15", "--text_adapt_until", "1",
                   "--image_adapt_until", "5", "--iqm_hidden_size", "384",
                   "--iqm_num_layers", "1", "--iqm_num_heads", "6", "--batch_size", "4"],
}


@pytest.mark.parametrize("argv", CONFIG_ARGVS.values(), ids=CONFIG_ARGVS.keys())
def test_cli_evaluate_model_config_matches_jax(argv):
    """For the same argv the port's evaluate builds the ModelConfig that the
    JAX CLI's main builds (aa_clip_iqm_tpu/cli/evaluate.py:94-103), and both
    parsers accept --batch_size."""
    from aa_clip_iqm_tpu import loader as jloader
    from aa_clip_iqm_tpu.cli import evaluate as jcli

    argv = ["--model_name", "ViT-L-14-336", "--dataset", "MVTec", "--batch_size", "16", *argv]
    jargs = jcli.build_parser().parse_args(argv)
    targs = tcli.build_parser().parse_args(argv)
    want = jloader.build_model_config(
        model_name=jargs.model_name, img_size=jargs.img_size, relu=jargs.relu,
        text_adapt_weight=jargs.text_adapt_weight,
        image_adapt_weight=jargs.image_adapt_weight,
        text_adapt_until=jargs.text_adapt_until,
        image_adapt_until=jargs.image_adapt_until,
        iqm_hidden_size=jargs.iqm_hidden_size,
        iqm_num_layers=jargs.iqm_num_layers,
        iqm_num_heads=jargs.iqm_num_heads)
    got = tcli.model_config(targs)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert targs.batch_size == jargs.batch_size


def test_bench_helpers_and_gpu_requirement():
    """The port's bench: median and spread as the JAX bench computes them, the
    twins switch restores the kernels' call sites, and without a GPU it
    refuses to measure."""
    from aa_clip_iqm_tpu.cli import bench as jbench
    from aa_clip_iqm_tpu_torch.ops import attention, fused_mlp, packed_attention

    for samples in ([98.0, 100.0, 101.0], [5.0], [0.0, 0.0]):
        assert tbench._median_spread(samples) == jbench._median_spread(samples)
    assert tbench.METRIC.endswith("_per_gpu")
    from aa_clip_iqm_tpu_torch.ops import attn_block

    def sites():
        return (attention.flash_mha_packed, attention.flash_mha, tclip.ln_attn_residual,
                tclip.ln_mlp_residual, tclip.ln_mlp_residual_frozen, tclip.ln_mlp_residual_int8)

    before = sites()
    with tbench.plain_twins():
        assert attention.flash_mha_packed is packed_attention.flash_mha_packed_reference
        assert attention.flash_mha is attention.sdpa
        assert tclip.ln_attn_residual is attn_block.ln_attn_residual_reference
        assert tclip.ln_mlp_residual is fused_mlp.ln_mlp_residual_reference
        assert tclip.ln_mlp_residual_frozen is fused_mlp.ln_mlp_residual_reference
        assert tclip.ln_mlp_residual_int8 is fused_mlp.ln_mlp_residual_int8_reference
    assert before == sites()
    assert set(tbench.TRAIN_METRICS) == {"train", "stage1"}
    assert all(m.endswith("_per_gpu") for m in tbench.TRAIN_METRICS.values())
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="needs a GPU"):
            tbench.main(["--batch", "1"])
        with pytest.raises(SystemExit, match="needs a GPU"):
            tbench.main(["--mode", "train"])
