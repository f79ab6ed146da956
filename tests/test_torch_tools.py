"""The port's repo-root tools (``aa_clip_iqm_tpu_torch/tools``) against the
JAX package's (``tools/``), on the CPU: ``parity_run`` through the JAX
test's four dry-run cases and its ``run_dataset`` rows against JAX's on the
same weights, the outlier study's helpers against JAX's and its tiny run
with every row landed, and the three probes' arguments and chain plumbing
with every kernel wrapper on its plain version. Weights for the two-package
comparisons come from the JAX initializers through ``params_from_jax``."""
import importlib.util
import json
import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aa_clip_iqm_tpu.configs import tiny_test_config as jtiny
from aa_clip_iqm_tpu.models import adapters as jadapters
from aa_clip_iqm_tpu.models import clip as jclip
from aa_clip_iqm_tpu_torch import configs as tconfigs
from aa_clip_iqm_tpu_torch.models.convert import params_from_jax
from aa_clip_iqm_tpu_torch.ops import _build
from aa_clip_iqm_tpu_torch.tools import (
    int8_outlier_study,
    parity_run,
    probe_attn_fused,
    probe_mlp_int8,
    probe_mlp_int8_sweep,
)
from aa_clip_iqm_tpu_torch.utils import profiling

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    torch.set_num_threads(1)


def _jax_tool(name):
    spec = importlib.util.spec_from_file_location(f"jax_tool_{name}",
                                                  os.path.join(ROOT, "tools", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    """A synthetic one-class dataset registered in both packages."""
    from aa_clip_iqm_tpu.data.synthetic import register_synthetic as jregister
    from aa_clip_iqm_tpu_torch.data.synthetic import generate, register_synthetic

    root = str(tmp_path_factory.mktemp("synth"))
    generate(root, n_normal=4, n_anomalous=4, size=56, seed=7, class_names=("widget",))
    jregister(root)
    return register_synthetic(root)


def _base(metadata_root):
    return ["--model_name", "tiny-test", "--img_size", "56", "--random_backbone",
            "--datasets", "Synth", "--metadata_root", metadata_root,
            "--image_batch_size", "4", "--compute_dtype", "float32", "--device", "cpu"]


def test_parity_run_dry_run(synth, tmp_path):
    """The JAX test's four cases (tests/test_tools.py:84-144): the tables
    land; with no table it exits 0 and passes nothing; a table at the
    measured numbers passes, one shifted past the budget exits 1; the int8
    tier runs and names itself."""
    base = _base(synth)
    out1 = str(tmp_path / "rep1")
    assert parity_run.main(base + ["--out", out1, "--anchor_table", ""]) == 0
    with open(os.path.join(out1, "report.json")) as f:
        summary = json.load(f)
    avg = summary["datasets"]["Synth"]["average"]
    assert set(avg) == {"pixel AUC", "pixel AP", "image AUC", "image AP"}
    assert summary["datasets"]["Synth"]["pass"] is None
    for name in ("Synth.txt", "Synth.json", "report.md"):
        assert os.path.isfile(os.path.join(out1, name))

    table = str(tmp_path / "anchor.json")
    with open(table, "w") as f:
        json.dump({"Synth": avg}, f)
    out2 = str(tmp_path / "rep2")
    assert parity_run.main(base + ["--out", out2, "--anchor_table", table]) == 0
    with open(os.path.join(out2, "report.json")) as f:
        assert json.load(f)["datasets"]["Synth"]["pass"] is True

    shifted = dict(avg, **{"pixel AUC": avg["pixel AUC"] + 5.0})
    with open(table, "w") as f:
        json.dump({"Synth": shifted}, f)
    out3 = str(tmp_path / "rep3")
    assert parity_run.main(base + ["--out", out3, "--anchor_table", table]) == 1
    with open(os.path.join(out3, "report.json")) as f:
        rep = json.load(f)
    assert rep["failed"] == ["Synth"]
    assert abs(rep["datasets"]["Synth"]["delta"]["pixel AUC"] + 5.0) < 1e-6

    out4 = str(tmp_path / "rep4")
    assert parity_run.main(base + ["--out", out4, "--quantize_backbone", "int8"]) == 0
    with open(os.path.join(out4, "report.json")) as f:
        repq = json.load(f)
    assert "quantized backbone (int8)" in repq["weights"]
    assert np.isfinite(repq["datasets"]["Synth"]["average"]["pixel AUC"])


def test_parity_run_flags_match_jax():
    """Every flag of the JAX tool, with its default, and the port's --device."""
    jp = _jax_tool("parity_run").build_parser()
    tp = parity_run.build_parser()
    jflags = {a.dest: a.default for a in jp._actions if a.dest != "help"}
    tflags = {a.dest: a.default for a in tp._actions if a.dest != "help"}
    assert set(tflags) == set(jflags) | {"device"}
    for k, v in jflags.items():
        if k == "anchor_table":
            assert os.path.realpath(tflags[k]) == os.path.realpath(v)
        else:
            assert tflags[k] == v, k
    with pytest.raises(SystemExit):
        parity_run.main(["--save_path", "a", "--reference_ckpt", "b", "--device", "cpu"])


def test_parity_run_rows_match_jax(synth, tmp_path):
    """``run_dataset`` (anchors, the sweep, the table) against JAX's on the
    same tiny weights, float32: each class's metrics within 1e-3."""
    jtool = _jax_tool("parity_run")
    cfg = jtiny(56)
    frozen = jclip.init_clip_params(jax.random.PRNGKey(0), cfg.clip)
    trainable = jadapters.init_adapter_params(jax.random.PRNGKey(1), cfg)
    tf, tt = params_from_jax(jax.tree.map(np.asarray, frozen),
                             jax.tree.map(np.asarray, trainable), tconfigs.tiny_test_config(56),
                             device="cpu", dtype=torch.float32)
    args = parity_run.build_parser().parse_args(_base(synth) + ["--out", str(tmp_path)])
    logger = logging.getLogger("parity-test")
    rows, table = parity_run.run_dataset(args, "Synth", tf, tt, tconfigs.tiny_test_config(56),
                                         False, torch.float32, logger)
    jargs = jtool.build_parser().parse_args([a for a in _base(synth) if a not in
                                             ("--device", "cpu")] + ["--out", str(tmp_path)])
    jrows, jtable = jtool.run_dataset(jargs, "Synth", frozen, trainable, cfg, False,
                                      jnp.float32, logger)
    assert [r["class name"] for r in rows] == [r["class name"] for r in jrows]
    for r, j in zip(rows, jrows):
        for m in parity_run.METRICS:
            assert abs(r[m] - j[m]) < 1e-3, (r["class name"], m, r[m], j[m])
    assert table.splitlines()[0] == jtable.splitlines()[0]


def test_outlier_helpers_match_jax():
    jtool = _jax_tool("int8_outlier_study")
    cfg = jtiny(56)
    frozen = jclip.init_clip_params(jax.random.PRNGKey(2), cfg.clip)
    tf, _ = params_from_jax(jax.tree.map(np.asarray, frozen), None,
                            tconfigs.tiny_test_config(56), device="cpu", dtype=torch.float32)
    channels = np.array([3, 41])
    assert int8_outlier_study.inject_ln_gain_outliers(tf, channels, 1.0) is tf
    got = int8_outlier_study.inject_ln_gain_outliers(tf, channels, 20.0)
    want = jtool.inject_ln_gain_outliers(frozen, channels, 20.0)
    for i, block in enumerate(got["visual"]["blocks"]):
        for ln in ("ln_1", "ln_2"):
            np.testing.assert_array_equal(block[ln]["scale"].numpy(),
                                          np.asarray(want["visual"]["blocks"][ln]["scale"])[i])
            np.testing.assert_array_equal(block[ln]["bias"].numpy(),
                                          np.asarray(want["visual"]["blocks"][ln]["bias"])[i])
    assert torch.equal(tf["visual"]["blocks"][0]["ln_1"]["scale"],
                       torch.ones_like(tf["visual"]["blocks"][0]["ln_1"]["scale"]))
    rng = np.random.default_rng(4)
    maps = rng.random((3, 16, 16)).astype(np.float32)
    masks = rng.random((3, 16, 16)) > 0.8
    assert int8_outlier_study.pixel_auroc(maps, masks) == jtool.pixel_auroc(maps, masks)
    assert np.isnan(int8_outlier_study.pixel_auroc(maps, np.zeros_like(masks)))
    imgs, m = int8_outlier_study.make_images(4, 56, 7)
    jimgs, jm = jtool.make_images(4, 56, 7)
    np.testing.assert_array_equal(m, jm)
    np.testing.assert_allclose(imgs, jimgs, rtol=0, atol=1e-6)


def test_outlier_study_tiny_lands_every_row():
    lines = []
    rows = int8_outlier_study.run_study(size="tiny", device="cpu", out=lines.append)
    tiers = int8_outlier_study.TIERS.split(",")
    assert [(r["factor"], r["tier"]) for r in rows] == [
        (f, t) for f in (1.0, 20.0, 100.0) for t in tiers]
    assert not [r for r in rows if "error" in r]
    for r in rows:
        assert -1 <= r["rho"] <= 1 and np.isfinite(r["dauroc_pts"])
        assert r["rho"] > 0.9
    assert sum(line.startswith("# factor=") for line in lines) == 3


def test_outlier_study_flags_match_jax():
    jtool = _jax_tool("int8_outlier_study")
    src = open(jtool.__file__).read()
    parser = int8_outlier_study.build_parser()
    flags = {a.dest: a.default for a in parser._actions if a.dest != "help"}
    for flag in flags:
        if flag != "device":
            assert f'"--{flag}"' in src, flag
    assert flags["factors"] == "1,20,100" and flags["images"] == 8


def test_probe_shapes_match_jax():
    """The probes' shapes are the JAX tools' own."""
    sweep, mlp, attn = (_jax_tool(n) for n in ("probe_mlp_int8_sweep", "probe_mlp_int8",
                                                "probe_attn_fused"))
    assert ((probe_mlp_int8_sweep.ROWS, probe_mlp_int8_sweep.D, probe_mlp_int8_sweep.H,
             probe_mlp_int8_sweep.LAYERS) == (sweep.ROWS, sweep.D, sweep.H, sweep.LAYERS))
    assert ((probe_mlp_int8.ROWS, probe_mlp_int8.D, probe_mlp_int8.H, probe_mlp_int8.LAYERS)
            == (mlp.ROWS, mlp.D, mlp.H, mlp.LAYERS))
    assert ((probe_attn_fused.HEADS, probe_attn_fused.D, probe_attn_fused.VALID,
             probe_attn_fused.LAYERS) == (attn.HEADS, attn.D, attn.VALID, attn.LAYERS))
    # The sweep's (ep_bf16, ch) pairs, without the TPU's row tile.
    assert set(probe_mlp_int8_sweep.VARIANTS) == {(False, 1024), (True, 1024), (False, 2048)}
    args = probe_mlp_int8_sweep.build_parser().parse_args([])
    assert (args.rows, args.layers) == (sweep.ROWS, sweep.LAYERS)


def test_probe_sweep_plumbing_on_the_cpu():
    """B9's chain at 64 rows and 2 layers: every variant lands, each with its
    own numbers; the base's error against itself is 0."""
    before = profiling.counters()
    lines = []
    res = probe_mlp_int8_sweep.run(rows=64, layers=2, device="cpu", iters=1, warmup=0,
                                   out=lines.append)
    assert _build.launches(before) == {}
    assert set(res) == set(probe_mlp_int8_sweep.VARIANTS)
    for key, r in res.items():
        assert r["where"] == "cpu host clock" and r["ms"] > 0
        assert 0 < r["vs_fp"] < 0.1
    assert res[(False, 1024)]["vs_base"] == 0
    assert all(res[k]["vs_base"] > 0 for k in probe_mlp_int8_sweep.VARIANTS[1:])
    assert len(lines) == 3 + 1 + 2


def test_probe_mlp_int8_plumbing_on_the_cpu():
    lines = []
    res = probe_mlp_int8.run(rows=256, layers=2, device="cpu", iters=1, warmup=0,
                             out=lines.append)
    assert 0 < res["rel_err"] < 0.05
    assert set(res["chains"]) == {"fused bf16", "fused int8", "unfused int8"}
    assert lines[0].startswith("int8 kernel 1-layer rel err vs fp kernel")


def test_probe_attn_fused_plumbing_on_the_cpu():
    lines = []
    res = probe_attn_fused.run(batches=(1,), tokens=260, valid=250, layers=2, device="cpu",
                               iters=1, warmup=0, out=lines.append)
    assert set(res) == {(1, False), (1, True)}
    for r in res.values():
        assert r["rel_err"] < 1e-2 and r["base_ms"] > 0 and r["fused_ms"] > 0
    assert len(lines) == 2


def test_tools_refuse_no_card_where_asked_for_one():
    """Without a card an entry point asked for cuda fails; it never falls
    back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises((RuntimeError, AssertionError)):
        probe_mlp_int8_sweep.run(rows=64, layers=1, device="cuda", iters=1)

