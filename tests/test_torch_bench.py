"""The port's bench and its library route on the CPU, against the JAX
package: ``_sweep_configs`` for every string, the ``use_pallas=False`` route
(predict, anchors and the dual tower) against JAX's XLA route at fp32
(rtol 2e-4 / atol 2e-5, JAX's fp32 attention tolerance,
tests/test_pallas_attention.py), that route reaching no kernel wrapper and
exporting no ``aaclip::`` node, the bench's flags and its refusal to measure
without a GPU, the latency and eval helpers on a CPU detector, and
``AACLIP_PLATFORM`` / ``AACLIP_MULTIHOST``."""
import dataclasses
import inspect
import json
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aa_clip_iqm_tpu import configs as jconfigs
from aa_clip_iqm_tpu.cli import bench as jbench
from aa_clip_iqm_tpu.evaluation import predict as jpredict
from aa_clip_iqm_tpu.models import adapters as jadapters
from aa_clip_iqm_tpu.models import clip as jclip
from aa_clip_iqm_tpu.train.driver import compute_frozen_anchors as jax_anchors
from aa_clip_iqm_tpu_torch import configs as tconfigs
from aa_clip_iqm_tpu_torch import platform as tplatform
from aa_clip_iqm_tpu_torch.cli import bench as tbench
from aa_clip_iqm_tpu_torch.cli import evaluate as tcli_eval
from aa_clip_iqm_tpu_torch.cli import serve as tcli_serve
from aa_clip_iqm_tpu_torch.cli import single_image as tcli_single
from aa_clip_iqm_tpu_torch.cli import train as tcli_train
from aa_clip_iqm_tpu_torch.evaluation import predict as tpredict
from aa_clip_iqm_tpu_torch.loader import init_trainable, random_backbone
from aa_clip_iqm_tpu_torch.models import clip as tclip
from aa_clip_iqm_tpu_torch.models.convert import params_from_jax
from aa_clip_iqm_tpu_torch.ops import attention as tattention
from aa_clip_iqm_tpu_torch.prompts import compute_frozen_anchors
from aa_clip_iqm_tpu_torch.serving import AnomalyDetector, export_predictor
from aa_clip_iqm_tpu_torch.tools import export_model as ttool_export
from aa_clip_iqm_tpu_torch.tools.aot_smoke import aaclip_nodes

RTOL, ATOL = 2e-4, 2e-5
WIDE_IMG = 224


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    torch.set_num_threads(1)


SWEEPS = [None, "", "grid", "1", "16", "8,24,32", "4,", "x", "16,y", "0", "-8,16", "2.5"]


@pytest.mark.parametrize("default_pallas", [True, False])
@pytest.mark.parametrize("sweep", SWEEPS)
def test_sweep_configs_match_jax(sweep, default_pallas):
    try:
        want = jbench._sweep_configs(sweep, 24, default_pallas)
    except ValueError:
        with pytest.raises(ValueError, match="--sweep"):
            tbench._sweep_configs(sweep, 24, default_pallas)
        return
    assert tbench._sweep_configs(sweep, 24, default_pallas) == want


def _wide(pkg):
    """tiny_test_config with a vision tower of 8 heads of 16 (width 128, two
    blocks) at 224 px: 257 tokens, where the port's default route takes the
    packed attention kernel (B1) and the fused MLP (B2)."""
    cfg = pkg.tiny_test_config(WIDE_IMG)
    vision = dataclasses.replace(cfg.clip.vision, width=128, head_width=16, layers=2)
    return dataclasses.replace(cfg, clip=dataclasses.replace(cfg.clip, vision=vision))


@pytest.fixture(scope="module")
def wide():
    cfg = _wide(jconfigs)
    frozen = jax.tree.map(np.asarray, jclip.init_clip_params(jax.random.PRNGKey(0), cfg.clip))
    trainable = jax.tree.map(np.asarray,
                             jadapters.init_adapter_params(jax.random.PRNGKey(1), cfg))
    tcfg = _wide(tconfigs)
    tf, tt = params_from_jax(frozen, trainable, tcfg, device="cpu", dtype=torch.float32)
    return cfg, frozen, trainable, tcfg, tf, tt


@pytest.fixture
def no_kernels(monkeypatch):
    """Every kernel call site raises: the library route must reach none of
    them."""
    def boom(*args, **kwargs):
        raise AssertionError("the library route reached a kernel wrapper")

    for mod, name in ((tattention, "flash_mha_packed"), (tattention, "flash_mha"),
                      (tclip, "ln_attn_front"), (tclip, "ln_attn_back"),
                      (tclip, "ln_mlp_residual"), (tclip, "ln_mlp_residual_frozen"),
                      (tclip, "ln_mlp_residual_int8")):
        monkeypatch.setattr(mod, name, boom)


def _kernel_wrappers():
    """The module-level names of ``models.clip`` and ``ops.attention`` bound
    to a kernel wrapper of ``ops/``: a function whose module has its plain
    twin ``<name>_reference``, and the two whose plain versions are named
    otherwise (``ln_mlp_residual_frozen``'s forward is
    ``ln_mlp_residual_reference``'s, ``layer_norm_rows``'s is
    ``layers.layer_norm``)."""
    found = set()
    for mod in (tclip, tattention):
        for name, obj in vars(mod).items():
            home = sys.modules.get(getattr(obj, "__module__", None) or "")
            if (callable(obj) and home is not None and home.__name__.startswith(
                    "aa_clip_iqm_tpu_torch.ops.") and hasattr(home, name + "_reference")):
                found.add((mod, name))
    return found | {(tclip, "ln_mlp_residual_frozen"), (tclip, "layer_norm_rows")}


def test_plain_twins_swap_every_kernel_wrapper():
    """``cli.bench --twins`` reaches no kernel: inside ``plain_twins`` every
    kernel wrapper the model and the attention dispatch bind is swapped for
    a plain version with the same signature, and each is restored after."""
    sites = _kernel_wrappers()
    assert {n for _, n in sites} >= {"flash_mha_packed", "flash_mha", "ln_attn_front",
                                     "ln_attn_back", "ln_mlp_residual", "ln_mlp_residual_int8",
                                     "ln_swiglu_residual", "rope_qk", "layer_norm_rows"}
    before = {s: getattr(*s) for s in sites}
    with tbench.plain_twins():
        for (mod, name), kernel in before.items():
            twin = getattr(mod, name)
            assert twin is not kernel, name
            # The twin takes the wrapper's calls: every parameter by position,
            # and those with a default, which call sites pass so, by name.
            params = list(inspect.signature(kernel).parameters.values())
            sig = inspect.signature(twin)
            sig.bind(*range(len(params)))
            sig.bind(*range(sum(p.default is p.empty for p in params)),
                     **{p.name: 0 for p in params if p.default is not p.empty})
    assert {s: getattr(*s) for s in sites} == before


def test_library_route_predict_matches_jax(wide, no_kernels):
    cfg, frozen, trainable, tcfg, tf, tt = wide
    assert tattention.packed_ok(torch.zeros(1, 257, 128), 8, None)   # B1's gate holds
    rng = np.random.default_rng(3)
    images = rng.integers(0, 256, (2, 3, WIDE_IMG, WIDE_IMG), dtype=np.uint8)
    anchors = rng.standard_normal((2, cfg.clip.embed_dim, 2)).astype(np.float32)
    jfn = jpredict.make_predict_fn(cfg, WIDE_IMG, "Industrial", use_pallas=False)
    jmap, jlogit = jfn(frozen, trainable, jnp.asarray(images), jnp.asarray(anchors))
    tfn = tpredict.make_predict_fn(tcfg, WIDE_IMG, "Industrial", use_pallas=False)
    tmap, tlogit = tfn(tf, tt, torch.from_numpy(images), torch.from_numpy(anchors))
    np.testing.assert_allclose(tmap.numpy(), np.asarray(jmap), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tlogit.numpy(), np.asarray(jlogit), rtol=RTOL, atol=ATOL)


def test_library_route_anchors_and_dual_tower_match_jax(wide, no_kernels):
    cfg, frozen, trainable, tcfg, tf, tt = wide
    want = jax_anchors(frozen, trainable, cfg, "MVTec", adapted=True)
    got = compute_frozen_anchors(tf, tt, tcfg, "MVTec", adapted=True, use_pallas=False)
    assert list(got) == list(want)
    for c in want:
        np.testing.assert_allclose(got[c].numpy(), np.asarray(want[c]), rtol=RTOL, atol=ATOL)
    images = np.random.default_rng(4).standard_normal(
        (2, 3, WIDE_IMG, WIDE_IMG)).astype(np.float32)
    v = cfg.clip.vision
    jpool, jtaps = jclip.dual_vision_features(frozen["visual"], v, jnp.asarray(images),
                                              (1, 2), 1, use_pallas=False)
    tpool, ttaps = tclip.dual_vision_features(tf["visual"], tcfg.clip.vision,
                                              torch.from_numpy(images), (1, 2), 1,
                                              use_pallas=False)
    np.testing.assert_allclose(tpool.numpy(), np.asarray(jpool), rtol=RTOL, atol=ATOL)
    for a, b in zip(ttaps, jtaps):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL, atol=ATOL)


def test_export_library_route_holds_no_aaclip_node(wide, tmp_path):
    """A detector on the kernels' route exports them as aaclip:: ops; with
    use_pallas=False (the export's argument, or the detector's) the program
    holds none and equals the library route's predict."""
    _, _, _, tcfg, tf, tt = wide
    det = AnomalyDetector(tf, tt, tcfg, "MVTec", img_size=WIDE_IMG,
                          compute_dtype=torch.float32, device="cpu", batch_buckets=(2,))
    lib = AnomalyDetector(tf, tt, tcfg, "MVTec", img_size=WIDE_IMG,
                          compute_dtype=torch.float32, device="cpu", batch_buckets=(2,),
                          use_pallas=False)
    images = np.random.default_rng(5).standard_normal(
        (2, 3, WIDE_IMG, WIDE_IMG)).astype(np.float32)
    for what, source, use_pallas in (("kernels", det, None), ("library", det, False),
                                     ("library detector", lib, None)):
        out = str(tmp_path / what.replace(" ", "_"))
        export_predictor(source, out, batch_sizes=(2,), use_pallas=use_pallas)
        program = torch.export.load(os.path.join(out, "predict_b2.pt2"))
        nodes = dict(aaclip_nodes(program))
        with open(os.path.join(out, "manifest.json")) as f:
            assert json.load(f)["use_pallas"] is (what == "kernels")
        if what == "kernels":
            assert nodes == {"flash_mha_packed": 2, "ln_mlp_residual": 2}
            continue
        assert nodes == {}, what
        anchors = lib.anchors["bottle"][None].expand(2, -1, -1)
        want = lib.predict_fn(False)(tf, tt, torch.from_numpy(images), anchors)
        with torch.no_grad():
            got = program.module()(tf, tt, torch.from_numpy(images), anchors.contiguous())
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(lib.predict(images, "bottle")[0],
                                  lib.predict_fn(False)(tf, tt, torch.from_numpy(images),
                                                        anchors)[0].numpy())


MODE_ARGVS = {
    "inference": [], "latency": ["--mode", "latency"], "eval": ["--mode", "eval"],
    "train_accum": ["--mode", "train", "--accum", "2"], "stage1": ["--mode", "stage1"],
    "grid": ["--sweep", "grid", "--profile_dir", "prof"], "library": ["--pallas", "0"],
}


@pytest.mark.parametrize("argv", MODE_ARGVS.values(), ids=MODE_ARGVS.keys())
def test_bench_modes_need_a_gpu(argv):
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: the bench would measure")
    with pytest.raises(SystemExit, match="needs a GPU"):
        tbench.main(argv)


BAD_ARGVS = {
    "sweep_outside_inference": ["--mode", "train", "--sweep", "grid"],
    "accum_outside_train": ["--accum", "2"],
    "accum_zero": ["--mode", "train", "--accum", "0"],
    "library_training": ["--mode", "stage1", "--pallas", "0"],
    "pallas_two": ["--pallas", "2"],
    "unknown_mode": ["--mode", "serve"],
}


@pytest.mark.parametrize("argv", BAD_ARGVS.values(), ids=BAD_ARGVS.keys())
def test_bench_refuses_bad_flags_before_the_gpu_check(argv, capsys):
    with pytest.raises(SystemExit) as exc:
        tbench.main(argv)
    assert exc.value.code == 2
    assert "error" in capsys.readouterr().err


def test_bench_sweep_typo_raises_before_the_gpu_check():
    with pytest.raises(ValueError, match="comma list"):
        tbench.main(["--sweep", "16;32"])
    with pytest.raises(ValueError, match="must divide by --accum 3"):
        tbench._measure_train("train", None, None, 8, 56, None, 1, 1, accum=3)


@pytest.fixture(scope="module")
def tiny_detector():
    cfg = tconfigs.tiny_test_config(56)
    return AnomalyDetector(random_backbone(cfg, device="cpu", dtype=torch.float32),
                           init_trainable(cfg, device="cpu", dtype=torch.float32), cfg,
                           "MVTec", img_size=56, compute_dtype=torch.float32,
                           device="cpu", batch_buckets=(2,))


def test_measure_latency_on_a_cpu_detector(tiny_detector, tmp_path):
    from aa_clip_iqm_tpu_torch.tools import trace_summary

    rng = np.random.default_rng(6)
    images = [rng.standard_normal((2, 3, 56, 56)).astype(np.float32) for _ in range(2)]
    lat = tbench.measure_latency(tiny_detector, images, "bottle", calls=3,
                                 profile_dir=str(tmp_path))
    assert len(lat) == 3 and all(ms > 0 for ms in lat)
    events = trace_summary.load_events(trace_summary.find_trace(str(tmp_path)))
    assert any(e.get("name", "").startswith("aten::") for e in events)


def test_eval_sweeps_on_the_cpu(tiny_detector):
    """The eval mode's sweep through get_dataset's JAX positional form."""
    det = tiny_detector
    samples, rows, n = tbench.eval_sweeps(det.frozen, det.trainable, det.cfg, 56, 16, 1)
    assert n == 48 and len(samples) == 1 and samples[0] > 0
    assert [r["class name"] for r in rows] == list(tbench.EVAL_CLASSES) + ["Average"]
    for key in tpredict.METRIC_KEYS:
        assert 0.0 <= rows[-1][key] <= 100.0


PLATFORMS = {None: "cuda", "gpu": "cuda", "cuda": "cuda", "cpu": "cpu", "CPU": "cpu"}


@pytest.mark.parametrize("value,device", PLATFORMS.items(), ids=map(str, PLATFORMS))
def test_platform_sets_the_clis_default_device(monkeypatch, value, device):
    monkeypatch.delenv("AACLIP_MULTIHOST", raising=False)
    if value is None:
        monkeypatch.delenv("AACLIP_PLATFORM", raising=False)
    else:
        monkeypatch.setenv("AACLIP_PLATFORM", value)
    assert tplatform.default_device() == device
    parsers = (tcli_train.build_parser(), tcli_eval.build_parser(),
               tcli_single.build_parser(), tcli_serve.build_parser(),
               ttool_export.build_parser())
    argvs = ([], [], ["--image_path", "a.png"], [], ["--dataset", "MVTec", "--out", "x"])
    for parser, argv in zip(parsers, argvs):
        assert parser.parse_args(argv).device == device
        assert parser.parse_args(argv + ["--device", "cpu"]).device == "cpu"


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_platform_refuses_other_values_and_multihost(monkeypatch):
    monkeypatch.setenv("AACLIP_PLATFORM", "tpu")
    with pytest.raises(ValueError, match="AACLIP_PLATFORM"):
        tplatform.default_device()
    with pytest.raises(ValueError, match="AACLIP_PLATFORM"):
        tcli_train.build_parser()
    # AACLIP_MULTIHOST=1 is no longer refused: it joins the launcher's
    # process group (gloo under AACLIP_PLATFORM=cpu), in a fresh process.
    code = ("import torch.distributed as dist\n"
            "from aa_clip_iqm_tpu_torch import platform\n"
            "print(platform.default_device(), dist.is_initialized(), dist.get_backend(),\n"
            "      dist.get_world_size())\n"
            "dist.destroy_process_group()\n")
    env = {**os.environ, "AACLIP_PLATFORM": "cpu", "AACLIP_MULTIHOST": "1", "RANK": "0",
           "WORLD_SIZE": "1", "LOCAL_RANK": "0", "MASTER_ADDR": "127.0.0.1",
           "MASTER_PORT": str(_free_port())}
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, env=env, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.split() == ["cpu", "True", "gloo", "1"]
