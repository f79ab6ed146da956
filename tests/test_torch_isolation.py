"""The port and chip_smoke.py import neither JAX nor the JAX package, and
importing them needs neither PIL, cv2, pandas nor sklearn (the machine with
the card is promised none of them). The port's native transform pipeline is
built from its own copy of the C++ source and loads its own library, never
the JAX package's ``native/`` one."""
import ast
import os
import re
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGE = os.path.join(ROOT, "aa_clip_iqm_tpu_torch")


def _sources():
    for dirpath, _, files in os.walk(PACKAGE):
        for name in sorted(files):
            if name.endswith(".py"):
                yield os.path.join(dirpath, name)
    yield os.path.join(ROOT, "chip_smoke.py")


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "aa_clip_iqm_tpu")


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


@pytest.mark.parametrize("path", list(_sources()),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_imports(path):
    bad = [m for m in _imports(path) if _forbidden(m)]
    assert not bad, f"{os.path.relpath(path, ROOT)} imports {bad}"


def test_new_modules_are_covered():
    covered = {os.path.relpath(p, PACKAGE) for p in _sources()}
    for rel in ("ops/quant.py", "ops/metrics.py", "ops/fused_mlp.py",
                "evaluation/predict.py", "data/datasets.py", "data/synthetic.py",
                "cli/evaluate.py", "cli/bench.py", "utils/misc.py",
                "ops/losses.py", "ops/packed_attention.py", "train/optim.py",
                "train/steps.py", "train/checkpoint.py", "train/driver.py",
                "cli/train.py", "cli/serve.py", "cli/single_image.py",
                "evaluation/visualize.py", "serving.py", "models/convert.py",
                "ops/custom_ops.py", "tools/export_model.py", "tools/aot_smoke.py",
                "platform.py", "utils/profiling.py", "tools/trace_summary.py",
                "train/graphs.py", "data/native.py", "models/modified_resnet.py",
                "tools/parity_run.py", "tools/int8_outlier_study.py",
                "tools/convert_backbone.py", "tools/chains.py", "tools/probe_mlp_int8.py",
                "tools/probe_mlp_int8_sweep.py", "tools/probe_attn_fused.py",
                "parallel/__init__.py", "parallel/mesh.py", "parallel/multihost.py",
                "parallel/collectives.py"):
        assert rel in covered, rel


def test_only_the_orbax_bridge_imports_both_packages():
    """Outside tests/, tools/orbax_to_torch.py alone imports the JAX package
    (or JAX) and the port together."""
    both = []
    for dirpath, dirs, files in os.walk(ROOT):
        dirs[:] = [d for d in dirs if d not in ("tests", ".git", "build", "chiprun_out")
                   and not d.startswith(".")]
        for name in files:
            if not name.endswith(".py"):
                continue
            path = os.path.join(dirpath, name)
            mods = list(_imports(path))
            if (any(_forbidden(m) for m in mods)
                    and any(m.split(".")[0] == "aa_clip_iqm_tpu_torch" for m in mods)):
                both.append(os.path.relpath(path, ROOT))
    assert both == [os.path.join("tools", "orbax_to_torch.py")]


def test_forbidden_names():
    assert _forbidden("jax.numpy") and _forbidden("aa_clip_iqm_tpu.ops")
    assert _forbidden("jaxlib")
    assert not _forbidden("aa_clip_iqm_tpu_torch.ops")


def test_import_leaves_jax_unloaded():
    code = (
        "import importlib, pkgutil, sys\n"
        f"sys.path.insert(0, {ROOT!r})\n"
        "import aa_clip_iqm_tpu_torch as pkg\n"
        "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'aa_clip_iqm_tpu', 'PIL', 'cv2', 'pandas', 'sklearn')]\n"
        "assert not bad, bad\n"
        "print('clean')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, env=env, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "clean"


def test_the_native_pipeline_is_the_ports_own():
    """The port's copy of the C++ source includes system headers only, and a
    process that imports the port and loads its pipeline maps the port's
    library and not the JAX package's native/ one, with no module of the JAX
    package imported."""
    src = os.path.join(PACKAGE, "native", "image_pipeline.cpp")
    with open(src) as f:
        includes = re.findall(r"#include\s*(\S+)", f.read())
    assert includes and all(i.startswith("<") for i in includes), includes
    code = (
        "import sys\n"
        f"sys.path.insert(0, {ROOT!r})\n"
        "from aa_clip_iqm_tpu_torch.data import native\n"
        "assert native.available(), native.BUILD_LOG\n"
        "maps = open('/proc/self/maps').read()\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'aa_clip_iqm_tpu')]\n"
        "print(native.LIB_PATH in maps, 'libaaclip_data.so' in maps.replace(native.LIB_PATH, ''),"
        " bad)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, env=env, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "True False []"
