"""The port's checkpoint converters against the JAX package's, on the tiny
config: the OpenAI state dict -> params mapping, the three .pt forms, the
per-resolution .npz cache beside a .pt (read by both packages), and the
reference adapter importers."""
import os

import jax
import numpy as np
import pytest
import torch

from aa_clip_iqm_tpu import configs as jconfigs
from aa_clip_iqm_tpu import loader as jloader
from aa_clip_iqm_tpu.models import adapters as jadapters
from aa_clip_iqm_tpu.models import convert as jconvert
from aa_clip_iqm_tpu_torch import configs as tconfigs
from aa_clip_iqm_tpu_torch import loader as tloader
from aa_clip_iqm_tpu_torch.models import convert as tconvert
from test_state_dict_schema import _RecordingDict
from torch_ref import make_clip_state_dict

IMG = 56
METADATA = ("input_resolution", "context_length", "vocab_size")


def _state_dict(cfg, seed=1, grid=None):
    """An OpenAI-layout state dict for ``cfg`` with its positional embedding
    at ``grid`` (the config's own by default)."""
    return make_clip_state_dict(
        np.random.default_rng(seed), v_layers=cfg.vision.layers,
        v_width=cfg.vision.width, v_patch=cfg.vision.patch_size,
        v_grid=grid or cfg.vision.grid, t_layers=cfg.text.layers,
        t_width=cfg.text.width, vocab=cfg.text.vocab_size,
        embed_dim=cfg.embed_dim)


def _flat(tree):
    return dict(tconvert._flatten(jax.tree.map(np.asarray, tree)))


def _assert_trees_equal(got, want):
    got, want = _flat(got), _flat(want)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _tensors(tree, prefix=""):
    """{path: tensor} of a nested dict / list of tensors."""
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out = {}
    for k, v in items:
        if isinstance(v, torch.Tensor):
            out[f"{prefix}{k}"] = v
        else:
            out.update(_tensors(v, f"{prefix}{k}/"))
    return out


def _assert_same_tensors(got, want):
    got, want = _tensors(got), _tensors(want)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("grid", [None, 6], ids=["native", "resized"])
def test_state_dict_to_params_matches_jax(grid):
    """Leaf for leaf the JAX converter's output, every key of the OpenAI
    layout read; a state dict saved at another grid (6 x 6 here, 4 x 4
    wanted) has its positional embedding resized by both packages alike."""
    cfg = jconfigs.tiny_test_config(IMG).clip
    tcfg = tconfigs.tiny_test_config(IMG).clip
    sd = _RecordingDict(_state_dict(cfg, grid=grid))
    got = tconvert.torch_state_dict_to_params(sd, tcfg)
    assert not set(sd) - sd.read, sorted(set(sd) - sd.read)
    want = jconvert.torch_state_dict_to_params(dict(sd), cfg)
    _assert_trees_equal(got, want)
    assert got["visual"]["positional_embedding"].shape == (cfg.vision.grid ** 2 + 1,
                                                           cfg.vision.width)
    assert got["visual"]["blocks"]["attn"]["qkv"]["w"].shape == (
        cfg.vision.layers, cfg.vision.width, 3 * cfg.vision.width)


def _scripted(sd):
    """A TorchScript archive whose state_dict() is ``sd``: nested modules
    named after the dotted keys."""
    class Holder(torch.nn.Module):
        def forward(self, x):
            return x

    root = Holder()
    for key, value in sd.items():
        *path, leaf = key.split(".")
        mod = root
        for name in path:
            if not hasattr(mod, name):
                mod.add_module(name, Holder())
            mod = getattr(mod, name)
        mod.register_parameter(leaf, torch.nn.Parameter(value, requires_grad=False))
    return torch.jit.script(root)


FORMS = ["plain", "state_dict", "torchscript", "plain_float32"]


def _write_pt(path, sd, form):
    dtype = torch.float32 if form == "plain_float32" else torch.float16
    tensors = {k: torch.as_tensor(np.asarray(v)).to(dtype) for k, v in sd.items()}
    if form == "torchscript":
        torch.jit.save(_scripted(tensors), path)
        return
    tensors.update({k: 7 for k in METADATA})
    torch.save({"state_dict": tensors} if form == "state_dict" else tensors, path)


@pytest.mark.parametrize("form", FORMS)
def test_load_openai_checkpoint_forms_match_jax(tmp_path, form):
    """A TorchScript archive, {"state_dict": ...} and a plain dict, fp16 as
    OpenAI ships (and one float32): both packages give the same params,
    the metadata entries dropped and fp16 cast to float32 first."""
    cfg = jconfigs.tiny_test_config(IMG).clip
    path = str(tmp_path / "clip.pt")
    sd = _state_dict(cfg, seed=2, grid=6)
    _write_pt(path, sd, form)
    got = tconvert.load_openai_checkpoint(path, tconfigs.tiny_test_config(IMG).clip)
    _assert_trees_equal(got, jconvert.load_openai_checkpoint(path, cfg))
    rounded = sd["visual.proj"] if form == "plain_float32" else \
        sd["visual.proj"].astype(np.float16).astype(np.float32)
    np.testing.assert_array_equal(got["visual"]["proj"], rounded)


def test_metadata_keys_are_the_only_discards(tmp_path):
    """load_openai_checkpoint drops exactly the reference's three metadata
    entries: the converter then reads every remaining key."""
    cfg = tconfigs.tiny_test_config(IMG).clip
    sd = _state_dict(cfg, seed=3)
    path = str(tmp_path / "meta.pt")
    _write_pt(path, sd, "plain")
    seen = {}
    real = tconvert.torch_state_dict_to_params

    def spy(state, c):
        seen.update(state)
        return real(state, c)

    try:
        tconvert.torch_state_dict_to_params = spy
        tconvert.load_openai_checkpoint(path, cfg)
    finally:
        tconvert.torch_state_dict_to_params = real
    assert set(seen) == set(sd)
    assert all(v.dtype == np.float32 for v in seen.values())


@pytest.fixture
def pt_file(tmp_path):
    cfg = jconfigs.tiny_test_config(IMG)
    path = str(tmp_path / "ViT-tiny.pt")
    _write_pt(path, _state_dict(cfg.clip, seed=4, grid=6), "plain")
    return path, cfg, tconfigs.tiny_test_config(IMG), str(tmp_path / f"ViT-tiny.{IMG}.npz")


def test_pt_route_cache_is_read_by_both_packages(pt_file):
    """The port's .pt route converts, writes <stem>.<image_size>.npz in the
    JAX key layout (blocks stacked, the resized positional embedding), and
    serves the same tensors from that cache as from the conversion; the
    JAX package reads the port's cache, and the port reads the JAX
    package's."""
    path, cfg, tcfg, cache = pt_file
    want = jconvert.load_openai_checkpoint(path, cfg.clip)
    direct = tloader.load_frozen_backbone(tcfg, path, device="cpu", dtype=torch.bfloat16)
    assert os.path.isfile(cache)
    _assert_trees_equal(jconvert.load_params_npz(cache), want)
    cached = tloader.load_frozen_backbone(tcfg, path, device="cpu", dtype=torch.bfloat16)
    _assert_same_tensors(cached, direct)
    # bf16 matrices, float32 vectors: the fp16 -> fp32 -> bf16 rounding.
    w = direct["visual"]["blocks"][0]["mlp"]["c_fc"]["w"]
    assert w.dtype == torch.bfloat16
    assert torch.equal(w, torch.from_numpy(
        np.asarray(want["visual"]["blocks"]["mlp"]["c_fc"]["w"])[0]).to(torch.bfloat16))
    # The cache the JAX loader writes serves the port the same tensors.
    os.remove(cache)
    jloader.load_frozen_backbone(cfg, path)
    assert os.path.isfile(cache)
    _assert_same_tensors(tloader.load_frozen_backbone(tcfg, path, device="cpu",
                                                      dtype=torch.bfloat16), direct)


def test_cache_mtime_rule_and_opt_out(pt_file, tmp_path):
    """Only a cache at least as new as the .pt is read; cache_npz=False
    neither reads nor writes one; a cache that cannot be written is
    skipped."""
    path, cfg, tcfg, cache = pt_file

    def load(**kw):
        frozen = tloader.load_frozen_backbone(tcfg, path, device="cpu",
                                              dtype=torch.float32, **kw)
        return frozen["visual"]["proj"].numpy()

    want = load(cache_npz=False)
    assert not os.path.exists(cache)
    # A cache of other weights, newer than the .pt: read (it is trusted) ...
    params = jax.tree.map(np.asarray, jconvert.load_openai_checkpoint(path, cfg.clip))
    params["visual"]["proj"] = params["visual"]["proj"] + 1.0
    jconvert.save_params_npz(params, cache)
    os.utime(path, (1_000_000, 1_000_000))
    np.testing.assert_array_equal(load(), want + 1.0)
    # ... but not with cache_npz=False, nor once the .pt is newer.
    np.testing.assert_array_equal(load(cache_npz=False), want)
    os.utime(path, None)
    os.utime(cache, (1_000_000, 1_000_000))
    np.testing.assert_array_equal(load(), want)
    # The stale cache was replaced by a fresh one.
    np.testing.assert_array_equal(jconvert.load_params_npz(cache)["visual"]["proj"], want)
    # A cache path that cannot be written does not fail the load.
    os.remove(cache)
    os.mkdir(cache)
    np.testing.assert_array_equal(load(), want)
    assert os.path.isdir(cache)


# --------------------------------------------------------------------------
# Reference adapter checkpoints
# --------------------------------------------------------------------------

def _reference_dicts(cfg, relu, seed):
    """The reference's text_adapter and image_adapter state dicts for cfg:
    torch Linear weights (out, in)."""
    rng = np.random.default_rng(seed)
    tw, vw, out_dim = cfg.clip.text.width, cfg.clip.vision.width, cfg.clip.embed_dim

    def w(o, i):
        return torch.from_numpy(rng.standard_normal((o, i)).astype(np.float32))

    n = cfg.adapter.text_adapt_until
    text = {f"{i}.fc.0.weight": w(tw, tw) for i in range(n + 1)}
    proj = "fc.0.weight" if relu else "fc.weight"
    image = {f"layer_adapters.{i}.fc.0.weight": w(vw, vw)
             for i in range(cfg.adapter.image_adapt_until)}
    image.update({f"seg_proj.{i}.{proj}": w(out_dim, vw)
                  for i in range(len(cfg.adapter.levels))})
    image[f"det_proj.{proj}"] = w(out_dim, vw)
    return text, image


@pytest.fixture(scope="module")
def trainables():
    cfg = jconfigs.tiny_test_config(IMG)
    jt = jadapters.init_adapter_params(jax.random.PRNGKey(0), cfg)
    _, tt = tconvert.params_from_jax(None, jax.tree.map(np.asarray, jt),
                                     tconfigs.tiny_test_config(IMG), device="cpu",
                                     dtype=torch.float32)
    return cfg, jt, tt


@pytest.mark.parametrize("relu", [False, True], ids=["no_relu", "relu"])
@pytest.mark.parametrize("which", ["text", "image", "directory"])
def test_import_reference_matches_jax(tmp_path, trainables, which, relu):
    """import_reference_text_adapter / _image_adapter / _checkpoints give
    the JAX importers' trees from the same state dicts and .pth files (the
    newest image_adapter_{N}.pth by N, the IQM family untouched), in the
    dtype of the tensors they replace, without touching the input."""
    cfg, jt, tt = trainables
    before = tconvert.params_to_jax(tt)
    text, image = _reference_dicts(cfg, relu, seed=5)
    if which == "text":
        got = tconvert.import_reference_text_adapter(text, tt)
        want = jconvert.import_reference_text_adapter(text, jt)
    elif which == "image":
        got = tconvert.import_reference_image_adapter(image, tt, relu=relu)
        want = jconvert.import_reference_image_adapter(image, jt, relu=relu)
    else:
        _, older = _reference_dicts(cfg, relu, seed=6)
        torch.save({"text_adapter": text}, tmp_path / "text_adapter.pth")
        torch.save({"image_adapter": image}, tmp_path / "image_adapter_12.pth")
        torch.save({"image_adapter": older}, tmp_path / "image_adapter_3.pth")
        got = tconvert.import_reference_checkpoints(str(tmp_path), tt, relu=relu)
        want = jconvert.import_reference_checkpoints(str(tmp_path), jt, relu=relu)
    _assert_trees_equal(tconvert.params_to_jax(got), want)
    _assert_trees_equal(tconvert.params_to_jax(tt), before)
    assert all(t.dtype == torch.float32 for t in tconvert.tree_leaves(got))
    if which == "directory":
        np.testing.assert_array_equal(
            got["image_adapter"]["det_proj"]["w"].numpy(),
            image["det_proj." + ("fc.0.weight" if relu else "fc.weight")].numpy().T)
    if which != "text":
        with pytest.raises(KeyError):
            tconvert.import_reference_image_adapter(image, tt, relu=not relu)


def test_import_reference_keeps_bf16_serving_dtype(trainables):
    """Imported weights take the serving trainable's bf16 and device."""
    cfg, jt, _ = trainables
    _, tt = tconvert.params_from_jax(None, jax.tree.map(np.asarray, jt),
                                     tconfigs.tiny_test_config(IMG), device="cpu",
                                     dtype=torch.bfloat16)
    text, _ = _reference_dicts(cfg, False, seed=7)
    got = tconvert.import_reference_text_adapter(text, tt)
    w = got["text_adapter"]["proj"]["w"]
    assert w.dtype == torch.bfloat16
    n = cfg.adapter.text_adapt_until
    assert torch.equal(w, text[f"{n}.fc.0.weight"].T.to(torch.bfloat16))
