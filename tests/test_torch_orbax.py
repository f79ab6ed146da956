"""tools/orbax_to_torch.py on tiny_test_config(56): the JAX package saves
stage 1, stage 2 over two epochs, and a stage-1 and a stage-2 step
checkpoint with their optimizer state after one update; the converter turns
the orbax save path into the port's layout. Then:

- the port's restore_adapters gives the JAX parameters back bit for bit
  (float32), and each step checkpoint's parameters too;
- AnomalyDetector.from_checkpoint on the converted directory is held to the
  JAX package's from_checkpoint on the orbax one (the same .npz backbone) at
  the serving tolerance of tests/test_torch_serving.py (1e-4 of the largest
  value);
- one further optimizer step in each package, from the restored state with
  the same numpy gradient, lands within 1e-6 (stage 1's Adam and stage 2's
  AdamW with its schedule)."""
import argparse
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from aa_clip_iqm_tpu import configs as jconfigs
from aa_clip_iqm_tpu import loader as jloader
from aa_clip_iqm_tpu.models.clip import init_clip_params
from aa_clip_iqm_tpu.serving import AnomalyDetector as JaxDetector
from aa_clip_iqm_tpu.train import checkpoint as jckpt
from aa_clip_iqm_tpu.train import optim as joptim
from aa_clip_iqm_tpu_torch import configs as tconfigs
from aa_clip_iqm_tpu_torch import loader as tloader
from aa_clip_iqm_tpu_torch.models.convert import (params_from_jax, save_params_npz,
                                                  tree_leaves)
from aa_clip_iqm_tpu_torch.serving import AnomalyDetector, _flatten_tree
from aa_clip_iqm_tpu_torch.train import checkpoint as tckpt
from aa_clip_iqm_tpu_torch.train import optim as toptim

IMG = 56
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IMAGE_LR, TOTAL_STEPS, TEXT_LR = 5e-4, 10, 1e-5


def _load_tool():
    spec = importlib.util.spec_from_file_location(
        "orbax_to_torch", os.path.join(ROOT, "tools", "orbax_to_torch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


tool = _load_tool()


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    torch.set_num_threads(1)


def _grads(tree, seed):
    """A seeded numpy gradient of the tree's shape (JAX layout)."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda x: rng.standard_normal(np.shape(x)).astype(np.float32) * 0.1,
                        tree)


def _perturbed(tree, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda x: (np.asarray(x) + rng.standard_normal(np.shape(x)) * 0.01).astype(np.float32),
        tree)


def _update(tx, params, grads, state):
    updates, state = tx.update(jax.tree.map(jnp.asarray, grads), state,
                               jax.tree.map(jnp.asarray, params))
    return jax.tree.map(np.asarray, optax.apply_updates(params, updates)), state


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """A JAX save path with every kind of checkpoint, and its conversion."""
    root = tmp_path_factory.mktemp("orbax")
    save_path, out = str(root / "jax"), str(root / "port")
    cfg = jconfigs.tiny_test_config(IMG)
    template = jax.tree.map(np.asarray, jloader.init_trainable(cfg))
    tx1 = joptim.stage1_optimizer(TEXT_LR)
    text = _perturbed(template["text_adapter"], 1)
    text1, s1 = _update(tx1, text, _grads(text, 2), tx1.init(text))
    jckpt.save_stage1(save_path, 1, text1, s1)
    jckpt.save_step(save_path, "stage1", 1, 1, text1, s1)
    tx2 = joptim.stage2_optimizer(template, IMAGE_LR, TOTAL_STEPS)
    epoch1 = _perturbed({**template, "text_adapter": text1}, 3)
    jckpt.save_stage2(save_path, 1, epoch1, tx2.init(epoch1))
    epoch2, s2 = _update(tx2, epoch1, _grads(epoch1, 4), tx2.init(epoch1))
    epoch2, s2 = _update(tx2, epoch2, _grads(epoch2, 5), s2)
    jckpt.save_stage2(save_path, 2, epoch2, s2)
    jckpt.save_step(save_path, "stage2", 2, 2, epoch2, s2)
    args = tool.build_parser().parse_args(
        ["--save_path", save_path, "--out", out, "--model_name", "tiny-test",
         "--img_size", str(IMG), "--image_lr", str(IMAGE_LR), "--total_steps",
         str(TOTAL_STEPS), "--text_lr", str(TEXT_LR)])
    written = tool.convert(args, log=lambda *_: None)
    return {"save_path": save_path, "out": out, "written": written, "template": template,
            "text1": text1, "s1": s1, "epoch1": epoch1, "epoch2": epoch2, "s2": s2,
            "tx1": tx1, "tx2": tx2, "root": root}


def _port(tree_np):
    _, out = params_from_jax(None, jax.tree.map(np.asarray, tree_np),
                             tconfigs.tiny_test_config(IMG), device="cpu", dtype=torch.float32)
    return out


def _same(port_tree, jax_tree):
    """Every leaf equal, paired by key (the trees' key orders may differ)."""
    got, want = _flatten_tree(port_tree), _flatten_tree(_port(jax_tree))
    assert got.keys() == want.keys()
    for k, b in want.items():
        assert got[k].dtype == torch.float32, k
        assert torch.equal(got[k].detach(), b), k


def test_converter_writes_every_checkpoint(saved):
    assert saved["written"] == {"text_adapter": True, "image_adapter_1": False,
                                "image_adapter_2": False, "image_adapter": True,
                                "text_adapter_step": True, "image_adapter_step": True}
    for name in saved["written"]:
        assert os.path.isfile(os.path.join(saved["out"], name, tckpt.FILE)), name


def test_restored_params_are_bit_for_bit(saved):
    tcfg = tconfigs.tiny_test_config(IMG)
    trainable = tloader.init_trainable(tcfg, device="cpu", dtype=torch.float32)
    restored, adapted, epoch = tckpt.restore_adapters(saved["out"], trainable)
    assert adapted and epoch == 2
    _same(restored, saved["epoch2"])
    # image_adapter_1 holds epoch 1's tree.
    first = tckpt._load(os.path.join(saved["out"], "image_adapter_1"))
    _same(first["params"], saved["epoch1"])
    # The stage-1 checkpoint holds the updated text adapter.
    text = tloader.init_trainable(tcfg, device="cpu", dtype=torch.float32)["text_adapter"]
    assert tckpt.load_stage1(saved["out"], text)["epoch"] == 1
    _same({"text_adapter": text}, {"text_adapter": saved["text1"]})


def test_from_checkpoint_matches_jax(saved):
    """The converted save path serves as the orbax one does."""
    cfg = jconfigs.tiny_test_config(IMG)
    frozen = jax.tree.map(np.asarray, init_clip_params(jax.random.PRNGKey(0), cfg.clip))
    npz = str(saved["root"] / "backbone.npz")
    save_params_npz(frozen, npz)
    tdet = AnomalyDetector.from_checkpoint(
        saved["out"], "MVTec", img_size=IMG, backbone=npz, model_name="tiny-test",
        compute_dtype=torch.float32, device="cpu")
    jdet = JaxDetector.from_checkpoint(
        saved["save_path"], "MVTec", img_size=IMG, backbone=npz, model_name="tiny-test",
        compute_dtype=jnp.float32, use_pallas=False)
    images = np.random.default_rng(6).integers(0, 256, (3, 3, IMG, IMG), dtype=np.uint8)
    for (t, j) in zip(tdet.predict(images, "bottle"), jdet.predict(images, "bottle")):
        j = np.asarray(j, np.float32)
        np.testing.assert_allclose(t, j, rtol=1e-4, atol=1e-4 * np.abs(j).max())


def _set_grads(params, grads_np):
    grads = _flatten_tree(_port(grads_np))
    for k, p in _flatten_tree(params).items():
        p.grad = grads[k].clone()


def test_next_stage1_step_matches_jax(saved):
    """Stage 1's Adam: one more step from the converted step checkpoint."""
    tcfg = tconfigs.tiny_test_config(IMG)
    text = tloader.init_trainable(tcfg, device="cpu", dtype=torch.float32,
                                  requires_grad=True)["text_adapter"]
    opt = toptim.stage1_optimizer(text, TEXT_LR)
    got = tckpt.load_step(saved["out"], "stage1", text, opt)
    assert (got["epoch"], got["step"]) == (1, 1)
    grads = _grads(saved["text1"], 7)
    want, _ = _update(saved["tx1"], saved["text1"], grads, saved["s1"])
    _set_grads({"text_adapter": text}, {"text_adapter": grads})
    opt.step()
    got, ref = _flatten_tree(text), _flatten_tree(_port({"text_adapter": want})["text_adapter"])
    for k in ref:
        np.testing.assert_allclose(got[k].detach().numpy(), ref[k].numpy(), rtol=0, atol=1e-6)


def test_next_stage2_step_matches_jax(saved):
    """Stage 2's AdamW per label, with its schedule at the restored count:
    one more step from the converted step checkpoint."""
    tcfg = tconfigs.tiny_test_config(IMG)
    trainable = tloader.init_trainable(tcfg, device="cpu", dtype=torch.float32,
                                       requires_grad=True)
    opt = toptim.stage2_optimizer(trainable, IMAGE_LR, TOTAL_STEPS)
    got = tckpt.load_step(saved["out"], "stage2", trainable, opt)
    assert (got["epoch"], got["step"]) == (2, 2)
    assert opt.scheduler.last_epoch == 2
    grads = _grads(saved["epoch2"], 8)
    want, _ = _update(saved["tx2"], saved["epoch2"], grads, saved["s2"])
    _set_grads(trainable, grads)
    opt.step()
    got, ref, before = (_flatten_tree(t) for t in (trainable, _port(want),
                                                   _port(saved["epoch2"])))
    for k in ref:
        np.testing.assert_allclose(got[k].detach().numpy(), ref[k].numpy(), rtol=0, atol=1e-6)
    assert any(not torch.equal(ref[k], before[k]) for k in ref)


def test_converter_refuses_an_empty_save_path(tmp_path):
    args = tool.build_parser().parse_args(
        ["--save_path", str(tmp_path), "--out", str(tmp_path / "out"),
         "--model_name", "tiny-test", "--img_size", str(IMG)])
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        tool.convert(args, log=lambda *_: None)
    assert isinstance(args, argparse.Namespace)
