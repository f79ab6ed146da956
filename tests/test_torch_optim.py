"""The port's schedules, label groups and optimizers vs the JAX package's
optax ones: LR curves to 2e-6 of the base rate (optax evaluates the cosine in
float32, the port in float64), three optimizer steps on the same gradients
to 1e-6."""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from aa_clip_iqm_tpu.configs import tiny_test_config
from aa_clip_iqm_tpu.models import adapters as jadapters
from aa_clip_iqm_tpu.train import optim as joptim
from aa_clip_iqm_tpu_torch import configs as tconfigs
from aa_clip_iqm_tpu_torch.models.convert import params_from_jax, params_to_jax, tree_leaves
from aa_clip_iqm_tpu_torch.train import optim as toptim


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    torch.set_num_threads(1)


@pytest.mark.parametrize("quirk", [None, 5])
@pytest.mark.parametrize("total", [1, 40])
def test_cosine_annealing_matches_optax(quirk, total):
    jsched = joptim.cosine_annealing(5e-4, total, torch_quirk_period_steps=quirk)
    tsched = toptim.cosine_annealing(5e-4, total, torch_quirk_period_steps=quirk)
    steps = np.arange(0, 60)
    ref = np.asarray(jsched(jnp.asarray(steps)), np.float64)
    got = np.array([tsched(int(s)) for s in steps])
    np.testing.assert_allclose(got, ref, rtol=2e-6, atol=2e-6 * 5e-4)
    if quirk is None:
        assert got[-1] == pytest.approx(1e-6, rel=1e-6)      # eta_min past the end
    else:
        assert got[2 * quirk] == pytest.approx(5e-4, rel=1e-6)  # climbs back up


def _trainables(seed=1):
    cfg = tiny_test_config(56)
    jt = jadapters.init_adapter_params(jax.random.PRNGKey(seed), cfg)
    _, tt = params_from_jax(None, jax.tree.map(np.asarray, jt),
                            tconfigs.tiny_test_config(56), device="cpu",
                            dtype=torch.float32)
    return jt, tt


def test_stage2_param_labels_match_jax():
    jt, tt = _trainables()
    jlabels = joptim.stage2_param_labels(jt)
    tlabels = toptim.stage2_param_labels(tt)
    assert set(tlabels) == set(jlabels)
    for key in jlabels:
        want = set(jax.tree.leaves(jlabels[key]))
        assert set(tree_leaves(tlabels[key])) == want, key
    assert set(tree_leaves(tlabels["text_adapter"])) == {"frozen"}
    assert set(tree_leaves(tlabels["pos_embedding"])) == {"frozen"}
    assert set(tree_leaves(tlabels["query_proj"])) == {"iqm"}


def _fake_grads(jt, step):
    rng = np.random.default_rng(100 + step)
    return jax.tree.map(
        lambda p: jnp.asarray(rng.standard_normal(p.shape).astype(np.float32)), jt)


def _set_grads(tt, jgrads):
    _, tg = params_from_jax(None, jax.tree.map(np.asarray, jgrads),
                            tconfigs.tiny_test_config(56), device="cpu",
                            dtype=torch.float32)
    for p, g in zip(tree_leaves(tt), tree_leaves(tg)):
        p.grad = g


def _assert_trees_close(tt, jt, tol):
    got = params_to_jax(tt)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(jax.tree.map(np.asarray, jt))):
        np.testing.assert_allclose(a, b, rtol=tol, atol=tol)


@pytest.mark.parametrize("quirk", [None, 2])
@pytest.mark.parametrize("clip", [None, 1.0])
def test_three_adamw_steps_match_optax(quirk, clip):
    """AdamW with weight decay on a stepped cosine schedule, two groups, the
    frozen group untouched: parameters after three steps to 1e-6."""
    jt, tt = _trainables()
    start = params_to_jax(tt)
    tx = joptim.stage2_optimizer(jt, 5e-4, 6, torch_quirk_period_steps=quirk)
    jstate = tx.init(jt)
    opt = toptim.stage2_optimizer(tt, 5e-4, 6, torch_quirk_period_steps=quirk)
    for step in range(3):
        grads = _fake_grads(jt, step)
        _set_grads(tt, grads)
        if clip is not None:
            grads = joptim.clip_stage2_grads(grads, clip)
            toptim.clip_stage2_grads(tt, clip)
        updates, jstate = tx.update(grads, jstate, jt)
        jt = optax.apply_updates(jt, updates)
        opt.step()
    _assert_trees_close(tt, jt, 1e-6)
    end = params_to_jax(tt)
    for key in ("text_adapter", "pos_embedding", "iqm_layer_norm"):
        for a, b in zip(jax.tree.leaves(end[key]), jax.tree.leaves(start[key])):
            np.testing.assert_array_equal(a, b)
    moved = [not np.array_equal(a, b) for a, b in zip(
        jax.tree.leaves(end["image_adapter"]), jax.tree.leaves(start["image_adapter"]))]
    assert all(moved)


def test_three_adam_steps_match_optax():
    """Stage 1: Adam, betas (0.5, 0.999), over the text adapter."""
    jt, tt = _trainables()
    jp, tp = jt["text_adapter"], tt["text_adapter"]
    tx = joptim.stage1_optimizer(1e-5)
    jstate = tx.init(jp)
    opt = toptim.stage1_optimizer(tp, 1e-5)
    for step in range(3):
        grads = _fake_grads(jt, step)["text_adapter"]
        _set_grads(tt, _fake_grads(jt, step))
        updates, jstate = tx.update(grads, jstate, jp)
        jp = optax.apply_updates(jp, updates)
        opt.step()
    got = params_to_jax(tt)["text_adapter"]
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(jax.tree.map(np.asarray, jp))):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)


def test_opt_state_round_trip_is_exact():
    """state_dict -> load_state_dict into a fresh optimizer, then one more
    step: the same bits as the optimizer that never stopped."""
    jt, tt = _trainables()
    _, tt2 = _trainables()
    a = toptim.stage2_optimizer(tt, 5e-4, 6)
    for step in range(2):
        _set_grads(tt, _fake_grads(jt, step))
        a.step()
    b = toptim.stage2_optimizer(tt2, 5e-4, 6)
    for dst, src in zip(tree_leaves(tt2), tree_leaves(tt)):
        dst.data.copy_(src)
    # A copy, as a checkpoint is: load_state_dict may keep the very tensors.
    b.load_state_dict(copy.deepcopy(a.state_dict()))
    for opt, params in ((a, tt), (b, tt2)):
        _set_grads(params, _fake_grads(jt, 2))
        opt.step()
    for x, y in zip(tree_leaves(tt), tree_leaves(tt2)):
        assert torch.equal(x, y)
    assert a.optimizer.param_groups[0]["lr"] == b.optimizer.param_groups[0]["lr"]
