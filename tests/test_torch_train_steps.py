"""The port's training steps vs the JAX package's, on tiny_test_config(56) in
fp32 on the CPU: one stage-1 step and one stage-2 step give JAX's loss,
gradients and updated parameters (2e-5); gradient accumulation over 1, 2 and
4 microbatches is exact to fp32 summation order; patch dropout with the same
kept indices; checkpointed blocks give the same step."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aa_clip_iqm_tpu.configs import TrainConfig as JTrainConfig
from aa_clip_iqm_tpu.configs import tiny_test_config
from aa_clip_iqm_tpu.models import adapters as jadapters
from aa_clip_iqm_tpu.models import clip as jclip
from aa_clip_iqm_tpu.ops.layers import patch_dropout_indices as jpatch_idx
from aa_clip_iqm_tpu.prompts import batched_prompt_tokens as jprompt_tokens
from aa_clip_iqm_tpu.train import optim as joptim
from aa_clip_iqm_tpu.train import steps as jsteps
from aa_clip_iqm_tpu_torch import configs as tconfigs
from aa_clip_iqm_tpu_torch.loader import build_model_config
from aa_clip_iqm_tpu_torch.models.convert import params_from_jax, params_to_jax, tree_leaves
from aa_clip_iqm_tpu_torch.ops import fused_mlp, packed_attention
from aa_clip_iqm_tpu_torch.train import optim as toptim
from aa_clip_iqm_tpu_torch.train import steps as tsteps

IMG = 56
TOL = 2e-5


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def model():
    cfg = tiny_test_config(IMG)
    frozen = jclip.init_clip_params(jax.random.PRNGKey(0), cfg.clip)
    trainable = jadapters.init_adapter_params(jax.random.PRNGKey(1), cfg)
    return cfg, frozen, trainable


def _port(frozen, trainable):
    """Fresh port copies: the frozen backbone and float32 trainable tensors
    that require grad."""
    tf, tt = params_from_jax(jax.tree.map(np.asarray, frozen),
                             jax.tree.map(np.asarray, trainable),
                             tconfigs.tiny_test_config(IMG), device="cpu",
                             dtype=torch.float32)
    for t in tree_leaves(tt):
        t.requires_grad_(True)
    return tf, tt


def _batch(seed, n):
    rng = np.random.default_rng(seed)
    images = rng.standard_normal((n, 3, IMG, IMG)).astype(np.float32)
    masks = (rng.random((n, 1, IMG, IMG)) > 0.8).astype(np.float32)
    labels = rng.integers(0, 2, n).astype(np.int64)
    anchors = rng.standard_normal((n, 32, 2)).astype(np.float32)
    anchors /= np.linalg.norm(anchors, axis=1, keepdims=True)
    return images, masks, labels, anchors


def _close(got, ref, tol=TOL):
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), ref, rtol=tol,
                               atol=tol * max(1e-3, float(np.abs(ref).max())))


def _trees_close(tt, jt, tol=TOL):
    """Updated parameters, absolute: Adam's first step is lr * g / (|g| + eps),
    so an entry whose gradient is as small as eps (1e-8) moves by a share of
    lr that the last bits of g decide; every other entry moves by +-lr (5e-4
    or 5e-5 here) and a wrong sign would show as twice that."""
    got = jax.tree.leaves(params_to_jax(tt))
    ref = jax.tree.leaves(jax.tree.map(np.asarray, jt))
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a, b, rtol=tol, atol=tol)


def _grads_close(tt, ref_leaves, tol):
    """The gradients held by ``tt`` against ``ref_leaves``, on one scale for
    the whole tree: some leaves' gradients are zero but for rounding noise
    (a bias that a softmax or a LayerNorm cancels), so a leaf's own largest
    entry is no scale for it."""
    got = jax.tree.leaves(params_to_jax(_grad_tree(tt)))
    ref = [np.asarray(r, np.float32) for r in ref_leaves]
    scale = max(float(np.abs(r).max()) for r in ref)
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a, b, rtol=tol, atol=tol * scale)


def _grad_tree(tree):
    if isinstance(tree, dict):
        return {k: _grad_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_grad_tree(v) for v in tree]
    return torch.zeros_like(tree) if tree.grad is None else tree.grad


def test_stage1_step_matches_jax(model):
    cfg, frozen, trainable = model
    tf, tt = _port(frozen, trainable)
    train_cfg = JTrainConfig(dataset="MVTec", img_size=IMG, compute_dtype="float32")
    classes, tokens, n_norm, n_abn = jprompt_tokens("MVTec")
    images, masks, _, _ = _batch(0, 3)
    class_idx = np.array([0, 7, 14], np.int32)
    weights = np.array([1.0, 1.0, 0.0], np.float32)     # one padded row

    jfeats = jsteps.make_stage1_visual_fn(cfg)(frozen, jnp.asarray(images))
    tx = joptim.stage1_optimizer(train_cfg.text_lr)
    jstep = jsteps.make_stage1_step(cfg, train_cfg, tokens, len(classes), n_norm,
                                    n_abn, tx)
    jparams, _, jloss = jstep(trainable["text_adapter"], tx.init(trainable["text_adapter"]),
                              frozen, jfeats, jnp.asarray(masks), jnp.asarray(class_idx),
                              jnp.asarray(weights))

    tcfg = tconfigs.tiny_test_config(IMG)
    ttrain = tconfigs.TrainConfig(dataset="MVTec", img_size=IMG, compute_dtype="float32")
    fused_mlp.reset_launches()
    packed_attention.reset_launches()
    tfeats = tsteps.make_stage1_visual_fn(tcfg)(tf, torch.from_numpy(images))
    assert all(f.grad_fn is None for f in tfeats)
    for t, j in zip(tfeats, jfeats):
        _close(t.numpy(), j, 1e-4)
    opt = toptim.stage1_optimizer(tt["text_adapter"], ttrain.text_lr)
    tstep = tsteps.make_stage1_step(tcfg, ttrain, torch.from_numpy(np.asarray(tokens, np.int64)),
                                    len(classes), n_norm, n_abn)
    before = params_to_jax(tt)
    params, opt2, tloss = tstep(tt["text_adapter"], opt, tf, tfeats,
                                torch.from_numpy(masks),
                                torch.from_numpy(class_idx).long(),
                                torch.from_numpy(weights))
    assert params is tt["text_adapter"] and opt2 is opt and tloss.grad_fn is None
    assert fused_mlp.LAUNCHES == packed_attention.LAUNCHES == 0
    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=TOL)
    _trees_close({"text_adapter": params}, {"text_adapter": jparams})
    after = params_to_jax(tt)
    assert all(not np.array_equal(a, b) for a, b in zip(
        jax.tree.leaves(after["text_adapter"]), jax.tree.leaves(before["text_adapter"])))
    for key in after:
        if key != "text_adapter":
            for a, b in zip(jax.tree.leaves(after[key]), jax.tree.leaves(before[key])):
                np.testing.assert_array_equal(a, b)


def _jax_stage2(cfg, frozen, trainable, batch, weights, accum=1, rng=None, remat=False,
                clip=None):
    train_cfg = JTrainConfig(img_size=IMG, compute_dtype="float32",
                             grad_accum_steps=accum, remat=remat)
    tx = joptim.stage2_optimizer(trainable, train_cfg.image_lr, 10)
    step = jsteps.make_stage2_step(cfg, train_cfg, tx, donate=False, clip_grad_norm=clip)
    args = [trainable, tx.init(trainable), frozen, *map(jnp.asarray, batch),
            jnp.asarray(weights)]
    if rng is not None:
        args.append(rng)
    params, _, loss = step(*args)
    return params, float(loss)


def _port_stage2(tcfg, tf, tt, batch, weights, accum=1, rng=None, remat=False, clip=None):
    train_cfg = tconfigs.TrainConfig(img_size=IMG, compute_dtype="float32",
                                     grad_accum_steps=accum, remat=remat)
    opt = toptim.stage2_optimizer(tt, train_cfg.image_lr, 10)
    step = tsteps.make_stage2_step(tcfg, train_cfg, clip_grad_norm=clip)
    images, masks, labels, anchors = (torch.from_numpy(a) for a in batch)
    _, _, loss = step(tt, opt, tf, images, masks, labels, anchors,
                      torch.from_numpy(weights), rng)
    return loss.item()


@pytest.mark.parametrize("clip", [None, 0.5])
def test_stage2_step_matches_jax(model, clip):
    cfg, frozen, trainable = model
    tf, tt = _port(frozen, trainable)
    batch = _batch(1, 4)
    weights = np.array([1.0, 1.0, 1.0, 0.0], np.float32)
    jparams, jloss = _jax_stage2(cfg, frozen, trainable, batch, weights, clip=clip)
    before = params_to_jax(tt)
    tloss = _port_stage2(tconfigs.tiny_test_config(IMG), tf, tt, batch, weights, clip=clip)
    np.testing.assert_allclose(tloss, jloss, rtol=TOL)
    _trees_close(tt, jparams)
    after = params_to_jax(tt)
    labels = toptim.stage2_param_labels(tt)
    for key in after:
        changed = [not np.array_equal(a, b) for a, b in zip(
            jax.tree.leaves(after[key]), jax.tree.leaves(before[key]))]
        frozen_group = set(tree_leaves(labels[key])) == {"frozen"}
        assert all(changed) != frozen_group and any(changed) != frozen_group, key
    # The gradient reaches block 0's adapter, through every block above it.
    g0 = tt["image_adapter"]["layer_adapters"][0]["w"].grad
    assert g0 is not None and g0.abs().max() > 0


def test_stage2_gradients_match_jax(model):
    """The gradients themselves (before Adam normalizes them away), against
    jax.grad of the JAX loss."""
    cfg, frozen, trainable = model
    tf, tt = _port(frozen, trainable)
    batch = _batch(2, 2)

    def jloss(tr):
        out = jadapters.encode_image_adapted(frozen, tr, cfg, jnp.asarray(batch[0]),
                                             text_anchors=jnp.asarray(batch[3]))
        return jnp.sum(out.det_token ** 2) + sum(jnp.sum(s[..., 0]) for s in out.seg_tokens) \
            + jnp.sum(out.iqm_queries ** 2)

    jg = jax.grad(jloss)(trainable)
    from aa_clip_iqm_tpu_torch.models import adapters as tadapters

    out = tadapters.encode_image_adapted(tf, tt, tconfigs.tiny_test_config(IMG),
                                         torch.from_numpy(batch[0]),
                                         text_anchors=torch.from_numpy(batch[3]),
                                         fused_mlp="frozen")
    loss = (out.det_token ** 2).sum() + sum(s[..., 0].sum() for s in out.seg_tokens) \
        + (out.iqm_queries ** 2).sum()
    loss.backward()
    _grads_close(tt, jax.tree.leaves(jg), 1e-4)


@pytest.mark.parametrize("accum", [2, 4])
def test_grad_accumulation_is_exact(model, accum):
    """1 vs 2 vs 4 microbatches with a padded row: the same loss and the same
    gradients up to fp32 summation order, and JAX's accumulated step."""
    cfg, frozen, trainable = model
    batch = _batch(3, 4)
    weights = np.array([1.0, 1.0, 1.0, 0.0], np.float32)
    tcfg = tconfigs.tiny_test_config(IMG)
    tf, t1 = _port(frozen, trainable)
    _, tk = _port(frozen, trainable)
    l1 = _port_stage2(tcfg, tf, t1, batch, weights, accum=1)
    lk = _port_stage2(tcfg, tf, tk, batch, weights, accum=accum)
    np.testing.assert_allclose(lk, l1, rtol=1e-6)
    _grads_close(tk, jax.tree.leaves(params_to_jax(_grad_tree(t1))), 1e-5)
    jparams, jloss = _jax_stage2(cfg, frozen, trainable, batch, weights, accum=accum)
    np.testing.assert_allclose(lk, jloss, rtol=TOL)
    _trees_close(tk, jparams)


def test_grad_accumulation_refuses_a_ragged_split(model):
    cfg, frozen, trainable = model
    tf, tt = _port(frozen, trainable)
    with pytest.raises(ValueError, match="not divisible"):
        _port_stage2(tconfigs.tiny_test_config(IMG), tf, tt, _batch(4, 3),
                     np.ones(3, np.float32), accum=2)


def test_patch_dropout_step_with_shared_indices(model):
    """Patch dropout at 0.25 (12 of 16 tokens kept): the port's step, given
    the kept indices the JAX step draws from its key, gives JAX's loss and
    parameters."""
    cfg, frozen, trainable = model
    vision = dataclasses.replace(cfg.clip.vision, patch_dropout=0.25)
    jcfg = dataclasses.replace(cfg, clip=dataclasses.replace(cfg.clip, vision=vision))
    tcfg = build_model_config("tiny-test", IMG, patch_dropout=0.25)
    assert tcfg.clip.vision.patch_dropout == 0.25
    batch = _batch(5, 2)
    weights = np.ones(2, np.float32)
    key = jax.random.PRNGKey(9)
    keep = np.asarray(jpatch_idx(key, 2, 16, 0.25))
    assert keep.shape == (2, 12)
    jparams, jloss = _jax_stage2(jcfg, frozen, trainable, batch, weights, rng=key)
    tf, tt = _port(frozen, trainable)
    tloss = _port_stage2(tcfg, tf, tt, batch, weights,
                         rng=torch.from_numpy(keep.astype(np.int64)))
    np.testing.assert_allclose(tloss, jloss, rtol=TOL)
    _trees_close(tt, jparams)
    # With a generator the step draws its own indices and still trains.
    _, tg = _port(frozen, trainable)
    loss = _port_stage2(tcfg, tf, tg, batch, weights, rng=torch.Generator().manual_seed(1))
    assert np.isfinite(loss) and loss != tloss


def test_remat_equals_no_remat(model):
    cfg, frozen, trainable = model
    batch = _batch(6, 2)
    weights = np.ones(2, np.float32)
    tcfg = tconfigs.tiny_test_config(IMG)
    tf, ta = _port(frozen, trainable)
    _, tb = _port(frozen, trainable)
    la = _port_stage2(tcfg, tf, ta, batch, weights, remat=False)
    lb = _port_stage2(tcfg, tf, tb, batch, weights, remat=True)
    assert la == lb
    for a, b in zip(tree_leaves(_grad_tree(ta)), tree_leaves(_grad_tree(tb))):
        assert torch.equal(a, b)
    for a, b in zip(tree_leaves(ta), tree_leaves(tb)):
        assert torch.equal(a, b)
