"""The port's training losses, training-path scoring and patch-dropout
indices vs the JAX package, fp32 on the CPU, values and gradients:
rtol 1e-5 / atol 1e-6 (two frameworks' fp32 reductions)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aa_clip_iqm_tpu.evaluation import scoring as jscoring
from aa_clip_iqm_tpu.ops import losses as jlosses
from aa_clip_iqm_tpu_torch.evaluation import scoring as tscoring
from aa_clip_iqm_tpu_torch.ops import layers as tlayers
from aa_clip_iqm_tpu_torch.ops import losses as tlosses

RTOL, ATOL = 1e-5, 1e-6
WEIGHTS = [None, np.array([1.0, 1.0, 0.0], np.float32), np.zeros(3, np.float32)]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    torch.set_num_threads(1)


def _probs(seed, shape):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal(shape).astype(np.float32)
    e = np.exp(logits - logits.max(axis=1, keepdims=True))
    return e / e.sum(axis=1, keepdims=True)


def _value_and_grad(jfn, tfn, x, *rest):
    """(JAX value, JAX grad, torch value, torch grad) in the first input."""
    jv, jg = jax.value_and_grad(lambda a: jfn(a, *[None if r is None else jnp.asarray(r)
                                                   for r in rest]))(jnp.asarray(x))
    t = torch.from_numpy(x).requires_grad_(True)
    tv = tfn(t, *[None if r is None else torch.from_numpy(r) for r in rest])
    (tg,) = torch.autograd.grad(tv, t)
    return np.asarray(jv), np.asarray(jg), tv.detach().numpy(), tg.numpy()


def _close(jv, jg, tv, tg):
    np.testing.assert_allclose(tv, jv, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tg, jg, rtol=RTOL, atol=ATOL * max(1.0, np.abs(jg).max()))


@pytest.mark.parametrize("weight", WEIGHTS, ids=["none", "padded", "all-padded"])
def test_focal_loss(weight):
    probs = _probs(0, (3, 2, 8, 8))
    target = (np.random.default_rng(1).random((3, 1, 8, 8)) > 0.7).astype(np.float32)
    _close(*_value_and_grad(
        lambda p, t, w: jlosses.focal_loss(p, t, sample_weight=w),
        lambda p, t, w: tlosses.focal_loss(p, t, sample_weight=w), probs, target, weight))


@pytest.mark.parametrize("weight", WEIGHTS, ids=["none", "padded", "all-padded"])
def test_binary_dice_loss(weight):
    rng = np.random.default_rng(2)
    pred = rng.random((3, 8, 8)).astype(np.float32)
    target = (rng.random((3, 8, 8)) > 0.5).astype(np.float32)
    _close(*_value_and_grad(
        lambda p, t, w: jlosses.binary_dice_loss(p, t, sample_weight=w),
        lambda p, t, w: tlosses.binary_dice_loss(p, t, sample_weight=w),
        pred, target, weight))


@pytest.mark.parametrize("weight", WEIGHTS, ids=["none", "padded", "all-padded"])
def test_seg_loss(weight):
    probs = _probs(3, (3, 2, 10, 10))
    mask = (np.random.default_rng(4).random((3, 1, 10, 10)) > 0.8).astype(np.float32)
    _close(*_value_and_grad(
        lambda p, m, w: jlosses.seg_loss(p, m, sample_weight=w),
        lambda p, m, w: tlosses.seg_loss(p, m, sample_weight=w), probs, mask, weight))


@pytest.mark.parametrize("weight", WEIGHTS[:2], ids=["none", "padded"])
def test_seg_loss_tokens(weight):
    probs = _probs(5, (3, 2, 12))
    cells = np.random.default_rng(6).random((3, 12)).astype(np.float32)
    _close(*_value_and_grad(
        lambda p, c, w: jlosses.seg_loss_tokens(p, c, sample_weight=w),
        lambda p, c, w: tlosses.seg_loss_tokens(p, c, sample_weight=w),
        probs, cells, weight))


@pytest.mark.parametrize("weight", WEIGHTS, ids=["none", "padded", "all-padded"])
def test_cross_entropy_logits(weight):
    rng = np.random.default_rng(7)
    logits = rng.standard_normal((3, 2)).astype(np.float32)
    labels = np.array([0, 1, 1], np.int64)
    jv, jg = jax.value_and_grad(lambda a: jlosses.cross_entropy_logits(
        a, jnp.asarray(labels), None if weight is None else jnp.asarray(weight)))(
            jnp.asarray(logits))
    t = torch.from_numpy(logits).requires_grad_(True)
    tv = tlosses.cross_entropy_logits(
        t, torch.from_numpy(labels), None if weight is None else torch.from_numpy(weight))
    (tg,) = torch.autograd.grad(tv, t)
    _close(np.asarray(jv), np.asarray(jg), tv.detach().numpy(), tg.numpy())


def _features(seed, b, l, d):
    rng = np.random.default_rng(seed)
    f = rng.standard_normal((b, l, d)).astype(np.float32)
    f /= np.linalg.norm(f, axis=-1, keepdims=True)
    anchors = rng.standard_normal((b, d, 2)).astype(np.float32)
    anchors /= np.linalg.norm(anchors, axis=1, keepdims=True)
    q = rng.standard_normal((b, 2, d)).astype(np.float32)
    return f, anchors, q


def test_similarity_map_train():
    f, anchors, _ = _features(8, 2, 16, 32)
    jv, jg = jax.value_and_grad(lambda a: jnp.sum(jscoring.similarity_map_train(
        a, jnp.asarray(anchors), 56)[:, 1] ** 2))(jnp.asarray(f))
    t = torch.from_numpy(f).requires_grad_(True)
    out = tscoring.similarity_map_train(t, torch.from_numpy(anchors), 56)
    assert out.shape == (2, 2, 56, 56)
    np.testing.assert_allclose(out.sum(dim=1).detach().numpy(), 1.0, atol=1e-5)
    tv = (out[:, 1] ** 2).sum()
    (tg,) = torch.autograd.grad(tv, t)
    np.testing.assert_allclose(tv.item(), float(jv), rtol=1e-5)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-4,
                               atol=1e-5 * np.abs(np.asarray(jg)).max())


def test_iqm_train_map_and_patch_pred():
    f, _, q = _features(9, 2, 16, 32)
    jp = jscoring.iqm_patch_pred(jnp.asarray(f), jnp.asarray(q))
    tp = tscoring.iqm_patch_pred(torch.from_numpy(f), torch.from_numpy(q))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=RTOL, atol=ATOL)
    jm = jscoring.iqm_train_map(jnp.asarray(f), jnp.asarray(q), 56)
    tm = tscoring.iqm_train_map(torch.from_numpy(f), torch.from_numpy(q), 56)
    assert tm.shape == (2, 2, 56, 56)
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=RTOL, atol=ATOL)


def test_mask_to_patch_cells():
    mask = (np.random.default_rng(10).random((2, 1, 56, 56)) > 0.6).astype(np.float32)
    ref = jscoring.mask_to_patch_cells(jnp.asarray(mask), 14)
    out = tscoring.mask_to_patch_cells(torch.from_numpy(mask), 14)
    assert out.shape == (2, 16)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("rate,tokens", [(0.25, 16), (0.5, 1369), (0.999, 16)])
def test_patch_dropout_indices(rate, tokens):
    """The draws are torch's, so the JAX package's numbers are not
    reproduced: shape, count, order and determinism are."""
    from aa_clip_iqm_tpu.ops.layers import patch_dropout_indices as jidx

    ref = jidx(jax.random.PRNGKey(0), 3, tokens, rate)
    gen = torch.Generator().manual_seed(5)
    idx = tlayers.patch_dropout_indices(gen, 3, tokens, rate)
    assert tuple(idx.shape) == tuple(ref.shape) and idx.dtype == torch.int64
    assert (idx[:, 1:] > idx[:, :-1]).all() and idx.min() >= 0 and idx.max() < tokens
    again = tlayers.patch_dropout_indices(torch.Generator().manual_seed(5), 3, tokens, rate)
    assert torch.equal(idx, again)
    assert not torch.equal(idx, tlayers.patch_dropout_indices(gen, 3, tokens, rate)) \
        or idx.shape[1] == tokens
