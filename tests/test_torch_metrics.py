"""Port's evaluation metrics (ops/metrics.py) vs the JAX package's and
sklearn's, on the CPU. The port ranks in chunks; every count it sums is an
integer, so the result must not depend on the chunk size."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from sklearn.metrics import average_precision_score, roc_auc_score

from aa_clip_iqm_tpu.evaluation import predict as jpredict
from aa_clip_iqm_tpu.ops import metrics as jmetrics
from aa_clip_iqm_tpu_torch.evaluation import predict as tpredict
from aa_clip_iqm_tpu_torch.ops import metrics as tmetrics

TOL = 1e-6


def _case(name, n=5000, seed=0):
    rng = np.random.default_rng(seed)
    labels = (rng.random(n) < 0.2).astype(np.float32)
    if name == "continuous":
        scores = rng.standard_normal(n).astype(np.float32) + labels
    elif name == "ties":
        scores = (rng.integers(0, 12, n) + 3 * labels).astype(np.float32) / 7
    elif name == "constant":
        scores = np.full(n, 0.25, np.float32)
    elif name == "two_values":
        scores = (rng.random(n) < 0.5).astype(np.float32)
    elif name == "separable":
        scores = labels + 0.1 * rng.random(n).astype(np.float32)
    else:
        raise KeyError(name)
    return scores, labels


@pytest.mark.parametrize("chunk", [tmetrics.DEFAULT_CHUNK, 777, 64])
@pytest.mark.parametrize("name", ["continuous", "ties", "constant",
                                  "two_values", "separable"])
def test_rank_metrics_match_jax_and_sklearn(name, chunk):
    scores, labels = _case(name)
    auc, ap = tmetrics._rank_metrics(torch.from_numpy(scores),
                                     torch.from_numpy(labels), scores.size,
                                     chunk=chunk)
    jauc, jap = jmetrics._rank_metrics(jnp.asarray(scores), jnp.asarray(labels),
                                       scores.size)
    assert abs(float(auc) - roc_auc_score(labels, scores)) < TOL
    assert abs(float(ap) - average_precision_score(labels, scores)) < TOL
    assert abs(float(auc) - float(jauc)) < TOL
    assert abs(float(ap) - float(jap)) < TOL
    hauc, hap = tmetrics.rank_metrics_host(scores, labels)
    assert abs(hauc - float(auc)) < TOL and abs(hap - float(ap)) < TOL


@pytest.mark.parametrize("chunk", [tmetrics.DEFAULT_CHUNK, 100])
@pytest.mark.parametrize("name", ["continuous", "ties", "constant"])
def test_rank_metrics_front_padding(name, chunk):
    """Padded entries (-inf, label 0) change nothing, wherever they lie."""
    scores, labels = _case(name, n=900, seed=3)
    pad = 124
    rng = np.random.default_rng(1)
    ps = np.concatenate([scores, np.full(pad, -np.inf, np.float32)])
    pl = np.concatenate([labels, np.zeros(pad, np.float32)])
    order = rng.permutation(ps.size)
    auc, ap = tmetrics._rank_metrics(torch.from_numpy(ps[order]),
                                     torch.from_numpy(pl[order]), scores.size,
                                     chunk=chunk)
    assert abs(float(auc) - roc_auc_score(labels, scores)) < TOL
    assert abs(float(ap) - average_precision_score(labels, scores)) < TOL
    jauc, jap = jmetrics._rank_metrics(jnp.asarray(ps), jnp.asarray(pl), scores.size)
    assert abs(float(auc) - float(jauc)) < TOL and abs(float(ap) - float(jap)) < TOL


def test_auroc_ap_entry_points():
    scores, labels = _case("ties", n=400, seed=5)
    s, l = torch.from_numpy(scores), torch.from_numpy(labels)
    auc, ap = tmetrics.auroc_ap(s, l)
    assert float(tmetrics.auroc(s, l)) == float(auc)
    assert float(tmetrics.average_precision(s, l)) == float(ap)
    assert auc.dtype == torch.float64
    nan_auc, nan_ap = tmetrics.auroc_ap(s, torch.zeros_like(l))   # no positive
    assert torch.isnan(nan_auc) and torch.isnan(nan_ap)


def _maps(seed, b=5, size=24, pad=3):
    rng = np.random.default_rng(seed)
    maps = rng.random((b + pad, size, size)).astype(np.float32) * 3 - 1
    masks = rng.random((b + pad, size, size)) < 0.1
    maps[masks] += 0.7
    maps[b:] = 0.0
    valid = np.arange(b + pad) < b
    return maps, masks, valid, b * size * size


@pytest.mark.parametrize("chunk", [tmetrics.DEFAULT_CHUNK, 24 * 24 * 2, 100])
@pytest.mark.parametrize("variant", ["plain", "max_is_one", "constant"])
def test_pixel_metrics_device_matches_jax(variant, chunk):
    maps, masks, valid, n_valid = _maps(11)
    if variant == "max_is_one":       # the conditional min-max passes through
        maps[valid] = np.minimum(maps[valid], 1.0)
        maps[0, 0, 0] = 1.0
    elif variant == "constant":       # rng == 0
        maps[valid] = 0.5
    ref = jmetrics.pixel_metrics_device(jnp.asarray(maps), jnp.asarray(masks),
                                        jnp.asarray(valid), n_valid)
    out = tmetrics.pixel_metrics_device(torch.from_numpy(maps), torch.from_numpy(masks),
                                        torch.from_numpy(valid), n_valid, chunk=chunk)
    for o, r in zip(out[:2], ref[:2]):
        np.testing.assert_allclose(float(o), float(r), atol=1e-5)
    np.testing.assert_array_equal(out[2].numpy()[valid], np.asarray(ref[2])[valid])
    pix = tmetrics.masked_conditional_minmax(torch.from_numpy(maps),
                                             torch.from_numpy(valid)[:, None, None])
    jpix = jmetrics.masked_conditional_minmax(jnp.asarray(maps),
                                              jnp.asarray(valid)[:, None, None])
    np.testing.assert_array_equal(pix.numpy(), np.asarray(jpix))


@pytest.mark.parametrize("domain", ["Industrial", "Medical"])
@pytest.mark.parametrize("use_device", [True, False])
def test_metrics_eval_matches_jax(domain, use_device):
    maps, masks, valid, _ = _maps(21, b=9, pad=0)
    rng = np.random.default_rng(2)
    image_label = (masks.reshape(9, -1).mean(1) > 0.1).astype(np.int64)
    image_label[:2] = [0, 1]
    image_preds = rng.random(9).astype(np.float32)
    ref = jmetrics.metrics_eval(masks[:, None].astype(np.float32), image_label,
                                maps, image_preds, "widget", domain)
    out = tmetrics.metrics_eval(masks[:, None].astype(np.float32), image_label,
                                maps, image_preds, "widget", domain,
                                use_device=use_device, device="cpu")
    assert out["class name"] == "widget" and list(out) == list(ref)
    for k in tpredict.METRIC_KEYS:
        assert abs(out[k] - ref[k]) <= 0.0101, (k, out[k], ref[k])   # one rounding step
    single = tmetrics.metrics_eval(masks, np.ones(9, np.int64), maps, image_preds,
                                   "widget", domain, use_device=use_device, device="cpu")
    assert single["image AUC"] == 0.0 and single["image AP"] == 0.0


@pytest.mark.parametrize("domain", ["Industrial", "Medical"])
@pytest.mark.parametrize("n,pad_multiple", [(9, 1), (9, 16), (16, 16)])
def test_class_metrics_device_matches_jax(domain, n, pad_multiple):
    """Device metrics of a class: equal to the JAX package's (which pads to
    16) with and without padding, and to the host metrics_eval."""
    maps, masks, _, _ = _maps(31, b=n, pad=0)
    rng = np.random.default_rng(4)
    labels = (np.arange(n) % 2).astype(np.int64)
    scores = rng.random(n).astype(np.float32)
    jrow = jpredict.class_metrics_device(
        {"maps": jnp.asarray(maps), "masks": jnp.asarray(masks), "labels": labels,
         "image_scores": jnp.asarray(scores)}, "widget", domain)
    preds = {"maps": torch.from_numpy(maps), "masks": torch.from_numpy(masks),
             "labels": labels, "image_scores": torch.from_numpy(scores)}
    row = tpredict.class_metrics_device(preds, "widget", domain,
                                        pad_multiple=pad_multiple, chunk=1000)
    host = tmetrics.metrics_eval(masks, labels, maps, scores, "widget", domain,
                                 use_device=False, device="cpu")
    for k in tpredict.METRIC_KEYS:
        assert abs(row[k] - jrow[k]) <= 0.0101, (k, row[k], jrow[k])
        assert abs(row[k] - host[k]) <= 0.0101, (k, row[k], host[k])
    deferred = tpredict.class_metrics_device(preds, "widget", domain, defer=True)
    assert "_device" in deferred and "pixel AUC" not in deferred
    assert tpredict._finalize_row(deferred) == tpredict.class_metrics_device(
        preds, "widget", domain)
    one_label = dict(preds, labels=np.zeros(n, np.int64))
    assert tpredict.class_metrics_device(one_label, "w", domain)["image AUC"] == 0.0


def test_minmax_normalize_matches_jax():
    rng = np.random.default_rng(6)
    for x in (rng.random((3, 4)).astype(np.float32) * 5,
              np.full((2, 2), 0.3, np.float32),
              np.array([0.2, 1.0], np.float32)):
        np.testing.assert_array_equal(tmetrics.minmax_normalize(x),
                                      jmetrics.minmax_normalize(x))
