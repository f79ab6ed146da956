"""Evaluation metrics: exact rank-based AUROC / average precision.

Counterpart of ``aa_clip_iqm_tpu/ops/metrics.py``: sklearn-parity metrics
(``roc_auc_score`` / ``average_precision_score``) that run on the device, so
the 518^2 x N pixel score tensors never travel to the host for ranking.

AUROC: Mann-Whitney U with midrank tie correction,
    AUC = sum over positives of (#negatives below + #negatives equal / 2)
          / (P * N_neg).
AP: (1/P) * sum over positives of precision at that element's score
    threshold (>= semantics), which collapses tie groups exactly like
    sklearn's step-function integral.

The JAX package sorts a whole class's pixels at once. ``torch.sort`` also
returns int64 indices, so a class of 10^9 pixels would need tens of GB for
that. Both statistics are sums, over the positives, of counts of negatives
below / at a score, and such counts add over chunks of the negatives. So
here the input is walked in chunks of at most ``chunk`` elements: the
positives are gathered and sorted once (P values); every chunk's negatives
are located among them by ``searchsorted`` and counted into two histograms
of P + 1 bins; two cumulative sums then give each positive its counts. Every
count is an integer, so the result does not depend on the chunk size. Memory
beyond the input: about 28 bytes per positive plus about 40 bytes per chunk
element (see ``DEFAULT_CHUNK``).
"""
from __future__ import annotations

import numpy as np
import torch

#: Elements ranked at a time: 2^24 (about 0.7 GB of temporaries).
DEFAULT_CHUNK = 1 << 24


def _rank_metrics_chunks(chunks, n_pad):
    """AUROC and AP of the (scores, labels) pairs that ``chunks()`` yields,
    each a flat float32 / bool tensor pair; it is called twice. ``n_pad``
    of the label-0 entries are padding with score -inf."""
    pos = torch.sort(torch.cat([s[l] for s, l in chunks()])).values
    p = pos.numel()
    dev = pos.device
    hist_lt = torch.zeros(p + 1, dtype=torch.int64, device=dev)
    hist_le = torch.zeros(p + 1, dtype=torch.int64, device=dev)
    n_neg = 0
    for s, l in chunks():
        neg = s[~l]
        n_neg += neg.numel()
        # Bin k of hist_lt: negatives with exactly k positives strictly
        # below them; of hist_le: with exactly k positives at or below.
        hist_lt += torch.bincount(torch.searchsorted(pos, neg, right=False),
                                  minlength=p + 1)
        hist_le += torch.bincount(torch.searchsorted(pos, neg, right=True),
                                  minlength=p + 1)
    # A negative n lies below positive v iff every positive <= n is < v, i.e.
    # its hist_le bin is at most first(v), the index where v's tie group
    # starts; n <= v iff its hist_lt bin is at most first(v).
    first = torch.searchsorted(pos, pos, right=False)
    neg_lt = torch.cumsum(hist_le, 0)[first]
    neg_le = torch.cumsum(hist_lt, 0)[first]
    pf = torch.tensor(float(p), dtype=torch.float64, device=dev)
    neg_valid = n_neg - n_pad
    # Padding sorts below every valid score: it is in neg_lt of each positive.
    u = (neg_lt.sum() - n_pad * p).double() + 0.5 * (neg_le - neg_lt).sum().double()
    auc = u / (pf * neg_valid)
    tp = (p - first).double()
    n_ge = tp + (n_neg - neg_lt).double()
    ap = (tp / n_ge).sum() / pf
    return auc, ap


def _rank_metrics(scores, labels, n_valid, chunk: int = DEFAULT_CHUNK):
    """AUROC + AP with optional padding.

    scores: (N,) float with padded entries = -inf; labels: (N,) {0,1} with
    padded entries = 0; n_valid: count of real entries. For any valid score
    v the count ``#(>= v)`` never includes a pad, and the pads below each
    positive are subtracted, which restores the exact unpadded statistics.
    Returns two float64 scalars on the scores' device."""
    scores = scores.reshape(-1).float()
    labels = labels.reshape(-1) > 0
    n = scores.numel()

    def chunks():
        for i in range(0, n, chunk):
            yield scores[i:i + chunk], labels[i:i + chunk]

    return _rank_metrics_chunks(chunks, n - n_valid)


def auroc(scores, labels):
    """scores: (N,) float; labels: (N,) {0,1}. Returns a float64 scalar."""
    return _rank_metrics(scores, labels, scores.numel())[0]


def average_precision(scores, labels):
    """sklearn average_precision_score parity."""
    return _rank_metrics(scores, labels, scores.numel())[1]


def auroc_ap(scores, labels):
    return _rank_metrics(scores, labels, scores.numel())


def _conditional_minmax_params(mx, mn):
    """(offset, divisor) of the reference's conditional min-max
    (forward_utils.py:246-253): identity when the raw max is exactly 1."""
    rng = mx - mn
    div = torch.where(rng == 0, torch.ones_like(rng), rng)
    keep = mx == 1.0
    return (torch.where(keep, torch.zeros_like(mn), mn),
            torch.where(keep, torch.ones_like(div), div))


def masked_conditional_minmax(x, valid_mask):
    """The reference's conditional min-max over the valid entries of a padded
    array: normalize to [0, 1] unless the raw max is exactly 1.0 (then pass
    through unchanged). ``valid_mask`` broadcasts against ``x``; padded
    entries get whatever the affine map produces (callers re-mask)."""
    x = x.float()
    inf = torch.tensor(float("inf"), device=x.device)
    mx = torch.where(valid_mask, x, -inf).max()
    mn = torch.where(valid_mask, x, inf).min()
    off, div = _conditional_minmax_params(mx, mn)
    return (x - off) / div


def pixel_metrics_device(maps, masks, valid, n_valid, chunk: int = DEFAULT_CHUNK):
    """Device-resident per-class pixel metrics + normalized image maxima.

    maps: (B, H, W) fused anomaly maps (padded rows allowed); masks:
    (B, H, W) bool ground truth; valid: (B,) bool row validity; n_valid:
    count of valid pixels (B_valid * H * W).

    Returns (pixel_auroc, pixel_ap, pmax (B,)) — pmax on the min-max
    normalized maps (the reference's image-score input). The maps are
    normalized and ranked ``chunk`` pixels (whole rows) at a time, so no
    second copy of the class is made; only scalars and a (B,) vector are
    left for the host."""
    b, h, w = maps.shape
    maps = maps.float()
    inf = torch.tensor(float("inf"), device=maps.device)
    mx = torch.where(valid, maps.amax(dim=(1, 2)), -inf).max()
    mn = torch.where(valid, maps.amin(dim=(1, 2)), inf).min()
    off, div = _conditional_minmax_params(mx, mn)
    # The normalization never decreases with its argument, so the maximum of
    # a normalized map is the normalized maximum.
    pmax = (maps.amax(dim=(1, 2)) - off) / div
    rows = max(1, chunk // (h * w))

    def chunks():
        for i in range(0, b, rows):
            v3 = valid[i:i + rows, None, None]
            pix = (maps[i:i + rows] - off) / div
            yield (torch.where(v3, pix, -inf).reshape(-1),
                   (masks[i:i + rows] & v3).reshape(-1))

    auc, ap = _rank_metrics_chunks(chunks, b * h * w - n_valid)
    return auc, ap, pmax


def minmax_normalize(x):
    """Reference min-max normalization (forward_utils.py:246-253), applied
    only when max(x) != 1."""
    x = np.asarray(x, dtype=np.float32)
    if x.max() != 1:
        rng = x.max() - x.min()
        x = (x - x.min()) / rng if rng else np.zeros_like(x)
    return x


def rank_metrics_host(scores, labels):
    """AUROC and AP on the host with numpy, from one sort and tie groups: the
    definitions written out, independent of the chunked device path."""
    scores = np.asarray(scores, np.float32).reshape(-1)
    labels = (np.asarray(labels).reshape(-1) > 0).astype(np.float64)
    order = np.argsort(scores, kind="stable")
    s, l = scores[order], labels[order]
    _, first, counts = np.unique(s, return_index=True, return_counts=True)
    pos_in_group = np.add.reduceat(l, first)
    p, n = l.sum(), l.size
    midrank = first + (counts + 1) / 2.0
    auc = ((pos_in_group * midrank).sum() - p * (p + 1) / 2.0) / (p * (n - p))
    tp = p - (np.cumsum(pos_in_group) - pos_in_group)
    ap = (pos_in_group * tp / (n - first)).sum() / p
    return float(auc), float(ap)


def metrics_eval_raw(pixel_label, image_label, pixel_preds, image_preds,
                     domain: str, use_device: bool = True, device="cuda"):
    """(pixel AUROC, pixel AP, image AUROC, image AP) of one class as plain
    floats in [0, 1], parity with forward_utils.py:233-308.

    pixel_label: (N,1,H,W) or (N,H,W); image_label: (N,); pixel_preds:
    (N,H,W) or (N,1,H,W); image_preds: (N,). With ``use_device`` the ranking
    runs through :func:`auroc_ap` on ``device`` (the card unless the caller
    passes ``"cpu"``, as JAX's ranks on its default device); without, through
    :func:`rank_metrics_host`. A class with one image label scores 0.0 at
    image level, as in the reference.
    """
    pixel_label = np.asarray(pixel_label)
    image_label = np.asarray(image_label)
    pixel_preds = minmax_normalize(pixel_preds)
    image_preds = minmax_normalize(image_preds)
    if pixel_preds.ndim == 4 and pixel_preds.shape[1] == 1:
        pixel_preds = pixel_preds[:, 0]
    if image_preds.ndim > 1:
        image_preds = image_preds.reshape(-1)

    pmax = pixel_preds.max(axis=(1, 2))
    if domain != "Medical":
        image_scores = pmax * 0.5 + image_preds * 0.5
    else:
        image_scores = pmax

    def rank(scores, labels):
        if not use_device:
            return rank_metrics_host(scores, labels)
        auc, ap = auroc_ap(torch.as_tensor(scores, device=device),
                           torch.as_tensor(labels, device=device))
        return float(auc), float(ap)

    pix_auc, pix_ap = rank(pixel_preds.reshape(-1),
                           (pixel_label.reshape(-1) != 0).astype(np.float32))
    if image_label.max() != image_label.min():
        img_auc, img_ap = rank(image_scores,
                               image_label.reshape(-1).astype(np.float32))
    else:
        img_auc, img_ap = 0.0, 0.0
    return pix_auc, pix_ap, img_auc, img_ap


def metrics_eval(pixel_label, image_label, pixel_preds, image_preds,
                 class_name: str, domain: str, use_device: bool = True,
                 device="cuda"):
    """Per-class metric dict: :func:`metrics_eval_raw` in the reference's
    round(x, 4) * 100 report format."""
    values = metrics_eval_raw(pixel_label, image_label, pixel_preds,
                              image_preds, domain, use_device, device)
    row = {"class name": class_name}
    for key, v in zip(("pixel AUC", "pixel AP", "image AUC", "image AP"), values):
        row[key] = round(v, 4) * 100
    return row
