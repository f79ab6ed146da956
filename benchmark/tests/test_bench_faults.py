"""The rest of a run with the timed path broken underneath: the comparison
must come out not correct. At the tiny size on the CPU, float32, with
limits of that size; the harness's look for a card is skipped (the drivers
are driven directly, as the harness drives them)."""
import contextlib
import json

import numpy as np
import pytest
import torch

from benchmark.tests.tiny import tiny_run

OFFLINE = {"batch": 2, "pool": 2, "sample": 3, "reference_chunk": 2, "reference_head_chunk": 1,
           "limits": {"anchor_err": 1e-5, "map_rel_rms": 1e-4, "score_abs": 1e-5}}
HTTP = {"buckets": [1, 2, 4], "max_batch": 4, "max_latency_ms": 5, "rate": 20.0,
        "native_sizes": {c: 70 for c in ("bottle", "cable", "capsule", "carpet", "grid",
                                         "hazelnut", "leather", "metal_nut", "pill", "screw",
                                         "tile", "toothbrush", "transistor", "wood", "zipper")},
        "bodies_per_class": 1, "client_threads": 8, "timeout_s": 30, "sample": 4,
        "reference_chunk": 2, "reference_head_chunk": 1,
        "limits": {"anchor_err": 1e-5, "map_rel_rms": 0.1, "score_abs": 1e-3}}
TRAIN = {"batch": 2, "pool": 4, "limits": {"loss_rel": 1e-4, "grad_rel": 1e-4, "change_rel": 1e-3}}


def correct(driver, seconds=0.0):
    driver.setup()
    driver.window(seconds)
    driver.release()
    checks = driver.check()
    return all(v <= lim for _, v, lim in checks), checks


def test_sound_runs_are_correct():
    ok, checks = correct(tiny_run("offline", OFFLINE))
    assert ok, checks
    ok, checks = correct(tiny_run("train", TRAIN))
    assert ok, checks


def test_offline_answer_altered_where_produced(monkeypatch):
    from aa_clip_iqm_tpu_torch.serving import AnomalyDetector

    real = AnomalyDetector.predict_multi

    def altered(self, images, names):
        maps, scores = real(self, images, names)
        return maps[::-1].copy(), scores       # each image gets another's map
    monkeypatch.setattr(AnomalyDetector, "predict_multi", altered)
    ok, checks = correct(tiny_run("offline", OFFLINE))
    assert not ok, checks


def test_offline_half_batch_left_out(monkeypatch):
    from aa_clip_iqm_tpu_torch.serving import AnomalyDetector

    real = AnomalyDetector.predict_multi

    def half(self, images, names):
        h = len(names) // 2
        maps, scores = real(self, images[:h], names[:h])
        return np.concatenate([maps, maps]), np.concatenate([scores, scores])
    monkeypatch.setattr(AnomalyDetector, "predict_multi", half)
    ok, checks = correct(tiny_run("offline", dict(OFFLINE, sample=4)))
    assert not ok, checks


def test_http_answer_altered_where_produced(monkeypatch):
    from aa_clip_iqm_tpu_torch.cli import serve

    real = serve._b64_npy
    monkeypatch.setattr(serve, "_b64_npy", lambda arr: real(np.asarray(arr) * 1.5 + 0.1))
    ok, checks = correct(tiny_run("http", HTTP), seconds=0.5)
    assert not ok, checks


def test_http_sound_run_is_correct():
    ok, checks = correct(tiny_run("http", HTTP), seconds=0.5)
    assert ok, checks


@contextlib.contextmanager
def broken_stage2(monkeypatch, kind):
    from aa_clip_iqm_tpu_torch.train import steps

    real = steps.make_stage2_step

    def make(*args, **kwargs):
        s = real(*args, **kwargs)

        def update(trainable, opt, frozen, images, masks, labels, anchors, weights, rng=None):
            if kind == "half_batch":
                h = images.shape[0] // 2
                return s.update(trainable, opt, frozen, images[:h], masks[:h], labels[:h],
                                anchors[:h], weights[:h], rng)
            # Unchanged: the step's parameters and moments are put back.
            params = [p for g in opt.optimizer.param_groups for p in g["params"]]
            saved = [p.detach().clone() for p in params]
            loss = s.update(trainable, opt, frozen, images, masks, labels, anchors, weights, rng)
            with torch.no_grad():
                for p, v in zip(params, saved):
                    p.copy_(v)
                    opt.optimizer.state[p]["exp_avg"].zero_()
            return loss

        def step(trainable, opt, frozen, *batch):
            loss = update(trainable, opt, frozen, *batch)
            opt.advance()
            return trainable, opt, loss

        step.update, step.loss_fn, step.keep_indices = update, s.loss_fn, s.keep_indices
        return step

    monkeypatch.setattr(steps, "make_stage2_step", make)
    yield


@pytest.mark.parametrize("kind", ["half_batch", "unchanged"])
def test_train_faults(monkeypatch, kind):
    with broken_stage2(monkeypatch, kind):
        ok, checks = correct(tiny_run("train", TRAIN))
    assert not ok, json.dumps(checks)
