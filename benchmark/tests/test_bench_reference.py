"""The plain reference against the program at its tiny size on the CPU, in
float32: anchors, the positional-embedding resize, maps and scores through
the offline driver, and stage-2 steps through the training driver."""
import numpy as np
import pytest
import torch

from benchmark.drivers import common
from benchmark.reference import model as ref
from benchmark.tests.tiny import tiny_run

OFFLINE = {"batch": 2, "pool": 2, "sample": 3, "reference_chunk": 2, "reference_head_chunk": 1,
           "limits": {"anchor_err": 1e-5, "map_rel_rms": 1e-4, "score_abs": 1e-5}}


@pytest.fixture(scope="module")
def offline():
    d = tiny_run("offline", OFFLINE)
    d.setup()
    d.window(0.0)
    d.window(0.0)
    return d


def test_anchors_match_program(offline):
    got = ref.text_anchors(offline.frozen, offline.trainable, offline.run.config, "cpu")
    assert set(got) == set(offline.det.anchors)
    for c, a in got.items():
        torch.testing.assert_close(a, offline.det.anchors[c].float(), rtol=0, atol=2e-6)


def test_pos_embed_resize_matches_program(offline):
    pos = offline.frozen["visual"]["positional_embedding"]
    prog = common.program_frozen(offline.frozen, 4)["visual"]["positional_embedding"]
    torch.testing.assert_close(ref.resize_pos_embed(pos, 4), prog, rtol=0, atol=1e-6)
    assert pos.shape[0] == 10 and prog.shape[0] == 17


def test_maps_and_scores_match_program(offline):
    checks = dict((n, v) for n, v, _ in offline.check())
    assert checks["map_rel_rms"] < 1e-4
    assert checks["score_abs"] < 1e-5
    assert all(v <= lim for _, v, lim in offline.check())


def test_check_fails_an_altered_map(offline):
    k, r, m, s = offline.kept[0]
    offline.kept[0] = (k, r, m * 1.05, s)
    try:
        checks = dict((n, (v, lim)) for n, v, lim in offline.check())
    finally:
        offline.kept[0] = (k, r, m, s)
    v, lim = checks["map_rel_rms"]
    assert v > lim


def test_inputs_repeat_from_the_seed():
    a, b = tiny_run("offline", OFFLINE, seed=2**31 + 7), tiny_run("offline", OFFLINE,
                                                                   seed=2**31 + 7)
    for d in (a, b):
        d.setup()
    np.testing.assert_array_equal(a.pool[0], b.pool[0])
    assert a.names == b.names
    for x, y in zip(a.frozen["visual"]["blocks"][0]["mlp"]["c_fc"].values(),
                    b.frozen["visual"]["blocks"][0]["mlp"]["c_fc"].values()):
        assert torch.equal(x, y)


def test_fp8_anchor_control_fails_the_anchors(offline):
    offline.wl["control"] = "fp8_anchors"
    try:
        r = offline.readings()
    finally:
        del offline.wl["control"]
    assert r["anchor_err"] > 1e3 * offline.readings()["anchor_err"]


def test_int8_control_fails_the_maps():
    d = tiny_run("offline", dict(OFFLINE, quantize="int8"))
    d.setup()
    d.window(0.0)
    d.window(0.0)
    d.release()
    r = d.readings()
    assert r["map_rel_rms"] > OFFLINE["limits"]["map_rel_rms"]


def test_fp8_reference_control_fails_the_training_numbers():
    from benchmark.tests.test_bench_faults import TRAIN

    d = tiny_run("train", dict(TRAIN, control="fp8_reference"))
    d.setup()
    d.window(0.0)
    d.release()
    r = d.readings()
    assert r["grad_rel"] > TRAIN["limits"]["grad_rel"]
