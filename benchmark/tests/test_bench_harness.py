"""The harness end to end at the tiny size on the CPU (the card's place taken
by the CPU through ``harness.main``'s rehearsal arguments): the result line
holds the contract's keys, the metrics the cell lists, and the compared
numbers last, also as the last lines of standard error; without a card the
command prints nothing and exits 2."""
import json
import os
import subprocess
import sys
import time

import pytest
import torch

from benchmark import harness, inputs
from benchmark.tests.tiny import tiny_config

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SMALL = {"batch": 2, "pool": 2, "sample": 3, "reference_chunk": 2, "kernels": [],
         "limits": {"anchor_err": 1e-5, "map_rel_rms": 1e-4, "score_abs": 1e-5}}


@pytest.mark.parametrize("trace", ["0", "1"])
def test_result_line(capsys, trace):
    wl = dict(inputs.load_json("workloads", "offline-518-b32"), **SMALL)
    rc = harness.main(["--workload", "offline-518-b32", "--seed", str(2 ** 31 + 3),
                       "--seconds", "0.3", "--trace", trace], time.perf_counter(),
                      device=torch.device("cpu"), config=tiny_config(), workload=wl)
    out, err = capsys.readouterr()
    assert rc == 0
    line = json.loads(out.strip().splitlines()[-1])
    assert list(line)[:3] == ["correct", "attempted", "failed"] and list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
    assert set(line["checks"]) == set(SMALL["limits"])
    assert err.strip().splitlines()[-1].startswith("check score_abs:")
    if trace == "0":
        assert set(line["metrics"]) == {"images_per_s", "setup_s"}
    else:
        assert "breakdown" in line and line["device"]["window_s"] > 0
        assert set(line["metrics"]) <= {"mfu.infer", "attn_fwd_roofline", "mlp_fwd_roofline",
                                        "device_idle.offline"}
        assert "mfu.infer" in line["metrics"]


def test_command_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    res = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "offline-518-b32",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 2 and res.stdout == ""
