"""On the card: the 518 px comparison of a short offline run, and of a
stage-2 run, at the cells' own sizes and limits. Skips without a CUDA
device (decided in the ``card`` fixture)."""
import json
import os

import pytest

from benchmark import inputs
from benchmark.harness import Run, load_module, log


def run_cell(device, name, seconds):
    with open(os.path.join(os.path.dirname(inputs.HERE), "BENCHMARK.json")) as f:
        cell = next(w for w in json.load(f)["workloads"] if w["name"] == name)
    wl = inputs.load_json("workloads", name)
    run = Run(workload=wl, config=inputs.load_json("configs", cell["config"]), cell=cell,
              seed=2 ** 31 + 11, seconds=seconds, trace=False, device=device, log=log)
    d = load_module("drivers", wl["driver"]).Driver(run)
    d.setup()
    d.window(seconds)
    d.release()
    return d.check()


@pytest.mark.cuda
@pytest.mark.parametrize("name,seconds", [("offline-518-b32", 5.0), ("train-s2-518-b8", 1.0)])
def test_cell_comparison_on_the_card(card, name, seconds):
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    checks = run_cell(card, name, seconds)
    assert all(v <= lim for _, v, lim in checks), checks
