"""A run of a driver on the CPU at the program's tiny test size."""
from __future__ import annotations

import json
import os
import sys

import torch

from benchmark.harness import Run, load_module

HERE = os.path.dirname(os.path.abspath(__file__))


def tiny_config(**over) -> dict:
    with open(os.path.join(HERE, "tiny.json")) as f:
        cfg = json.load(f)
    cfg.update(over)
    return cfg


def tiny_run(driver: str, workload: dict, seed: int = 5, **config) -> object:
    """The driver's ``Driver`` on a ``Run`` at the tiny size on the CPU."""
    run = Run(workload=dict(workload, driver=driver, kernels=[]), config=tiny_config(**config),
              cell={"name": "tiny", "chips": 1}, seed=seed, seconds=0.0, trace=False,
              device=torch.device("cpu"), log=lambda msg: print(f"# {msg}", file=sys.stderr))
    return load_module("drivers", driver).Driver(run)
