"""Seeding and logging helpers (``aa_clip_iqm_tpu/utils/misc.py``)."""
from __future__ import annotations

import logging
import os
import random

import numpy as np
import torch


def setup_seed(seed: int):
    """Seed the host generators and PyTorch's."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    os.environ["PYTHONHASHSEED"] = str(seed)


def quiet_logger(name: str) -> logging.Logger:
    """A logger that writes nothing: a data-parallel run's ranks other than
    rank 0, which alone logs and writes."""
    logger = logging.getLogger(f"aa_clip_iqm_tpu_torch.quiet.{name}")
    logger.handlers.clear()
    logger.addHandler(logging.NullHandler())
    logger.propagate = False
    return logger


def setup_logger(save_path: str, filename: str) -> logging.Logger:
    """A logger that writes to ``save_path/filename`` and to the console."""
    os.makedirs(save_path, exist_ok=True)
    logger = logging.getLogger(f"aa_clip_iqm_tpu_torch.{filename}")
    logger.setLevel(logging.INFO)
    logger.handlers.clear()
    fh = logging.FileHandler(os.path.join(save_path, filename), encoding="utf-8")
    fh.setFormatter(logging.Formatter("%(asctime)s %(levelname)s %(message)s"))
    logger.addHandler(fh)
    sh = logging.StreamHandler()
    sh.setFormatter(logging.Formatter("%(message)s"))
    logger.addHandler(sh)
    return logger
