"""Tracing and profiling, the counterpart of
``aa_clip_iqm_tpu/utils/profiling.py`` with the same names:

  - ``trace(log_dir)``: a ``torch.profiler`` trace (host and CUDA activity)
    written as a Chrome trace under ``log_dir``
    (``tools/trace_summary.py`` summarises it);
  - ``step_annotation(name)``: a named range in that trace;
  - ``StepTimer``: step times with a device synchronise;
  - ``enable_nan_checks``: the counterpart of ``jax_debug_nans``, raising
    ``FloatingPointError`` at the first op whose floating output holds a NaN.
"""
from __future__ import annotations

import contextlib
import os
import socket
import time
from typing import Optional

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ..models.convert import tree_leaves


@contextlib.contextmanager
def trace(log_dir: Optional[str]):
    """Profile the block with ``torch.profiler`` (CPU activity, and CUDA
    activity where the card is there) and write the Chrome trace
    ``<log_dir>/<host>.<pid>.<ms>.pt.trace.json``, the file name torch's
    TensorBoard handler gives. No-op when ``log_dir`` is None or empty."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        try:
            yield
        finally:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    name = f"{socket.gethostname()}.{os.getpid()}.{int(time.time() * 1e3)}.pt.trace.json"
    prof.export_chrome_trace(os.path.join(log_dir, name))


def step_annotation(name: str):
    """A named range in the profiler's timeline (``record_function``)."""
    return torch.profiler.record_function(name)


def _tensors(tree):
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def sync(tree) -> None:
    """Wait for the work that produces the tensors of ``tree`` (nested dicts,
    lists and tuples): synchronise each CUDA device they lie on."""
    for dev in {t.device for t in _tensors(tree) if t.is_cuda}:
        torch.cuda.synchronize(dev)


class StepTimer:
    """Running mean / percentile step timer with a device synchronise."""

    def __init__(self):
        self.samples = []
        self._t0 = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self, outputs=None) -> float:
        if outputs is not None:
            sync(outputs)
        dt = time.perf_counter() - self._t0
        self.samples.append(dt)
        return dt

    def summary(self) -> dict:
        if not self.samples:
            return {}
        arr = np.asarray(self.samples)
        return {
            "steps": len(arr),
            "mean_s": float(arr.mean()),
            "p50_s": float(np.percentile(arr, 50)),
            "p95_s": float(np.percentile(arr, 95)),
        }


# Ops not checked: those whose output is uninitialised memory, which a
# kernel fills afterwards, and the tensor literal (torch.tensor), which makes
# nothing: data entering the program is checked where an op first uses it.
_UNCHECKED = {torch.ops.aten.empty, torch.ops.aten.empty_like,
              torch.ops.aten.empty_strided, torch.ops.aten.new_empty,
              torch.ops.aten.new_empty_strided, torch.ops.aten.lift_fresh}


class _NanChecks(TorchDispatchMode):
    """Check every floating output of every op that passes the dispatcher,
    forward and backward (the ``aaclip::`` kernel ops included), and raise
    ``FloatingPointError`` naming the first op that made a NaN. The check
    reads the result on the host, so it synchronises at every op."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.overloadpacket not in _UNCHECKED:
            for t in _tensors(out):
                if t.is_floating_point() and bool(torch.isnan(t).any()):
                    raise FloatingPointError(
                        f"NaN in the output of {func} (enable_nan_checks)")
        return out


_NAN_MODE: Optional[_NanChecks] = None


def enable_nan_checks(enable: bool = True):
    """The counterpart of ``jax_debug_nans``: with ``enable``, every op run
    on this thread, and in the backward passes it starts, raises
    ``FloatingPointError`` at the first floating output holding a NaN, and
    autograd's anomaly mode records each backward node's forward origin.
    ``enable_nan_checks(False)`` turns both off again, from the thread that
    turned them on. The checks synchronise at every op, so they cannot run
    inside a CUDA graph capture: while they are on,
    :class:`..serving.AnomalyDetector` runs its eager program instead of its
    graphs."""
    global _NAN_MODE
    if enable and _NAN_MODE is None:
        _NAN_MODE = _NanChecks()
        _NAN_MODE.__enter__()
    elif not enable and _NAN_MODE is not None:
        mode, _NAN_MODE = _NAN_MODE, None
        mode.__exit__(None, None, None)
    torch.autograd.set_detect_anomaly(enable)


def nan_checks_enabled() -> bool:
    return _NAN_MODE is not None
