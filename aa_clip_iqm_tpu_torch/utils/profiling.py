"""Tracing, counters and NaN checks, the counterpart of
``aa_clip_iqm_tpu/utils/profiling.py``:

  - ``trace(log_dir)``: a ``torch.profiler`` trace (host and CUDA activity)
    written as a Chrome trace under ``log_dir``
    (``tools/trace_summary.py`` summarises it);
  - ``span(name)``: the program's one way to name a range of its host work,
    ``aaclip/<name>`` in the profiler's timeline, on the clock of the
    device's events; it costs a gate check when no profiler runs;
  - ``count(name, n)``, ``timed(name)``, ``counters()``,
    ``reset_counters()``: the program's counters, sums kept by name in this
    process, always on and safe under threads;
  - ``enable_nan_checks``: the counterpart of ``jax_debug_nans``, raising
    ``FloatingPointError`` at the first op whose floating output holds a NaN.

The spans and counters the program keeps:

============================  ==============================================
span ``aaclip/...``           where
============================  ==============================================
``predict``                   ``serving.AnomalyDetector.predict`` /
                              ``predict_multi``, the caller's call; its
                              children ``predict/stage`` (padding, the
                              anchors' gather, ``from_numpy``),
                              ``predict/copy_in``, ``predict/replay`` (or
                              ``predict/run``, the eager program) and
                              ``predict/copy_out`` (the maps and scores to
                              host memory, page-locked on the card)
``step``                      ``train.graphs.GraphedStep.__call__``; its
                              children ``step/prepare``, ``step/copy_in``,
                              ``step/replay``, ``step/advance``
``capture``                   a CUDA graph's warm-up and capture
``serve/dispatch``            one device batch of ``MicroBatchingService``
``setup/anchors``             ``prompts.compute_frozen_anchors``
``setup/kernels``             ``ops._build``: nvcc runs and library loads
``setup/rope``                ``ops.rope.rope_table``: an EVA-02 tower's
                              rotary table made for a grid (once per grid)
============================  ==============================================

Counters: ``predict.calls`` (device batches), ``predict.rows``,
``predict.padded_rows``, ``predict.bytes_in`` / ``predict.bytes_out`` (the
bytes between host and device memory), ``predict.copy_out_pinned`` (device
batches copied out into page-locked host memory, the graphed path's
copy-out), ``predict.pinned_allocs`` (page-locked blocks that copy-out had
to create rather than reuse from PyTorch's caching host allocator),
``step.calls``, ``graphs.captures``, ``graphs.capture_s``,
``setup.anchors_s``, ``kernels.builds`` (nvcc runs), ``kernels.build_s``,
``kernels.loads``, ``serve.requests``, ``serve.batches``,
``serve.queue_wait_s``, ``http.decode_s``, ``http.encode_s``; for an
EVA-02 vision tower ``rope.tables`` (rotary tables made), ``blocks.eva02``
(EVA-02 blocks run) and ``mlp.swiglu_fused`` / ``mlp.swiglu_chain`` (its MLP
halves run on ``ln_swiglu_residual``, or on the stock chain: ``use_pallas=
False`` or under autograd); for a post-norm EVA tower ``blocks.eva_postnorm``
(its blocks run) and ``postnorm.fused`` / ``postnorm.chain`` (one per block
half under ``use_pallas``: on the block's kernels, or on the chain where
autograd records the call); for a SigLIP vision tower ``blocks.siglip`` (its
blocks run), ``siglip.fused`` / ``siglip.chain`` (one per block half under
``use_pallas``, as ``postnorm.*``) and ``pool.map`` (attention-pool head
calls); for every
unmasked vision block off the stock
route (``use_pallas``) ``attn.proj_fused`` / ``attn.proj_chain`` (its attention
half's LayerNorm and projections run on B8's front and back kernels, or on the
chain); ``launches.<name>`` for each hand-written kernel's C entry
``aaclip_<name>`` (``ops._build.Entry``; B4 and B6 share one entry, counted
``launches.packed_attention_bwd`` and ``launches.packed_attention_vv_bwd``);
``gemm.grouped`` for the bf16 GEMM core's launches whose tiles go in bands
of M-tiles (``ops.gemm.tile_group``'s choice: EVA02-CLIP-E/14+'s W1, 64 a
forward). These counters count Python calls, so in a CUDA graph they count the
warm-up and the capture, not the replays.
``cli.serve`` answers ``GET /v1/stats`` with them.
"""
from __future__ import annotations

import contextlib
import os
import socket
import threading
import time
from typing import Dict, Optional

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


#: The prefix of the program's ranges in a profiler's timeline.
SPAN_PREFIX = "aaclip/"
_NULL_SPAN = contextlib.nullcontext()
_profiler_enabled = torch._C._autograd._profiler_enabled


def span(name: str):
    """A range ``aaclip/<name>`` in the profiler's timeline
    (``record_function``) while a profiler runs; otherwise one shared null
    context, so that a span costs the gate check alone."""
    if _profiler_enabled():
        return torch.profiler.record_function(SPAN_PREFIX + name)
    return _NULL_SPAN


_COUNTS: Dict[str, float] = {}
_COUNTS_LOCK = threading.Lock()


def count(name: str, n=1) -> None:
    """Add ``n`` (an int or a float) to the counter ``name``."""
    with _COUNTS_LOCK:
        _COUNTS[name] = _COUNTS.get(name, 0) + n


@contextlib.contextmanager
def timed(name: str):
    """Add the block's wall seconds to the counter ``name``."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        count(name, time.perf_counter() - t0)


def counters() -> Dict[str, float]:
    """A snapshot of every counter: {name: sum}."""
    with _COUNTS_LOCK:
        return dict(_COUNTS)


def reset_counters() -> None:
    with _COUNTS_LOCK:
        _COUNTS.clear()


def _tensors(tree):
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


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
