"""Build and load the hand-written CUDA kernels in ``csrc/``.

Each ``csrc/<name>.cu`` (with the shared ``csrc/*.cuh`` headers) is compiled
on its own by ``nvcc`` into a shared library with a plain C interface,
``build/aa_clip_iqm_tpu_torch/lib<name>.so`` beside the package, and loaded
with ``ctypes``. A library is rebuilt when its source or a header is newer.
Nothing includes PyTorch's headers, so a build takes seconds.

Each C entry ``aaclip_<name>`` is declared once, at module level of the
wrapper that launches it, as an :class:`Entry`, the one way the port reaches
it: the entry loads its library on its first call, types its parameters
once, passes the current stream last, turns the returned
``cudaGetLastError()`` into an exception and counts the launch as
``launches.<name>`` (``utils.profiling``). :data:`ENTRIES` holds every
declaration, so that a test can hold each to its C signature.

Nothing here runs at import time: the CPU tests import every module, and
this machine need not have ``nvcc``.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Iterable, Optional, Sequence

from ..utils.profiling import count, counters, span

PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PACKAGE_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(PACKAGE_DIR), "build",
                         "aa_clip_iqm_tpu_torch")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()
#: Build log (nvcc's output, including -Xptxas -v) of the last build per kernel.
BUILD_LOGS: Dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.isfile(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def _paths(name: str):
    return (os.path.join(CSRC_DIR, name + ".cu"),
            os.path.join(BUILD_DIR, f"lib{name}.so"))


def _stale(name: str) -> bool:
    src, lib = _paths(name)
    if not os.path.isfile(lib):
        return True
    headers = [os.path.join(CSRC_DIR, f) for f in os.listdir(CSRC_DIR)
               if f.endswith(".cuh")]
    return max(os.path.getmtime(f) for f in [src, *headers]) > os.path.getmtime(lib)


def _tmp(name: str) -> str:
    return f"{_paths(name)[1]}.{os.getpid()}.tmp"


def _start(name: str) -> subprocess.Popen:
    os.makedirs(BUILD_DIR, exist_ok=True)
    return subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-o", _tmp(name), _paths(name)[0]],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)


def _finish(name: str, proc: subprocess.Popen) -> None:
    out, _ = proc.communicate()
    BUILD_LOGS[name] = out
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{out}")
    os.replace(_tmp(name), _paths(name)[1])


def _stop(procs: Dict[str, subprocess.Popen]) -> None:
    """Kill the builds still running and drop their partial libraries."""
    for name, proc in procs.items():
        if proc.poll() is None:
            proc.kill()
        proc.wait()
        if proc.stdout is not None:
            proc.stdout.close()
        try:
            os.remove(_tmp(name))
        except FileNotFoundError:
            pass


def build(names: Iterable[str]) -> Dict[str, float]:
    """Build the stale kernels among ``names``, one nvcc per source, all
    started together. Returns the wall seconds each build took (0.0 when
    the library was already up to date). If one build fails, the others
    are killed before the error is raised: no nvcc outlives the call."""
    names = list(names)
    t0 = time.perf_counter()
    with span("setup/kernels"):
        procs = {}
        seconds = {n: 0.0 for n in names}
        try:
            for n in names:
                if _stale(n):
                    procs[n] = _start(n)
            for n, proc in procs.items():
                _finish(n, proc)
                seconds[n] = time.perf_counter() - t0
        except BaseException:
            _stop(procs)
            raise
    if procs:
        count("kernels.builds", len(procs))
        count("kernels.build_s", time.perf_counter() - t0)
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if stale."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            with span("setup/kernels"):
                build([name])
                lib = ctypes.CDLL(_paths(name)[1])
                err_fn = getattr(lib, f"aaclip_{name}_error_string")
                err_fn.argtypes = [ctypes.c_int]
                err_fn.restype = ctypes.c_char_p
                _LIBS[name] = lib
            count("kernels.loads")
        return lib


#: Every declared C entry, by name (``aaclip_<name>`` in ``csrc/<lib>.cu``).
ENTRIES: Dict[str, "Entry"] = {}
#: The prefix of the launch counters.
LAUNCH_COUNTER = "launches."


class Entry:
    """The C entry ``aaclip_<name>`` of ``csrc/<lib>.cu``, whose parameters
    are ``argtypes`` and then the stream (``void*``), returning a CUDA error
    code. Calling it (``entry(device, *args)``) loads the library on the first
    call (:func:`load`), launches on ``device``'s current stream, raises
    ``RuntimeError`` on a nonzero code and counts ``launches.<counter>``,
    ``counter`` being ``name`` unless the call gives another."""

    def __init__(self, lib: str, name: str, argtypes: Sequence):
        self.lib, self.name = lib, name
        self.argtypes = [*argtypes, ctypes.c_void_p]
        self._fn = self._error_string = None
        ENTRIES[name] = self

    def _bind(self):
        lib = load(self.lib)
        fn = getattr(lib, "aaclip_" + self.name)
        fn.argtypes, fn.restype = self.argtypes, ctypes.c_int
        self._error_string = getattr(lib, f"aaclip_{self.lib}_error_string")
        self._fn = fn
        return fn

    def __call__(self, device, *args, counter: Optional[str] = None) -> None:
        err = (self._fn or self._bind())(*args, stream_ptr(device))
        if err:
            msg = self._error_string(err).decode(errors="replace")
            raise RuntimeError(f"aaclip_{self.name} launch failed: CUDA error {err} ({msg})")
        count(LAUNCH_COUNTER + (counter or self.name))


def launches(since: Optional[Dict[str, float]] = None) -> Dict[str, int]:
    """The launch counters as {name: launches}, less their values in the
    snapshot ``since`` (a :func:`..utils.profiling.counters` result); the
    counters that did not move are left out."""
    since = since or {}
    moved = {k[len(LAUNCH_COUNTER):]: int(v - since.get(k, 0))
             for k, v in counters().items() if k.startswith(LAUNCH_COUNTER)}
    return {k: v for k, v in moved.items() if v}


def stream_ptr(device) -> int:
    """The raw handle of PyTorch's current CUDA stream on ``device``."""
    import torch

    return torch.cuda.current_stream(device).cuda_stream
