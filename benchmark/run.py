#!/usr/bin/env python3
"""Run one cell of the benchmark once, on the CUDA devices of this machine.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds ``aa_clip_iqm_tpu_torch`` (the
PyTorch and CUDA program measured; nothing of the JAX package is imported).
``benchmark/workloads/<cell>.json`` names the configuration
(``benchmark/configs/<config>.json``), the driver
(``benchmark/drivers/<driver>.py``) and the traffic. The driver makes the
weights and inputs from ``--seed`` on the device, sets up the program and
warms up every shape the cell uses (``setup_s``), then measures for
``--seconds`` (``--trace 1``: under ``torch.profiler``, and the per-layer
metrics of ``BENCHMARK.json`` that list the cell, each read by
``benchmark/metrics/<name>.py``). After the window it reads the peak
memory, frees the program's state and holds what the window produced to
the plain float32 reference (``benchmark/reference/``). The last line of
standard output is one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics``, ``device``, with ``--trace 1`` ``breakdown``, and last
``checks``, each compared number beside its limit (also the last lines of
standard error).

It exits with 2, and prints no result, without a CUDA device or with fewer
than the cell asks for, and with 3 if the JAX package, ``jax``, ``jaxlib``
or ``flax`` was imported.
"""
import os
import sys
import time

T0 = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# The checkout's root, not this folder, is where imports start.
sys.path[0] = ROOT

# Every cache of the program and its libraries stays at a fixed place in
# the checkout (nvcc's output already does: build/aa_clip_iqm_tpu_torch).
for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ[var] = os.path.join(ROOT, "build", "benchmark", sub)
os.environ["USE_FLAX"] = "0"

from benchmark import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], T0))
