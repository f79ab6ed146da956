"""Multi-process runs: the runtime, which rows a rank loads, and where.

Counterpart of ``aa_clip_iqm_tpu/parallel/multihost.py``. One process runs
per card (``torchrun --nproc_per_node N``, across nodes with
``--nnodes``), and three things make a run of many:

  1. the runtime: ``torch.distributed.init_process_group`` before the first
     collective (:func:`maybe_initialize`, opt-in through
     ``AACLIP_MULTIHOST=1`` or explicit arguments);
  2. a data contract: the rows of the global batch each rank loads
     (:func:`process_local_rows`);
  3. putting those rows on the rank's card (:func:`global_device_batch`).

A single process without a process group degrades to plain device copies
of the whole batch.
"""
from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch


def local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", "0"))


def local_device() -> torch.device:
    """The device this rank computes on: ``cuda:LOCAL_RANK`` where there is
    a card and the caller has not asked for the CPU (``AACLIP_PLATFORM=cpu``),
    else the CPU."""
    from ..platform import PLATFORMS, platform_name

    if PLATFORMS[platform_name()] == "cuda" and torch.cuda.is_available():
        return torch.device("cuda", local_rank())
    return torch.device("cpu")


def maybe_initialize(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     backend: Optional[str] = None) -> bool:
    """Initialize the process group of a multi-process run.

    Opt-in, as JAX's: it runs when called with explicit arguments
    (``coordinator_address`` "host:port" or a ``tcp://`` / ``file://`` URL,
    with ``num_processes`` and ``process_id``), or when
    ``AACLIP_MULTIHOST=1`` with torchrun's environment (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` / ``MASTER_PORT``).
    ``backend``, the port's own argument (torch must be told it, JAX need
    not be): NCCL where the rank computes on a card, gloo on the CPU. A rank
    on a card takes ``cuda:LOCAL_RANK`` as its current device. Returns True
    only when it initialized; called again, or without opt-in, it does
    nothing and returns False."""
    dist = torch.distributed
    explicit = coordinator_address is not None
    if not explicit and os.environ.get("AACLIP_MULTIHOST") != "1":
        return False
    if dist.is_initialized():
        return False
    device = local_device()
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if explicit:
        url = coordinator_address
        if "://" not in url:
            url = f"tcp://{url}"
        dist.init_process_group(backend, init_method=url, world_size=int(num_processes),
                                rank=int(process_id))
    else:
        dist.init_process_group(backend)
    return True


def launched() -> bool:
    """Whether a launcher (torchrun) started this process as one rank of a
    run: its environment names the rank and the world size."""
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def data_parallel_mesh(device: str):
    """The mesh of a CLI's ``--data_parallel``, and the device the rank
    computes on. Under a launcher the process joins its process group (NCCL
    for ``device`` "cuda", gloo for "cpu") and every rank goes on the data
    axis, each on ``cuda:LOCAL_RANK``; a single process without one gets
    (None, ``device``): the flag changes nothing there, as JAX's does with
    one device."""
    dist = torch.distributed
    if not (dist.is_initialized() or launched()):
        return None, device
    kind = torch.device(device).type
    if not dist.is_initialized():
        maybe_initialize(f"{os.environ.get('MASTER_ADDR', 'localhost')}:"
                         f"{os.environ['MASTER_PORT']}", int(os.environ["WORLD_SIZE"]),
                         int(os.environ["RANK"]), backend="nccl" if kind == "cuda" else "gloo")
    from .mesh import make_mesh

    device = torch.device("cuda", local_rank()) if kind == "cuda" else torch.device("cpu")
    return make_mesh(device=device), str(device)


def is_primary() -> bool:
    """Whether this process is rank 0 (or the only one): the rank that logs
    and writes checkpoints."""
    dist = torch.distributed
    return not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0


def process_local_rows(mesh, global_batch: int, rank: Optional[int] = None) -> Tuple[int, int]:
    """Row range [start, stop) of the global batch that ``rank`` (this
    process by default) must load.

    The batch splits into equal blocks over the mesh's data axes
    ('replica' outermost); 'model'-axis peers share their block. Raises if
    the batch does not split evenly, or if the rank's cells (a rank placed
    at more than one data position) hold rows that are not one contiguous
    block: feeding such a layout from per-rank loaders would interleave rows
    and train on the wrong data."""
    rank = mesh.rank if rank is None else rank
    n = mesh.data_size
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} does not split over the "
                         f"{n} data-parallel ranks")
    per = global_batch // n
    blocks = set()
    for cell in np.argwhere(mesh.devices == rank):
        c = dict(zip(mesh.axis_names, (int(i) for i in cell)))
        index = 0
        for a in mesh.data_axes:
            index = index * mesh.shape[a] + c[a]
        blocks.add((index * per, (index + 1) * per))
    if not blocks:
        raise ValueError(f"rank {rank} is not in the mesh")
    lo = min(s for s, _ in blocks)
    hi = max(e for _, e in blocks)
    if sum(e - s for s, e in blocks) != hi - lo:
        raise ValueError(
            f"rank {rank}'s batch rows are not contiguous: {sorted(blocks)}; build the "
            "mesh with each rank at one data position (parallel/mesh.py)")
    return lo, hi


def global_device_batch(mesh, local_batch: dict, global_batch: int) -> dict:
    """This rank's rows (:func:`process_local_rows`) of each array leaf of
    ``local_batch``, put on the mesh's device; non-array leaves (class-name
    lists) pass through. Where torch has no global array, the rank's rows
    are its share of the batch; the steps and the predict program know the
    global size from the mesh. A leaf with the global batch's rows (a single
    process) is cut to the rank's."""
    lo, hi = process_local_rows(mesh, global_batch)

    def put(x):
        if not getattr(x, "ndim", 0):
            return x
        if x.shape[0] == global_batch and hi - lo != global_batch:
            x = x[lo:hi]
        if x.shape[0] != hi - lo:
            raise ValueError(f"a leaf of {x.shape[0]} rows, where rank {mesh.rank} "
                             f"holds rows [{lo}, {hi}) of {global_batch}")
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(np.ascontiguousarray(x))
        return x.to(mesh.device)

    return {k: put(v) for k, v in local_batch.items()}
