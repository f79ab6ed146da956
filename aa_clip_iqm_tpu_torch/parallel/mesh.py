"""Process meshes and shardings on ``torch.distributed``.

Counterpart of ``aa_clip_iqm_tpu/parallel/mesh.py``. Where the JAX package
names a grid of devices and lets GSPMD insert the collectives, the port runs
one process per card (``torchrun``) and makes each collective itself:

  - a ('data', 'model') mesh, or ('replica', 'data', 'model') across nodes,
    is a grid of process ranks (:class:`Mesh`);
  - the batch axis is split over the data axes ('replica' and 'data'): each
    rank runs its own contiguous block of rows
    (``multihost.process_local_rows``), and the training steps sum the
    gradients over those ranks (``train/steps.py``);
  - the backbone's attention heads and MLP hidden units are split over
    'model' (Megatron tensor parallelism, :func:`shard_backbone`): the
    blocks of ``models/clip.py`` then run on the rank's shard and sum the
    row-split products over the 'model' ranks
    (``parallel/collectives.py``);
  - everything else is replicated.

A mesh's layout is a numpy array of ranks and can be built and read without
processes (``devices=`` a list of ranks). Its process groups are made when a
process group is live, by every rank in the same order, as
``torch.distributed.new_group`` requires.
"""
from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np
import torch

DATA_AXES = ("replica", "data")


class P(tuple):
    """A partition spec, as ``jax.sharding.PartitionSpec``: one entry per
    tensor dimension, None (replicated), an axis name or a tuple of them."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"P{tuple(self)!r}"


class Mesh:
    """A named grid of process ranks.

    ``devices``: the ranks, one per cell, in an array of the mesh's shape
    (JAX's name, where the cells are devices). ``shape``: {axis: size}.
    ``rank``: this process's rank (without a process group, the first
    cell's, unless given). The process
    groups over the data axes and over 'model' that contain this rank are
    :attr:`data_group` and :attr:`model_group`; both are None where no
    process group is live, and a collective over None is the identity.
    ``device``: the torch device this rank computes on."""

    def __init__(self, devices, axis_names: Sequence[str], rank: Optional[int] = None,
                 device=None, make_groups: bool = True):
        self.devices = np.asarray(devices, dtype=np.int64)
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"mesh of shape {self.devices.shape} for axes {self.axis_names}")
        if len(set(self.devices.ravel().tolist())) != self.devices.size:
            raise ValueError(f"a rank appears twice in the mesh {self.devices.tolist()}")
        self.shape = dict(zip(self.axis_names, self.devices.shape))
        live = _live()
        self.rank = int(rank) if rank is not None else (
            torch.distributed.get_rank() if live else int(self.devices.ravel()[0]))
        if device is None:
            from .multihost import local_device

            device = local_device()
        self.device = torch.device(device)
        self.data_group = self.model_group = None
        self.backend = None
        if live and make_groups:
            self.backend = torch.distributed.get_backend()
            self.data_group = self._groups(self.data_axes)
            self.model_group = self._groups(("model",) if "model" in self.shape else ())

    # -- layout -----------------------------------------------------------

    @property
    def data_axes(self):
        return tuple(a for a in self.axis_names if a in DATA_AXES)

    @property
    def data_size(self) -> int:
        """Ranks a batch is split over: the product of the data axes."""
        return int(np.prod([self.shape[a] for a in self.data_axes], dtype=np.int64))

    @property
    def n_model(self) -> int:
        return int(self.shape.get("model", 1))

    def coords(self, rank: Optional[int] = None) -> dict:
        """{axis: index} of ``rank``'s cell (this process's by default)."""
        rank = self.rank if rank is None else rank
        where = np.argwhere(self.devices == rank)
        if not len(where):
            raise ValueError(f"rank {rank} is not in the mesh {self.devices.tolist()}")
        return dict(zip(self.axis_names, (int(i) for i in where[0])))

    def data_index(self, rank: Optional[int] = None) -> int:
        """The position of ``rank``'s rows among the data axes' blocks,
        replica-major (the outer axis first)."""
        c = self.coords(rank)
        index = 0
        for a in self.data_axes:
            index = index * self.shape[a] + c[a]
        return index

    def group_ranks(self, axes, rank: Optional[int] = None):
        """The ranks that share ``rank``'s coordinates on every axis but
        ``axes``, ordered by their position along ``axes``."""
        c = self.coords(rank)
        index = tuple(slice(None) if a in axes else c[a] for a in self.axis_names)
        return [int(r) for r in self.devices[index].ravel()]

    @property
    def graphable(self) -> bool:
        """Whether a CUDA graph can capture this mesh's collectives: NCCL's
        can, gloo's cannot (they run on the host)."""
        return self.backend in (None, "nccl")

    def __repr__(self):
        return f"Mesh({self.shape}, rank={self.rank})"

    # -- groups -------------------------------------------------------------

    def _groups(self, axes):
        """Every rank calls new_group for every group along ``axes`` in one
        order; returns the one holding this rank. A group of the whole world
        is the default group."""
        if not axes:
            return None
        world = torch.distributed.get_world_size()
        others = [a for a in self.axis_names if a not in axes]
        mine = None
        for idx in np.ndindex(*[self.shape[a] for a in others]):
            pos = dict(zip(others, idx))
            sel = tuple(slice(None) if a in axes else pos[a] for a in self.axis_names)
            ranks = sorted(int(r) for r in self.devices[sel].ravel())
            if len(ranks) == world:
                group = torch.distributed.group.WORLD
            else:
                group = torch.distributed.new_group(ranks)
            if self.rank in ranks:
                mine = group
        return mine


def _live() -> bool:
    return torch.distributed.is_available() and torch.distributed.is_initialized()


def _world(devices):
    if devices is not None:
        return [int(d) for d in devices]
    return list(range(torch.distributed.get_world_size() if _live() else 1))


def make_mesh(n_data: Optional[int] = None, n_model: int = 1, devices=None,
              rank: Optional[int] = None, device=None) -> Mesh:
    """A ('data', 'model') mesh. Defaults to all ranks on the data axis; the
    model axis is innermost, so a rank's tensor-parallel peers are its
    neighbours (on one node where the node's ranks are consecutive).
    ``devices``: a list of ranks to lay out instead of the process group's
    (a layout only: no process group is made). ``device``: where this rank
    computes (``multihost.local_device()`` by default)."""
    ranks = _world(devices)
    if n_data is None:
        n_data = len(ranks) // n_model
    if n_data < 1 or n_data * n_model > len(ranks):
        raise ValueError(f"make_mesh needs {n_data} x {n_model} ranks, "
                         f"{len(ranks)} available")
    arr = np.asarray(ranks[: n_data * n_model]).reshape(n_data, n_model)
    return Mesh(arr, ("data", "model"), rank=rank, device=device,
                make_groups=devices is None)


def slice_of(rank: int, local_world_size: Optional[int]):
    """A rank's node (JAX's ``slice_index``): rank // LOCAL_WORLD_SIZE, or
    None where the node size is unknown."""
    return None if not local_world_size else rank // int(local_world_size)


def make_multislice_mesh(n_slices: int, n_data: Optional[int] = None,
                         n_model: int = 1, devices=None,
                         local_world_size: Optional[int] = None,
                         rank: Optional[int] = None, device=None) -> Mesh:
    """('replica', 'data', 'model') mesh for runs over several nodes.

    The replica axis is outermost: the tensor-parallel sums on 'model' and
    the rows of 'data' stay inside a node (NVLink), and only the once-a-step
    gradient sum crosses the network between nodes. On GPUs a JAX "slice" is
    a node: ranks are grouped by ``rank // LOCAL_WORLD_SIZE`` (the
    environment's, set by torchrun, unless ``local_world_size`` is given);
    with more than one node every 'replica' row must lie on one node. With
    the node size unknown, or one node, the ranks are split evenly in order.
    Raises ValueError for a data axis under 1, too few ranks, and a row that
    straddles nodes, as JAX's does."""
    ranks = _world(devices)
    if local_world_size is None and os.environ.get("LOCAL_WORLD_SIZE"):
        local_world_size = int(os.environ["LOCAL_WORLD_SIZE"])
    slice_ids = {slice_of(r, local_world_size) for r in ranks}
    multinode = len(slice_ids) > 1 and None not in slice_ids
    if multinode:
        ranks = sorted(ranks, key=lambda r: (slice_of(r, local_world_size), r))
    per_slice = len(ranks) // n_slices
    if n_data is None:
        n_data = per_slice // n_model
    if n_data < 1:
        raise ValueError(
            f"make_multislice_mesh: {len(ranks)} ranks cannot fit {n_slices} slices x "
            f"n_model={n_model} (data axis would be {n_data})")
    need = n_slices * n_data * n_model
    if len(ranks) < need:
        raise ValueError(
            f"make_multislice_mesh needs {need} ranks ({n_slices} slices x {n_data} data "
            f"x {n_model} model), only {len(ranks)} available (devices)")
    arr = np.asarray(ranks[:need]).reshape(n_slices, n_data, n_model)
    if multinode:
        for row in arr:
            nodes = {slice_of(int(r), local_world_size) for r in row.ravel()}
            if len(nodes) != 1:
                raise ValueError(
                    f"mesh row spans nodes {sorted(nodes)}; pass a rank list whose "
                    "per-node counts match n_data*n_model so each 'replica' row maps "
                    "to one node")
    return Mesh(arr, ("replica", "data", "model"), rank=rank, device=device,
                make_groups=devices is None)


# ----------------------------------------------------------------------
# Shardings
# ----------------------------------------------------------------------

class Sharding:
    """A :class:`P` on a mesh, as ``jax.sharding.NamedSharding``. An axis
    entry splits that dimension into equal blocks, one per index along the
    axis. ``sections``: the dimension is first cut into this many equal
    sections (qkv's q, k and v), and each section is split, so that a shard
    holds the same heads of each."""

    def __init__(self, mesh: Mesh, spec: P, sections: int = 1):
        self.mesh, self.spec, self.sections = mesh, P(*spec), sections

    def shard(self, t: torch.Tensor, rank: Optional[int] = None) -> torch.Tensor:
        """This rank's block of ``t`` (a dense copy; ``t`` itself where the
        spec replicates it)."""
        c = self.mesh.coords(rank)
        for dim, entry in enumerate(self.spec):
            if entry is None:
                continue
            index, parts = 0, 1
            for n in entry if isinstance(entry, tuple) else (entry,):
                index = index * self.mesh.shape[n] + c[n]
                parts *= self.mesh.shape[n]
            size = t.shape[dim]
            if size % (parts * self.sections):
                raise ValueError(f"dimension {dim} of size {size} does not split into "
                                 f"{self.sections} sections x {parts} shards")
            sec = size // self.sections
            step = sec // parts
            pieces = [t.narrow(dim, s * sec + index * step, step) for s in range(self.sections)]
            # A copy either way (clone keeps a narrowed view's strides
            # dense), so that the full tensor can be freed.
            t = torch.cat(pieces, dim=dim) if len(pieces) > 1 else pieces[0].clone(
                memory_format=torch.contiguous_format)
        return t


def replicated(mesh: Mesh) -> Sharding:
    return Sharding(mesh, P())


def batch_sharding(mesh: Mesh) -> Sharding:
    """The leading (batch) axis split over the data axes ('data', and
    'replica' across nodes); the rest replicated."""
    return Sharding(mesh, P(mesh.data_axes))


def shard_batch(mesh: Mesh, batch):
    """This rank's rows of each array leaf of a global batch dict, on the
    mesh's device; other leaves pass through."""
    from .multihost import process_local_rows

    n = next(int(v.shape[0]) for v in batch.values() if getattr(v, "ndim", 0))
    lo, hi = process_local_rows(mesh, n)
    return {k: (_to_device(v[lo:hi], mesh.device) if getattr(v, "ndim", 0) else v)
            for k, v in batch.items()}


def _to_device(x, device):
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(x))
    return x.to(device)


def replicate(mesh: Mesh, tree):
    """Every tensor leaf of ``tree`` broadcast in place from rank 0 of the
    mesh to all its ranks, so that all hold rank 0's values (a no-op
    without a process group). Returns ``tree``."""
    from ..models.convert import tree_leaves

    if _live():
        src = int(mesh.devices.ravel()[0])
        with torch.no_grad():
            for t in tree_leaves(tree):
                torch.distributed.broadcast(t.data, src=src)
    return tree


# ----------------------------------------------------------------------
# Tensor-parallel parameter shardings for the CLIP backbone (Megatron)
# ----------------------------------------------------------------------

class TensorParallelBlock(dict):
    """A transformer block's parameters as one rank's tensor-parallel shard
    (:func:`shard_backbone`): a dict like any block, which
    ``models.clip._run_block`` recognises by its type and runs with
    ``n_model`` ways of heads and hidden units, summing the row-split
    products over ``group``."""

    def __init__(self, params, group, n_model: int):
        super().__init__(params)
        self.group, self.n_model = group, int(n_model)


def _block_spec(mesh: Mesh, block):
    def rep(tree):
        return {k: replicated(mesh) for k in tree}

    return {
        "ln_1": rep(block["ln_1"]),
        "attn": {
            "qkv": {"w": Sharding(mesh, P(None, "model"), sections=3),
                    "b": Sharding(mesh, P("model"), sections=3)},
            "out": {"w": Sharding(mesh, P("model", None)), "b": replicated(mesh)},
        },
        "ln_2": rep(block["ln_2"]),
        "mlp": {
            "c_fc": {"w": Sharding(mesh, P(None, "model")), "b": Sharding(mesh, P("model"))},
            "c_proj": {"w": Sharding(mesh, P("model", None)), "b": replicated(mesh)},
        },
    }


def backbone_param_sharding(mesh: Mesh, params):
    """The :class:`Sharding` of every leaf of the frozen CLIP params:

    qkv.w (d, 3d):    output columns split by heads   -> P(None, 'model')
    out.w (d, d):     input rows split by heads       -> P('model', None)
    c_fc.w (d, 4d):   output columns split            -> P(None, 'model')
    c_proj.w (4d, d): input rows split                -> P('model', None)

    The column-split layers' biases split likewise, the row-split layers'
    stay replicated, and everything else is replicated. The port's blocks
    are a list (JAX stacks them on a leading layer axis), so each spec here
    is JAX's without that axis. qkv's columns are split within each of its
    q, k and v sections: a shard is [q_r | k_r | v_r] for the rank's heads,
    the packed layout the attention kernel reads, and has JAX's shard shape
    (3d / n_model columns) but not its columns (GSPMD's contiguous block is
    only a layout, regathered wherever the head split needs it)."""
    def tower(t):
        return {k: ([_block_spec(mesh, b) for b in v] if k == "blocks"
                    else _replicated_tree(mesh, v)) for k, v in t.items()}

    return {"visual": tower(params["visual"]), "text": tower(params["text"]),
            **{k: _replicated_tree(mesh, v) for k, v in params.items()
               if k not in ("visual", "text")}}


def _replicated_tree(mesh, tree):
    if isinstance(tree, dict):
        return {k: _replicated_tree(mesh, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_replicated_tree(mesh, v) for v in tree]
    return replicated(mesh)


def check_tensor_parallel(mesh: Mesh, cfg) -> None:
    """The port's limits of tensor parallelism (GSPMD has neither): 'model'
    must divide both towers' heads, since each rank attends over whole
    heads with the kernels, and a ResNet tower has no heads to split."""
    n = mesh.n_model
    from ..configs import ResNetVisionConfig

    if isinstance(cfg.vision, ResNetVisionConfig):
        raise ValueError("tensor parallelism splits a ViT's heads; a ResNet tower has none "
                         "(a limit of the port)")
    for tower, heads in (("vision", cfg.vision.heads), ("text", cfg.text.heads)):
        if heads % n:
            raise ValueError(f"n_model={n} does not divide the {tower} tower's {heads} heads: "
                             "the port splits whole heads (a limit of the port)")


def shard_backbone(mesh: Mesh, params, cfg=None):
    """This rank's tensor-parallel shard of the frozen CLIP params
    (:func:`backbone_param_sharding`). Each block becomes a
    :class:`TensorParallelBlock` over the mesh's model group; a mesh whose
    'model' axis is 1 returns ``params``. ``cfg``: the CLIPConfig, whose
    heads are checked against the axis (:func:`check_tensor_parallel`).
    int8-quantized weights are refused."""
    if mesh.n_model == 1:
        return params
    if cfg is not None:
        check_tensor_parallel(mesh, cfg)
    shardings = backbone_param_sharding(mesh, params)

    def apply(tree, spec):
        if isinstance(tree, dict):
            if "w_q" in tree:
                raise ValueError("shard_backbone: int8-quantized weights are not split "
                                 "(the int8 tiers are serving-only)")
            return {k: apply(v, spec[k]) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return [apply(v, s) for v, s in zip(tree, spec)]
        return spec.shard(tree, mesh.rank)

    out = apply(params, shardings)
    for tower in ("visual", "text"):
        out[tower]["blocks"] = [TensorParallelBlock(b, mesh.model_group, mesh.n_model)
                                for b in out[tower]["blocks"]]
    return out
