#!/usr/bin/env python
"""Export smoke for the flagship programs, traced for the card without one.

    python -m aa_clip_iqm_tpu_torch.tools.aot_smoke

Counterpart of the JAX package's ``tools/aot_smoke.py``: it traces the
predict program at ViT-L/14-336's full width and depth with
``torch.export`` (non-strict) under a ``FakeTensorMode``, every weight and
input a fake CUDA tensor. No ViT-L weight is ever made (the trees are built
as shapes on the meta device, then faked onto ``cuda``) and no card is
needed, yet the trace takes the card's program: ``ops.layers.linear`` its
float32-output product (``aaclip::addmm_f32``), and each ``aaclip::`` op's
fake applies its kernel's shape limits (heads of 64, B3's multiples of
128). A shape fault that only shows at flagship scale on the card then
surfaces here. Programs:

  1. 518 px, batch 8, bf16: 24 ``aaclip::ln_attn_front`` (B8's LayerNorm
     pass and qkv product), 24 ``aaclip::flash_mha_packed`` (B1), 24
     ``aaclip::ln_attn_back`` (B8's out-projection with the residual) and
     24 ``aaclip::ln_mlp_residual`` (B2);
  2. the same in the ``int8`` tier: 24 B1 and 24
     ``aaclip::ln_mlp_residual_int8`` (B3), no B2, the int8 projections on
     the chain;
  3. 1274 px (8,282 tokens, past B1's 8,192), batch 2: 24 B8 fronts, 24
     ``aaclip::flash_mha`` (B7), 24 B8 backs and 24 B2.

It asserts each program's output shapes, (B, H, W) maps and (B,) scores on
``cuda``, and the number of ``aaclip::`` nodes of each kind in its graph,
``addmm_f32`` included, and prints one line per program.

Then the JAX tool's four mesh programs (its programs 1-4), each run as rank
0's program of 8 ranks at 518 px, global batch 8, bf16, on fake CUDA
tensors, its collectives through torch's fake process group (which answers
at once), every op recorded as it dispatches (``MESH_PROGRAMS``):

  4. the stage-2 loss on a (data 4, model 2) mesh with the backbone split
     by ``backbone_param_sharding``: the rank's 2 rows, its shard shapes
     (qkv (1024, 1536), out (512, 1024), c_fc (1024, 2048), c_proj (2048,
     1024)), 24 B1 at 8 heads and two all-reduces per block (48);
  5. predict on the same mesh with the backbone replicated: 2 rows, 24 B1
     at 16 heads and 24 B2, the maps and logits gathered (2 all-gathers);
  6. the stage-2 loss on the (replica 2, data 2, model 2) multislice mesh,
     TP backbone: as 4;
  7. predict over both data tiers of that mesh: as 5.

Left out of 4 and 6: the backward and the step's gradient sum. A PyTorch
built for the CPU cannot make autograd nodes for fake CUDA tensors; the
gloo tests (tests/test_torch_parallel.py) and chip_smoke.py's parallel
phase run the whole step.
"""
from __future__ import annotations

import argparse
import contextlib
import time
from collections import Counter
from unittest import mock

import numpy as np
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode

from ..configs import TrainConfig
from ..loader import build_model_config, init_trainable, random_backbone
from ..models.convert import tree_map
from ..ops import quant
from ..parallel import mesh as mesh_mod
from ..parallel.multihost import process_local_rows
from ..serving import _ExternalWeights
from ..evaluation.predict import make_predict_fn
from ..train import steps

MODEL = "ViT-L-14-336"


def _meta_quantized(p):
    """``quant.quantize_linear_params`` on shapes-only weights: the int8
    tree's shapes and dtypes, without the host round trip that reads
    values."""
    w = p["w"]
    out = {"w_q": torch.empty(w.shape, dtype=torch.int8, device=w.device),
           "scale": torch.empty(w.shape[:-2] + (1, w.shape[-1]), dtype=torch.float32,
                                device=w.device)}
    if p.get("b") is not None:
        out["b"] = p["b"]
    return out


def aaclip_nodes(program) -> Counter:
    """The ``aaclip::`` op calls of an exported program's graph, by op."""
    found = Counter()
    for node in program.graph.nodes:
        if node.op == "call_function" and str(node.target).startswith("aaclip."):
            found[str(node.target).split(".")[1]] += 1
    return found


class _Indexing(TorchFunctionMode):
    """``Tensor.__getitem__`` as the aten views it stands for (select, slice,
    unsqueeze). A CPU-only PyTorch's indexing binding opens a CUDA device
    guard, which that build cannot, even for a fake CUDA tensor; the views
    it would record are the same."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func is not torch.Tensor.__getitem__:
            return func(*args, **(kwargs or {}))
        x, idx = args
        idx = idx if isinstance(idx, tuple) else (idx,)
        if Ellipsis in idx:
            k = idx.index(Ellipsis)
            named = sum(i is not None and i is not Ellipsis for i in idx)
            idx = idx[:k] + (slice(None),) * (x.dim() - named) + idx[k + 1:]
        aten, dim = torch.ops.aten, 0
        for i in idx:
            if i is None:
                x = aten.unsqueeze.default(x, dim)
                dim += 1
            elif isinstance(i, int):
                x = aten.select.int(x, dim, i)
            elif isinstance(i, slice):
                if i != slice(None):
                    x = aten.slice.Tensor(x, dim, i.start, i.stop, i.step or 1)
                dim += 1
            else:
                raise NotImplementedError(f"index {idx!r} in a fake CUDA trace")
        return x


def trace(img_size: int, batch: int, quantize=None):
    """Export the predict program of ViT-L/14-336 at ``img_size`` for one
    batch, on fake CUDA tensors. Returns (program, output shapes and devices,
    seconds)."""
    cfg = build_model_config(MODEL, img_size=img_size)
    frozen = random_backbone(cfg, device="meta", dtype=torch.bfloat16)
    trainable = init_trainable(cfg, device="meta", dtype=torch.bfloat16)
    predict = make_predict_fn(cfg, img_size, "Industrial", compute_dtype=torch.bfloat16)
    # Real tensors (the interpolation operators, the image mean and std) meet
    # the fakes as constants of the trace.
    with FakeTensorMode(allow_non_fake_inputs=True), _Indexing():
        def cuda(t):
            return torch.empty(t.shape, dtype=t.dtype, device="cuda")

        frozen, trainable = tree_map(cuda, frozen), tree_map(cuda, trainable)
        if quantize is not None:
            with mock.patch.object(quant, "quantize_linear_params", _meta_quantized):
                frozen = quant.quantize_backbone_tier(frozen, quantize)
        images = torch.empty((batch, 3, img_size, img_size), dtype=torch.float32,
                             device="cuda")
        anchors = torch.empty((batch, cfg.clip.embed_dim, 2), dtype=torch.float32,
                              device="cuda")
        t0 = time.perf_counter()
        program = torch.export.export(_ExternalWeights(predict),
                                      (frozen, trainable, images, anchors), strict=False)
        seconds = time.perf_counter() - t0
    outputs = [(tuple(node.meta["val"].shape), node.meta["val"].device.type)
               for node in program.graph.output_node().args[0]]
    return program, outputs, seconds


#: The float32-output products (``aaclip::addmm_f32``) of the predict
#: program outside the tower's blocks: the IQM head's 28 and the five
#: projections of the adapters' head.
HEAD_PRODUCTS = 33
#: (name, img_size, batch, quantize, aaclip:: nodes wanted). A block's qkv
#: and out-projection run on B8's front and back, unless the int8 tier
#: quantizes them (int8 products, no node).
PROGRAMS = (
    ("518px b8 bf16", 518, 8, None,
     {"ln_attn_front": 24, "flash_mha_packed": 24, "ln_attn_back": 24, "ln_mlp_residual": 24,
      "addmm_f32": HEAD_PRODUCTS}),
    ("518px b8 int8", 518, 8, "int8",
     {"flash_mha_packed": 24, "ln_mlp_residual_int8": 24, "addmm_f32": HEAD_PRODUCTS}),
    ("1274px b2 bf16", 1274, 2, None,
     {"ln_attn_front": 24, "flash_mha": 24, "ln_attn_back": 24, "ln_mlp_residual": 24,
      "addmm_f32": HEAD_PRODUCTS}),
)


def run(programs=PROGRAMS, log=print):
    """Trace each program and hold its output shapes and node counts.
    Raises AssertionError at the first that is off."""
    for name, img, batch, quantize, want in programs:
        program, outputs, seconds = trace(img, batch, quantize)
        nodes = dict(aaclip_nodes(program))
        log(f"{name}: {len(program.graph.nodes)} graph nodes in {seconds:.1f} s, "
            f"outputs {outputs}, aaclip:: {nodes}")
        if outputs != [((batch, img, img), "cuda"), ((batch,), "cuda")]:
            raise AssertionError(f"{name}: outputs {outputs}")
        if nodes != want:
            raise AssertionError(f"{name}: aaclip:: nodes {nodes}, want {want}")


class _Recorder(TorchDispatchMode):
    """Counts the ops that dispatch under it, and the head counts that
    ``aaclip::flash_mha_packed`` (B1) is called with."""

    def __init__(self):
        super().__init__()
        self.ops, self.b1_heads = Counter(), Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = str(func)
        self.ops[name] += 1
        if name.startswith("aaclip.flash_mha_packed"):
            self.b1_heads[int(args[1])] += 1
        return func(*args, **(kwargs or {}))


@contextlib.contextmanager
def fake_process_group(world: int, rank: int = 0):
    """torch's fake process group: every collective returns at once."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a process group is live already")
    dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _mesh(shape):
    if len(shape) == 3:
        return mesh_mod.make_multislice_mesh(shape[0], n_data=shape[1], n_model=shape[2],
                                             device="cuda")
    return mesh_mod.make_mesh(n_data=shape[0], n_model=shape[1], device="cuda")


def trace_mesh(program: str, shape, img_size: int = 518, batch: int = 8):
    """Rank 0's ``program`` ("stage2" or "predict") of ViT-L/14-336 on a
    mesh of ``shape`` ((data, model) or (replica, data, model)), on fake
    CUDA tensors. Returns (the recorder, the rank's rows, its qkv / out /
    c_fc / c_proj shard shapes, the output shapes)."""
    cfg = build_model_config(MODEL, img_size=img_size)
    frozen = random_backbone(cfg, device="meta", dtype=torch.bfloat16)
    # float32 masters for the step, bf16 for serving, as the callers make them.
    trainable = init_trainable(cfg, device="meta", dtype=torch.float32 if program == "stage2"
                               else torch.bfloat16)
    world = int(np.prod(shape))
    with fake_process_group(world), FakeTensorMode(allow_non_fake_inputs=True), _Indexing():
        mesh = _mesh(shape)

        def cuda(t):
            return torch.empty(t.shape, dtype=t.dtype, device="cuda")

        frozen, trainable = tree_map(cuda, frozen), tree_map(cuda, trainable)
        images = torch.empty((batch, 3, img_size, img_size), dtype=torch.float32,
                             device="cuda")
        anchors = torch.empty((batch, cfg.clip.embed_dim, 2), dtype=torch.float32,
                              device="cuda")
        rows = process_local_rows(mesh, batch)
        rec = _Recorder()
        if program == "stage2":
            frozen = mesh_mod.shard_backbone(mesh, frozen, cfg.clip)
            step = steps.make_stage2_step(
                cfg, TrainConfig(img_size=img_size, compute_dtype="bfloat16"),
                compute_dtype=torch.bfloat16, mesh=mesh,
                frozen_sharding=mesh_mod.backbone_param_sharding(mesh, frozen))
            n = rows[1] - rows[0]
            masks = torch.empty((n, 1, img_size, img_size), dtype=torch.float32,
                                device="cuda")
            labels = torch.empty((n,), dtype=torch.int64, device="cuda")
            weights = torch.empty((n,), dtype=torch.float32, device="cuda")
            with torch.no_grad(), rec:
                out = step.loss_fn(trainable, frozen, images[:n], masks, labels,
                                   anchors[:n], weights, None)
            outputs = [tuple(out.shape)]
        else:
            predict = make_predict_fn(cfg, img_size, "Industrial",
                                      compute_dtype=torch.bfloat16, mesh=mesh)
            with rec:
                outputs = [tuple(t.shape) for t in predict(frozen, trainable, images,
                                                           anchors)]
        block = frozen["visual"]["blocks"][0]
        shards = tuple(tuple(block[a][b]["w"].shape) for a, b in (
            ("attn", "qkv"), ("attn", "out"), ("mlp", "c_fc"), ("mlp", "c_proj")))
    return rec, rows, shards, outputs


_TP_SHARDS = ((1024, 1536), (512, 1024), (1024, 2048), (2048, 1024))
_FULL = ((1024, 3072), (1024, 1024), (1024, 4096), (4096, 1024))
#: (name, program, mesh shape, rank 0's rows, shard shapes, B1 calls by
#: head count, all-reduces, all-gathers, B2 calls, output shapes).
MESH_PROGRAMS = (
    ("stage-2 loss, data 4 x model 2, TP backbone", "stage2", (4, 2), (0, 2), _TP_SHARDS,
     {8: 24}, 48, 0, 0, [()]),
    ("predict, data 4 x model 2", "predict", (4, 2), (0, 2), _FULL, {16: 24}, 0, 2, 24,
     [(8, 518, 518), (8,)]),
    ("stage-2 loss, multislice 2 x 2 x 2, TP backbone", "stage2", (2, 2, 2), (0, 2),
     _TP_SHARDS, {8: 24}, 48, 0, 0, [()]),
    ("predict, multislice 2 x 2 x 2", "predict", (2, 2, 2), (0, 2), _FULL, {16: 24}, 0, 2, 24,
     [(8, 518, 518), (8,)]),
)


def run_mesh(programs=MESH_PROGRAMS, log=print):
    """Run each mesh program as rank 0 and hold what it dispatched. Raises
    AssertionError at the first that is off."""
    for name, program, shape, rows, shards, b1, reduces, gathers, b2, outputs in programs:
        t0 = time.perf_counter()
        rec, got_rows, got_shards, got_out = trace_mesh(program, shape)
        got = {"rows": got_rows, "shards": got_shards, "B1 by heads": dict(rec.b1_heads),
               "all-reduces": rec.ops["c10d.allreduce_.default"],
               "all-gathers": rec.ops["c10d.allgather_.default"],
               "B2": rec.ops["aaclip.ln_mlp_residual.default"], "outputs": got_out}
        want = {"rows": rows, "shards": shards, "B1 by heads": b1, "all-reduces": reduces,
                "all-gathers": gathers, "B2": b2, "outputs": outputs}
        log(f"{name}: rank 0 of {int(np.prod(shape))} in {time.perf_counter() - t0:.1f} s, "
            f"{got}")
        if got != want:
            raise AssertionError(f"{name}: {got}, want {want}")


def main(argv=None):
    argparse.ArgumentParser(description=__doc__.split("\n\n")[0]).parse_args(argv)
    run()
    run_mesh()
    print("aot smoke OK")


if __name__ == "__main__":
    main()
