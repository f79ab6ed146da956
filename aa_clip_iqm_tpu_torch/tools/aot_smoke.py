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

  1. 518 px, batch 8, bf16: 24 ``aaclip::flash_mha_packed`` (B1) and 24
     ``aaclip::ln_mlp_residual`` (B2);
  2. the same in the ``int8`` tier: 24 B1 and 24
     ``aaclip::ln_mlp_residual_int8`` (B3), no B2;
  3. the same with ``AACLIP_FUSED_ATTN=1`` (``models.clip.FUSED_ATTN``): 24
     ``aaclip::ln_attn_residual`` (B8) and 24 B2, no B1;
  4. 1274 px (8,282 tokens, past B1's 8,192), batch 2: 24
     ``aaclip::flash_mha`` (B7) and 24 B2.

It asserts each program's output shapes, (B, H, W) maps and (B,) scores on
``cuda``, and the number of ``aaclip::`` nodes of each kind in its graph,
``addmm_f32`` included, and prints one line per program. Left out: the JAX
tool's data- and tensor-parallel and multislice programs, which wait for
the port's multi-card support (ROADMAP A14).
"""
from __future__ import annotations

import argparse
import time
from collections import Counter
from unittest import mock

import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.overrides import TorchFunctionMode

from ..loader import build_model_config, init_trainable, random_backbone
from ..models import clip as clip_mod
from ..models.convert import tree_map
from ..ops import quant
from ..serving import _ExternalWeights
from ..evaluation.predict import make_predict_fn

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


def trace(img_size: int, batch: int, quantize=None, fused_attn: bool = False):
    """Export the predict program of ViT-L/14-336 at ``img_size`` for one
    batch, on fake CUDA tensors. Returns (program, output shapes and devices,
    seconds)."""
    cfg = build_model_config(MODEL, img_size=img_size)
    frozen = random_backbone(cfg, device="meta", dtype=torch.bfloat16)
    trainable = init_trainable(cfg, device="meta", dtype=torch.bfloat16)
    predict = make_predict_fn(cfg, img_size, "Industrial", compute_dtype=torch.bfloat16)
    saved = clip_mod.FUSED_ATTN
    clip_mod.FUSED_ATTN = fused_attn
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
        try:
            t0 = time.perf_counter()
            program = torch.export.export(_ExternalWeights(predict),
                                          (frozen, trainable, images, anchors), strict=False)
            seconds = time.perf_counter() - t0
        finally:
            clip_mod.FUSED_ATTN = saved
    outputs = [(tuple(node.meta["val"].shape), node.meta["val"].device.type)
               for node in program.graph.output_node().args[0]]
    return program, outputs, seconds


#: The float32-output products (``aaclip::addmm_f32``) of the predict
#: program outside the tower's blocks: the IQM head's 28 and the five
#: projections of the adapters' head.
HEAD_PRODUCTS = 33
#: (name, img_size, batch, quantize, fused_attn, aaclip:: nodes wanted). A
#: block's qkv and out-projection are one product each, unless the int8 tier
#: quantizes them or B8 fuses them.
PROGRAMS = (
    ("518px b8 bf16", 518, 8, None, False,
     {"flash_mha_packed": 24, "ln_mlp_residual": 24, "addmm_f32": 48 + HEAD_PRODUCTS}),
    ("518px b8 int8", 518, 8, "int8", False,
     {"flash_mha_packed": 24, "ln_mlp_residual_int8": 24, "addmm_f32": HEAD_PRODUCTS}),
    ("518px b8 AACLIP_FUSED_ATTN=1", 518, 8, None, True,
     {"ln_attn_residual": 24, "ln_mlp_residual": 24, "addmm_f32": HEAD_PRODUCTS}),
    ("1274px b2 bf16", 1274, 2, None, False,
     {"flash_mha": 24, "ln_mlp_residual": 24, "addmm_f32": 48 + HEAD_PRODUCTS}),
)


def run(programs=PROGRAMS, log=print):
    """Trace each program and hold its output shapes and node counts.
    Raises AssertionError at the first that is off."""
    for name, img, batch, quantize, fused, want in programs:
        program, outputs, seconds = trace(img, batch, quantize, fused)
        nodes = dict(aaclip_nodes(program))
        log(f"{name}: {len(program.graph.nodes)} graph nodes in {seconds:.1f} s, "
            f"outputs {outputs}, aaclip:: {nodes}")
        if outputs != [((batch, img, img), "cuda"), ((batch,), "cuda")]:
            raise AssertionError(f"{name}: outputs {outputs}")
        if nodes != want:
            raise AssertionError(f"{name}: aaclip:: nodes {nodes}, want {want}")


def main(argv=None):
    argparse.ArgumentParser(description=__doc__.split("\n\n")[0]).parse_args(argv)
    run()
    print("aot smoke OK")


if __name__ == "__main__":
    main()
