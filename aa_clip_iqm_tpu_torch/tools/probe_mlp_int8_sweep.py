#!/usr/bin/env python
"""Variant sweep of B9, the int8 probe's fused LN -> int8 MLP -> residual
kernel (``ops/fused_mlp.ln_mlp_residual_int8_probe``), in a 24-deep chain.

    python -m aa_clip_iqm_tpu_torch.tools.probe_mlp_int8_sweep

Counterpart of the JAX package's ``tools/probe_mlp_int8_sweep.py``, at its
shape (22528 x 1024 x 4096, 24 layers) and with its report: per variant the
ms per chain and the TOP/s of the chain's int8 products, then the 24-layer
relative error (max |diff| / max |fp chain|) against the float chain and
against the fp32-epilogue base variant (ch 1024).

The variants are (ep_bf16, ch) in {(F, 1024), (F, 2048), (T, 1024)}: the
epilogue's dtype (fp32, or the compare-free GELU on bf16 values) and the
hidden chunk width, both part of the numerics. The JAX sweep also varies TM,
the Pallas row tile in VMEM; that tile has no meaning on this card, and the
Hopper kernel has no tiling knob of its own to put in its place (its GEMMs'
tiles are fixed: 192 x 128 for GEMM 1, 128 x 128 for GEMM 2), so the sweep
has these three variants.

On the card each chain is captured as a CUDA graph and timed on CUDA events
(``tools/chains.py``). On the CPU (``--device cpu``, e.g. with ``--rows 64
--layers 2``) the wrapper runs B9's plain version under the host clock.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from ..platform import default_device
from .chains import time_chain

LAYERS = 24
ROWS, D, H = 22528, 1024, 4096
VARIANTS = ((False, 1024), (False, 2048), (True, 1024))


def make_case(rows: int = ROWS, device="cuda", seed: int = 0):
    """The probe's weights and input, drawn as the JAX tool draws them:
    (ln, float mlp (bf16 matrices), int8 mlp, x (rows, D) bf16)."""
    from ..ops.quant import quantize_linear_params

    rng = np.random.default_rng(seed)

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(device)

    ln = {"scale": t(rng.standard_normal(D) * 0.02 + 1), "bias": t(rng.standard_normal(D) * 0.02)}
    fc = {"w": t(rng.standard_normal((D, H)) * 0.02), "b": t(rng.standard_normal(H) * 0.01)}
    pr = {"w": t(rng.standard_normal((H, D)) * 0.02), "b": t(rng.standard_normal(D) * 0.01)}
    qmlp = {"c_fc": quantize_linear_params(fc), "c_proj": quantize_linear_params(pr)}
    mlp = {n: {"w": p["w"].to(torch.bfloat16), "b": p["b"]}
           for n, p in (("c_fc", fc), ("c_proj", pr))}
    x = t(rng.standard_normal((rows, D)) * 0.5).to(torch.bfloat16)
    return ln, mlp, qmlp, x


def run(rows: int = ROWS, layers: int = LAYERS, device="cuda", iters: int = 8,
        warmup: int = 2, out=print):
    """The sweep: prints its lines through ``out`` and returns {variant:
    {"ms", "where", "tops", "vs_fp", "vs_base"}} with the variant as
    (ep_bf16, ch)."""
    from ..ops import fused_mlp
    from ..ops.layers import gelu, layer_norm, mlp_block

    ln, mlp, qmlp, x = make_case(rows, device)
    ops = layers * 2 * rows * D * H * 2
    results, outs = {}, {}
    for ep_bf16, ch in VARIANTS:
        def chain(t, ep_bf16=ep_bf16, ch=ch):
            for _ in range(layers):
                t = fused_mlp.ln_mlp_residual_int8_probe(ln, qmlp, t, ep_bf16, ch)
            return t

        outs[(ep_bf16, ch)] = chain(x).float()
        where, ms = time_chain(chain, x, iters, warmup)
        tops = ops / (ms * 1e-3) / 1e12
        results[(ep_bf16, ch)] = {"ms": ms, "where": where, "tops": tops}
        out(f"ep_bf16={int(ep_bf16)} ch={ch:4d}: {ms:7.2f} ms/chain ({where})  "
            f"{tops:6.1f} TOP/s")

    def fp_chain(t):
        for _ in range(layers):
            t = t + mlp_block(mlp, layer_norm(ln, t), gelu)
        return t

    # Both errors relative to the float chain's largest value, as JAX's.
    ref = fp_chain(x).float()
    base = outs[VARIANTS[0]]
    scale = ref.abs().max().item() + 1e-9
    for key, o in outs.items():
        results[key]["vs_fp"] = (o - ref).abs().max().item() / scale
        results[key]["vs_base"] = (o - base).abs().max().item() / scale
    out(f"{layers}-layer rel err vs fp chain: f32-ep {results[VARIANTS[0]]['vs_fp']:.2e}")
    for key in VARIANTS[1:]:
        out(f"  {key}: vs f32-ep {results[key]['vs_base']:.2e}, "
            f"vs fp {results[key]['vs_fp']:.2e}")
    return results


def build_parser():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--rows", type=int, default=ROWS)
    p.add_argument("--layers", type=int, default=LAYERS)
    p.add_argument("--iters", type=int, default=8)
    p.add_argument("--device", default=default_device(),
                   help="cuda (default) or cpu; AACLIP_PLATFORM=cpu sets cpu")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    run(args.rows, args.layers, args.device, args.iters,
        out=lambda line: print(line, flush=True))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
