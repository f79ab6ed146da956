#!/usr/bin/env python
"""A/B probe of the fused attention half-block, B8 (LN -> qkv -> attention
-> out-proj -> residual in one kernel, ``ops/attn_block.ln_attn_residual``),
against the shipping chain (LayerNorm, the qkv projection, B1 on the packed
projection, the out-projection), each in a 24-deep chain.

    python -m aa_clip_iqm_tpu_torch.tools.probe_attn_fused

Counterpart of the JAX package's ``tools/probe_attn_fused.py``, at its
shapes (batch 16 and 6 of 1408 tokens, 1370 of them valid, 16 heads of 64)
and with its report: per batch and attention kind (plain, value-value) the
ms per layer of both routes, the fused one's gain, and the relative error of
the fused chain's output against the chain's over the valid tokens. On the
card each chain is captured as a CUDA graph and timed on CUDA events
(``tools/chains.py``); on the CPU (``--device cpu``, with small
``--batches`` and ``--tokens``) the wrappers run their plain versions under
the host clock.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from ..platform import default_device
from .chains import rel_err, time_chain

LAYERS = 24
HEADS, D = 16, 1024
TOKENS, VALID = 1408, 1370


def make_params(rng, device="cuda"):
    """(ln, attn) as the JAX tool draws them, the matrices in bf16."""
    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(device)

    ln = {"scale": t(rng.standard_normal(D) * 0.02 + 1), "bias": t(rng.standard_normal(D) * 0.02)}
    attn = {"qkv": {"w": t(rng.standard_normal((D, 3 * D)) * 0.03).to(torch.bfloat16),
                    "b": torch.zeros(3 * D, device=device)},
            "out": {"w": t(rng.standard_normal((D, D)) * 0.03).to(torch.bfloat16),
                    "b": torch.zeros(D, device=device)}}
    return ln, attn


def run(batches=(16, 6), tokens: int = TOKENS, valid: int = VALID, layers: int = LAYERS,
        device="cuda", iters: int = 10, warmup: int = 3, out=print):
    """The probe: prints its lines through ``out`` and returns {(batch, vv):
    {"base_ms", "fused_ms", "where", "rel_err"}} (ms per layer)."""
    from ..ops import attention as attn_ops
    from ..ops.attn_block import ln_attn_residual
    from ..ops.layers import layer_norm

    rng = np.random.default_rng(0)
    ln, attn = make_params(rng, device)

    def chain_base(x, vv):
        for _ in range(layers):
            h = layer_norm(ln, x)
            if vv:
                a = attn_ops.vv_attention(attn, h, HEADS, valid_len=valid)
            else:
                a = attn_ops.mha(attn, h, HEADS, valid_len=valid)
            x = x + a
        return x

    def chain_fused(x, vv):
        for _ in range(layers):
            x = ln_attn_residual(ln, attn, x, HEADS, vv, valid)
        return x

    results = {}
    for b in batches:
        x = torch.from_numpy(rng.standard_normal((b, tokens, D)).astype(np.float32) * 0.5)
        x = x.to(device=device, dtype=torch.bfloat16)
        for vv in (False, True):
            err = rel_err(chain_fused(x, vv)[:, :valid], chain_base(x, vv)[:, :valid])
            where, ms_b = time_chain(lambda t, vv=vv: chain_base(t, vv), x, iters, warmup)
            _, ms_f = time_chain(lambda t, vv=vv: chain_fused(t, vv), x, iters, warmup)
            results[(b, vv)] = {"base_ms": ms_b / layers, "fused_ms": ms_f / layers,
                                "where": where, "rel_err": err}
            out(f"b{b} vv={vv}: base {ms_b / layers:.3f} ms/layer, fused {ms_f / layers:.3f} "
                f"ms/layer [{100 * (ms_b - ms_f) / ms_b:+.1f}%] relerr={err:.2e} ({where})")
    return results


def build_parser():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--batches", type=int, nargs="+", default=[16, 6])
    p.add_argument("--tokens", type=int, default=TOKENS)
    p.add_argument("--valid", type=int, default=VALID)
    p.add_argument("--layers", type=int, default=LAYERS)
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--device", default=default_device(),
                   help="cuda (default) or cpu; AACLIP_PLATFORM=cpu sets cpu")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    run(tuple(args.batches), args.tokens, args.valid, args.layers, args.device, args.iters,
        out=lambda line: print(line, flush=True))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
