#!/usr/bin/env python
"""A/B probe of the fused LN -> MLP -> residual kernels at the flagship
ViT-L shape: B2 on bf16 weights (``ops/fused_mlp.ln_mlp_residual``) against
B3 on int8 weights (``ln_mlp_residual_int8``) and against the unfused int8
chain (``int8_linear`` -> GELU -> ``int8_linear``, the hidden layer through
device memory), each in a 24-deep chain.

    python -m aa_clip_iqm_tpu_torch.tools.probe_mlp_int8

Counterpart of the JAX package's ``tools/probe_mlp_int8.py``, at its shape
(16 x 1408 rows, 1024 x 4096) and with its report: the int8 kernel's
one-layer relative error against the float kernel (on 4096 rows), then ms
per chain and TFLOP/s on the chain's matmul FLOPs (quantization epilogues
not counted). On the card each chain is captured as a CUDA graph and timed
on CUDA events (``tools/chains.py``); on the CPU (``--device cpu``, with a
small ``--rows``) every kernel wrapper runs its plain version under the
host clock.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from ..platform import default_device
from .chains import rel_err, time_chain

LAYERS = 24
D, H = 1024, 4096
ROWS = 16 * 1408


def make_case(rows: int = ROWS, device="cuda", seed: int = 0):
    """The probe's weights and input as the JAX tool draws them: (ln, mlp
    with bf16 matrices, int8 mlp, x (rows, D) bf16)."""
    from ..ops.quant import quantize_linear_params

    rng = np.random.default_rng(seed)

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(device)

    ln = {"scale": t(rng.standard_normal(D) * 0.02 + 1), "bias": t(rng.standard_normal(D) * 0.02)}
    fp = {"c_fc": {"w": t(rng.standard_normal((D, H)) * 0.03), "b": t(rng.standard_normal(H) * 0.02)},
          "c_proj": {"w": t(rng.standard_normal((H, D)) * 0.02),
                     "b": t(rng.standard_normal(D) * 0.02)}}
    qmlp = {n: quantize_linear_params(p) for n, p in fp.items()}
    mlp = {n: {"w": p["w"].to(torch.bfloat16), "b": p["b"]} for n, p in fp.items()}
    x = t(rng.standard_normal((rows, D))).to(torch.bfloat16)
    return ln, mlp, qmlp, x


def run(rows: int = ROWS, layers: int = LAYERS, device="cuda", iters: int = 10,
        warmup: int = 3, out=print):
    """The probe: prints its lines through ``out`` and returns {"rel_err":
    one-layer int8 against float, "chains": {name: {"ms", "where",
    "tflops"}}}."""
    from ..ops import fused_mlp
    from ..ops.layers import gelu, layer_norm, linear

    ln, mlp, qmlp, x = make_case(rows, device)
    assert fused_mlp.ln_mlp_residual_int8_ok(x, qmlp, gelu)

    def chain_fp(t):
        for _ in range(layers):
            t = fused_mlp.ln_mlp_residual(ln, mlp, t, gelu)
        return t

    def chain_int8(t):
        for _ in range(layers):
            t = fused_mlp.ln_mlp_residual_int8(ln, qmlp, t, gelu)
        return t

    def chain_int8_unfused(t):
        # The unfused int8 route (ops.layers.linear on w_q params): the
        # hidden layer goes through device memory between the two products.
        for _ in range(layers):
            h = gelu(linear(qmlp["c_fc"], layer_norm(ln, t)))
            t = t + linear(qmlp["c_proj"], h).to(t.dtype)
        return t

    head = x[:4096]
    err = rel_err(fused_mlp.ln_mlp_residual_int8(ln, qmlp, head, gelu),
                  fused_mlp.ln_mlp_residual(ln, mlp, head, gelu))
    out(f"int8 kernel 1-layer rel err vs fp kernel: {err:.4f}")
    flops = layers * 2 * 2 * rows * D * H
    chains = {}
    for name, fn in (("fused bf16", chain_fp), ("fused int8", chain_int8),
                     ("unfused int8", chain_int8_unfused)):
        where, ms = time_chain(fn, x, iters, warmup)
        tflops = flops / (ms * 1e-3) / 1e12
        chains[name] = {"ms": ms, "where": where, "tflops": tflops}
        out(f"{name:>20}: {ms:8.2f} ms/chain ({where})  {tflops:6.1f} TFLOP/s")
    return {"rel_err": err, "chains": chains}


def build_parser():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--rows", type=int, default=ROWS)
    p.add_argument("--layers", type=int, default=LAYERS)
    p.add_argument("--iters", type=int, default=10)
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
