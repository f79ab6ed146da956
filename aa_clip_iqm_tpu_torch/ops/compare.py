"""How a bf16 kernel's output is held to its plain twin's.

Both outputs are bf16 roundings of the same function of the same inputs, so
they may differ by about one bf16 ulp of each element, plus what the two
orders of fp32 accumulation and the kernel's intermediate roundings add.
Each element's error is counted in bf16 ulps of ``max(|ref|, rms)``, where
``rms`` is the root mean square of the part the kernel adds, ``ref - base``
(``base`` is the residual input of a residual kernel, zero otherwise), so an
element near zero is held to the scale of its neighbours. Two measures of
those errors, each aimed at a kind of fault:

- ``max_ulps``, the largest: a fault in some elements (a wrong tile, row,
  bias or activation) shows here;
- ``rms_ulps``, their root mean square: two independent roundings alone keep
  it near 0.4, while a fault that moves every element by an ulp or more (a
  key tail left unmasked, a bias dropped, the wrong activation) lifts it
  past 1.
"""
from __future__ import annotations

import torch

#: Tolerances for a bf16 kernel against its bf16 twin.
BF16_MAX_ULPS = 6.0
BF16_RMS_ULPS = 1.0
#: The attention forward against the plain version of its own tile walk
#: (``flash_attention.attention_fwd_stages``), which rounds P against the
#: same running max: the largest error allowed there, a tighter hold that a
#: wrong rescale fails.
WALK_MAX_ULPS = 2.0


def bf16_ulp(t):
    """Spacing of bf16 numbers at ``|t|`` (t float32, nonzero): 2^(e-7) for
    |t| in [2^e, 2^(e+1))."""
    _, e = torch.frexp(t.abs())
    return torch.ldexp(torch.ones_like(t), e - 8)


def bf16_error(out, ref, base=None):
    """(max_ulps, rms_ulps) of ``out`` against ``ref``; see the module
    docstring."""
    out, ref = out.float(), ref.float()
    part = ref if base is None else ref - base.float()
    rms = part.square().mean().sqrt()
    ulps = (out - ref).abs() / bf16_ulp(torch.maximum(ref.abs(), rms))
    return ulps.max().item(), ulps.square().mean().sqrt().item()


def bf16_close(out, ref, base=None) -> bool:
    max_ulps, rms_ulps = bf16_error(out, ref, base)
    return max_ulps <= BF16_MAX_ULPS and rms_ulps <= BF16_RMS_ULPS
