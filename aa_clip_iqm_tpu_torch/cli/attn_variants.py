#!/usr/bin/env python
"""Time variants of the attention forward walk against each other on one GPU.

    python -m aa_clip_iqm_tpu_torch.cli.attn_variants [--variants kept,no_pingpong]
        [--reps 20]

Each variant is ``csrc/attention_fwd.cuh`` with a few textual edits
(:data:`VARIANTS`, each undoing one choice of the kept design). For every
variant the script copies ``csrc/`` into ``build/aa_clip_iqm_tpu_torch/
variants/<name>/``, applies the edits, builds B1 (``packed_attention.cu``)
and B7 (``flash_attention.cu``) there (one nvcc per library, all started
together), holds each variant's outputs to the plain twins (ops/compare.py:
B1 at ViT-L/518 batch 8 with valid_len None and 1300, B7 at (16, 8282, 64)),
then times B1 and B7 with CUDA events in turns (the variants in order, then
in reverse) and prints one JSON line per variant, and the card's name and
power limit. It needs a GPU and nvcc and exits with an error without them.
"""
import argparse
import ctypes
import json
import os
import shutil
import subprocess

import torch

from ..ops import _build
from ..ops import flash_attention as fa
from ..ops import packed_attention as pa
from ..ops.compare import bf16_close, bf16_error

HEADER = "attention_fwd.cuh"
_TURN = '''  auto my_turn = [&]() { asm volatile("bar.sync %0, 256;\\n" ::"r"(1 + wg)); };
  auto your_turn = [&]() { asm volatile("bar.arrive %0, 256;\\n" ::"r"(2 - wg)); };'''
_RESCALE = '''  auto rescale = [&](const float (&alpha)[2]) {
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) o[i] *= alpha[(i / 2) & 1];
  };'''
_EXP_MAX = "const float m_new = fmaxf(m_run[r], mx[r] * scale2);"
_EXP = "sc[i] = fast_exp2(fmaf(sc[i], scale2, -m_run[(i / 2) & 1]));"
_MASK = "    if constexpr (decltype(masked)::value) {"

#: name -> [(text of the kept header, its replacement)].
VARIANTS = {
    "kept": [],
    # The warpgroups issue their products whenever they are ready.
    "no_pingpong": [(_TURN, "  auto my_turn = [&]() {};\n  auto your_turn = [&]() {};")],
    # A warp rescales O only where one of its rows' maxima moved.
    "skip_unmoved_rescale": [(_RESCALE, '''  auto rescale = [&](const float (&alpha)[2]) {
    if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) o[i] *= alpha[(i / 2) & 1];
    }
  };''')],
    # A 2-stage K/V ring instead of 4.
    "two_stages": [("constexpr int STAGES = 4;", "constexpr int STAGES = 2;")],
    # S scale log2 e formed first, the exponent a subtraction (no FMA).
    "scaled_scores": [(_MASK, "#pragma unroll\n    for (int i = 0; i < 64; ++i) sc[i] *= scale2;\n"
                       + _MASK),
                      (_EXP_MAX, "const float m_new = fmaxf(m_run[r], mx[r]);"),
                      (_EXP, "sc[i] = fast_exp2(sc[i] - m_run[(i / 2) & 1]);")],
}

_LIBS = ("packed_attention", "flash_attention")


def variant_source(name: str, header: str) -> str:
    """The header of variant ``name``; raises if an edit no longer applies."""
    for old, new in VARIANTS[name]:
        if header.count(old) != 1:
            raise ValueError(f"variant {name}: its edit does not apply to {HEADER}: {old[:60]!r}")
        header = header.replace(old, new)
    return header


def _build_all(names):
    root = os.path.join(_build.BUILD_DIR, "variants")
    header = open(os.path.join(_build.CSRC_DIR, HEADER)).read()
    procs = {}
    for name in names:
        d = os.path.join(root, name)
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(_build.CSRC_DIR, d)
        with open(os.path.join(d, HEADER), "w") as f:
            f.write(variant_source(name, header))
        for lib in _LIBS:
            procs[name, lib] = subprocess.Popen(
                [_build._nvcc(), *_build.NVCC_FLAGS, "-o", os.path.join(d, f"lib{lib}.so"),
                 os.path.join(d, lib + ".cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for (name, lib), proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for variant {name}, {lib}:\n{out}")
        libs[name, lib] = ctypes.CDLL(os.path.join(root, name, f"lib{lib}.so"))
    return libs


def _time(fn, reps):
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("attn_variants: needs a CUDA device")
    names = args.variants.split(",")
    libs = _build_all(names)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    b, l, w, heads, hd = 8, 1370, 1024, 16, 64
    qkv = torch.randn((b, l, 3 * w), generator=gen, device=dev).to(torch.bfloat16)
    q, k, v = (torch.randn((16, 8282, hd), generator=gen, device=dev).to(torch.bfloat16)
               for _ in range(3))
    out1 = torch.empty((b, l, w), dtype=torch.bfloat16, device=dev)
    out7 = torch.empty_like(q)
    stream = _build.stream_ptr(dev)

    def b1(name, valid_len=l):
        fn = libs[name, "packed_attention"].aaclip_packed_attention
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        err = fn(qkv.data_ptr(), out1.data_ptr(), None, b, l, w, heads, hd, valid_len,
                 hd ** -0.5, 0, 1, stream)
        if err:
            raise RuntimeError(f"variant {name}: B1 launch failed, CUDA error {err}")

    def b7(name):
        fn = libs[name, "flash_attention"].aaclip_flash_attention
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out7.data_ptr(), 16, 8282, hd,
                 hd ** -0.5, 1, stream)
        if err:
            raise RuntimeError(f"variant {name}: B7 launch failed, CUDA error {err}")

    held = {}
    refs = {vl: pa.flash_mha_packed_reference(qkv, heads, hd ** -0.5, valid_len=vl)
            for vl in (None, 1300)}
    ref7 = fa.flash_mha_reference(q, k, v, hd ** -0.5)
    for name in names:
        errs = []
        for vl, ref in refs.items():
            b1(name, l if vl is None else vl)
            torch.cuda.synchronize()
            errs.append((bf16_error(out1, ref), bf16_close(out1, ref)))
        b7(name)
        torch.cuda.synchronize()
        errs.append((bf16_error(out7, ref7), bf16_close(out7, ref7)))
        held[name] = (all(ok for _, ok in errs), [e for e, _ in errs])
    times = {name: ([], []) for name in names}
    for name in names + names[::-1]:
        if held[name][0]:
            times[name][0].append(_time(lambda: b1(name), args.reps))
            times[name][1].append(_time(lambda: b7(name), max(1, args.reps // 2)))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    f1 = 4 * b * heads * l * l * hd
    f7 = 4 * 16 * 8282 * 8282 * hd
    for name in names:
        ok, errs = held[name]
        row = {"variant": name, "held": ok, "ulps": [[round(x, 3) for x in e] for e in errs],
               "card": card}
        if ok:
            m1 = sum(times[name][0]) / 2
            m7 = sum(times[name][1]) / 2
            row.update(b1_ms=m1, b1_runs=times[name][0], b1_tflops=f1 / m1 / 1e9,
                       b7b_ms=m7, b7b_runs=times[name][1], b7b_tflops=f7 / m7 / 1e9)
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
