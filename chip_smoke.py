#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (aa_clip_iqm_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases (each prints its lines; any failure exits nonzero before the last
line):
  1. device: needs CUDA; prints the card's name and power limit;
  2. build: compiles csrc/*.cu with nvcc (one process per source, in
     parallel) and prints the seconds;
  3. kernels: each hand-written kernel against its plain PyTorch twin at the
     main path's shapes in bf16 (largest and RMS error in bf16 ulps,
     ops/compare.py), with CUDA-event times of the kernel, the twin
     and one stock PyTorch call as a yardstick, and the bound from bytes and
     operations. Planted faults (a twin with its key tail unmasked, its
     biases dropped, the wrong activation; for the int8 MLP one hidden scale
     per row instead of per chunk, the c_fc weight scales dropped,
     round-half-away) must fail the same check;
  4. main path: AnomalyDetector on ViT-L-14-336 at 518 px with seeded random
     weights (dataset MVTec, bf16): builds the text anchors, answers predict
     at batch 1 and 8 and a mixed-class predict_multi, checks shapes, finite
     values and the kernels' launch counts (24 of each per vision forward),
     compares a batch-8 request with the same batch run through the twins
     (and shows that twins with a planted fault fail that comparison), and
     times batch-8 requests;
  5. int8 tiers: AnomalyDetector(quantize=t) for int8, int8_attn and
     int8_mlp, a batch-8 request each, with the launch counts each tier
     must show (the fused int8 MLP kernel where the MLP is quantized, the
     float one where it is not), the int8 map against the twins' and against
     the bf16 tier's, and batch-8 timings;
  6. sweep: evaluate_dataset at 518 px over an in-memory synthetic dataset of
     two classes, for the bf16 and the int8 tier; the device metrics must
     equal the host's on the fetched maps. Then the pixel metrics alone on
     random maps of the largest shipped class (3,714 images), for their time
     and peak memory.
Launch counts are set to 0 before each driven path and read after it. The
second-to-last line is a JSON object with one entry per kernel; the last
line is {"ok": true, "device": {...}}.
"""
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# Published peaks of one H100 SXM (dense bf16 and int8 tensor cores, HBM3).
PEAK_BF16_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12
PEAK_BYTES = 3.35e12

B, IMG, WIDTH, HEADS, HD = 8, 518, 1024, 16, 64
TOKENS = (IMG // 14) ** 2 + 1            # 1370
MAP_TOL = 4e-2                           # end to end: rms(diff) / std(twin map)
# The int8 tier's quantizers are discontinuous: wherever a kernel's rounding
# differs from its twin's in the last bit, a quantized activation downstream
# flips by a whole step of 1/127 now and then, and 24 blocks amplify that.
# Swapping B1 alone or B3 alone for its twin moves the tier's map by about
# 4e-2, B3 agreeing with its twin on all but 7e-4 of its elements. So the
# tier's map gets twice the room of the float tier's.
INT8_MAP_TOL = 8e-2
KERNELS = ("packed_attention", "ln_mlp_residual", "ln_mlp_residual_int8")
METRIC_TOL = 1e-4                        # device vs host AUROC / AP, in [0, 1]


class Failure(RuntimeError):
    pass


def log(msg=""):
    print(msg, flush=True)


def require(cond, msg):
    if not cond:
        raise Failure(msg)


def cuda_time(fn, reps):
    """Mean milliseconds per call over ``reps`` calls, CUDA events, after a
    warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(flops, nbytes, peak_ops=PEAK_BF16_FLOPS):
    t_ops, t_bytes = flops / peak_ops, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise Failure("torch.cuda.is_available() is false: this script needs a GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()
    card = smi[0].strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"# device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
        f"torch {torch.__version__} cuda {torch.version.cuda}")
    log(f"# nvidia-smi: {card}")
    return card


def phase_build():
    from aa_clip_iqm_tpu_torch.ops import _build

    names = list(KERNELS)
    t0 = time.perf_counter()
    seconds = _build.build(names)
    total = time.perf_counter() - t0
    log(f"# build: {total:.1f} s wall ({', '.join(f'{n} {s:.1f} s' for n, s in seconds.items())})")
    for name in names:
        for line in _build.BUILD_LOGS.get(name, "").splitlines():
            if "Used" in line or "spill" in line:
                log(f"#   {name}: {line.strip()}")


def hold(what, out, ref, base=None):
    """Hold a bf16 kernel output to its twin's (ops/compare.py); returns the
    max abs error."""
    import torch

    from aa_clip_iqm_tpu_torch.ops.compare import BF16_MAX_ULPS, BF16_RMS_ULPS, bf16_error

    torch.cuda.synchronize()
    max_ulps, rms_ulps = bf16_error(out, ref, base)
    err = (out.float() - ref.float()).abs().max().item()
    log(f"# {what}: max_abs_err {err:.3e}; ulps max {max_ulps:.2f} (tol {BF16_MAX_ULPS}), "
        f"rms {rms_ulps:.3f} (tol {BF16_RMS_ULPS})")
    require(torch.isfinite(out).all().item(), f"{what}: output not finite")
    require(max_ulps <= BF16_MAX_ULPS and rms_ulps <= BF16_RMS_ULPS,
            f"{what}: kernel disagrees with twin")
    return err


def planted(what, fault, ref, base=None):
    """A twin with a planted fault must fail the check that the kernel
    passes."""
    from aa_clip_iqm_tpu_torch.ops.compare import bf16_close, bf16_error

    max_ulps, rms_ulps = bf16_error(fault, ref, base)
    log(f"# planted fault, {what}: ulps max {max_ulps:.2f}, rms {rms_ulps:.3f}: "
        f"{'passed (NOT caught)' if bf16_close(fault, ref, base) else 'caught'}")
    require(not bf16_close(fault, ref, base), f"check missed planted fault: {what}")


def reset_counts():
    from aa_clip_iqm_tpu_torch.ops import fused_mlp, packed_attention as pa

    pa.reset_launches()
    fused_mlp.reset_launches()


def read_counts():
    from aa_clip_iqm_tpu_torch.ops import fused_mlp, packed_attention as pa

    return {"packed_attention": pa.LAUNCHES, "ln_mlp_residual": fused_mlp.LAUNCHES,
            "ln_mlp_residual_int8": fused_mlp.INT8_LAUNCHES}


def add_counts(total, got):
    for name in KERNELS:
        total[name] += got[name]


def int8_twin_variant(ln, mlp, x, act, chunk=None, drop_fc_scale=False,
                      half_away=False, eps=1e-5):
    """The B3 twin written out once more, with its planted faults: one hidden
    scale per row over ``chunk`` columns instead of the kernel's chunk, the
    c_fc weight scales dropped, or round-half-away for round-half-even.
    Without a fault it is the twin."""
    import torch

    from aa_clip_iqm_tpu_torch.ops.fused_mlp import hidden_chunk
    from aa_clip_iqm_tpu_torch.ops.layers import layer_norm
    from aa_clip_iqm_tpu_torch.ops.quant import int8_matmul

    def rnd(t):
        return torch.sign(t) * torch.floor(t.abs() + 0.5) if half_away else torch.round(t)

    def quantize_rows(t):
        scale = t.abs().amax(dim=-1, keepdim=True).clamp_min(1e-6) * (1.0 / 127.0)
        return torch.clamp(rnd(t / scale), -127, 127).to(torch.int8), scale

    c_fc, c_proj = mlp["c_fc"], mlp["c_proj"]
    d, h = x.shape[-1], c_fc["w_q"].shape[-1]
    ch = chunk or hidden_chunk(h)
    x32 = x.reshape(-1, d).float()
    x_q, sx = quantize_rows(layer_norm(ln, x32, eps=eps))
    s_fc = torch.ones(h, device=x.device) if drop_fc_scale else c_fc["scale"].reshape(h)
    acc = torch.zeros_like(x32)
    for j in range(0, h, ch):
        hid = int8_matmul(x_q, c_fc["w_q"][:, j:j + ch].contiguous()).float()
        h_q, sh = quantize_rows(act(hid * (sx * s_fc[j:j + ch]) + c_fc["b"][j:j + ch]))
        acc = acc + int8_matmul(h_q, c_proj["w_q"][j:j + ch]).float() * sh
    y = x32 + acc * c_proj["scale"].reshape(d) + c_proj["b"]
    return y.to(x.dtype).reshape(x.shape)


def mlp_int8_no_fc_scale(ln, mlp, x, act, eps=1e-5):
    """Planted fault for the end-to-end check: the B3 twin without the c_fc
    weight scales."""
    return int8_twin_variant(ln, mlp, x, act, drop_fc_scale=True, eps=eps)


def mlp_int8_row_scale(ln, mlp, x, act, eps=1e-5):
    """The B3 twin with one hidden scale per row over the whole hidden axis,
    to show what the end-to-end check cannot see."""
    return int8_twin_variant(ln, mlp, x, act, chunk=mlp["c_fc"]["w_q"].shape[-1], eps=eps)


def rounding_probe(ln, x):
    """Inputs on which round-half-even and round-half-away part ways: a zero
    LayerNorm scale makes every row's normalized input equal the LayerNorm
    bias, whose largest entry puts the row scale at exactly 2^-7 and whose
    other entries are odd multiples of 2^-8: every one of them divides to
    k + 0.5 exactly."""
    import torch

    d = x.shape[-1]
    top = torch.tensor(127.0 / 128.0, device=x.device)
    for _ in range(8):      # the float just at 127/128 whose scale is 2^-7
        if (top * (1.0 / 127.0)).item() == 2.0 ** -7:
            break
        top = torch.nextafter(top, torch.tensor(2.0, device=x.device))
    require((top * (1.0 / 127.0)).item() == 2.0 ** -7, "rounding probe: no exact row scale")
    k = torch.arange(d, device=x.device) % 8 - 4                 # -4 .. 3
    bias = (k.float() + 0.5) * 2.0 ** -7
    bias[0] = top
    return {"scale": torch.zeros_like(ln["scale"]), "bias": bias}


def phase_kernels():
    import torch
    import torch.nn.functional as F

    from aa_clip_iqm_tpu_torch.ops import fused_mlp, packed_attention as pa, quant
    from aa_clip_iqm_tpu_torch.ops.layers import gelu, layer_norm, quick_gelu

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1234)
    bf16 = torch.bfloat16
    results = {}

    # --- B1: packed attention at ViT-L/518, batch 8 ---------------------
    qkv = torch.randn((B, TOKENS, 3 * WIDTH), generator=gen, device=dev).to(bf16)
    scale = HD ** -0.5
    worst = 0.0
    for vv in (False, True):
        for valid_len in (None, 1360):
            out = pa.flash_mha_packed(qkv, HEADS, scale, vv=vv, valid_len=valid_len)
            ref = pa.flash_mha_packed_reference(qkv, HEADS, scale, vv=vv,
                                                valid_len=valid_len)
            worst = max(worst, hold(f"B1 packed_attention vv={vv} valid_len={valid_len}",
                                    out, ref))
    planted("B1 key tail unmasked", attn_tail_unmasked(qkv, HEADS, scale),
            pa.flash_mha_packed_reference(qkv, HEADS, scale))
    ms = cuda_time(lambda: pa.flash_mha_packed(qkv, HEADS, scale), 20)
    plain_ms = cuda_time(lambda: pa.flash_mha_packed_reference(qkv, HEADS, scale), 3)
    q, k, v = qkv.view(B, TOKENS, 3, HEADS, HD).permute(2, 0, 3, 1, 4)
    lib_ms = cuda_time(lambda: F.scaled_dot_product_attention(q, k, v, scale=scale), 20)
    flops = 4 * B * HEADS * TOKENS * TOKENS * HD
    nbytes = qkv.numel() * 2 + B * TOKENS * WIDTH * 2
    b_ms, b_by = bound(flops, nbytes)
    log(f"# B1 time: kernel {ms:.3f} ms, twin {plain_ms:.3f} ms, sdpa {lib_ms:.3f} ms, "
        f"bound {b_ms:.4f} ms ({b_by}; {flops:.3e} FLOP, {nbytes / 1e6:.1f} MB)")
    results["packed_attention"] = {
        "name": "packed_attention", "route": "cuda",
        "source": "aa_clip_iqm_tpu_torch/csrc/packed_attention.cu",
        "replaces": "aa_clip_iqm_tpu/ops/pallas_attention.py:88",
        "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
        "bound_by": b_by, "library_ms": lib_ms}
    del qkv, q, k, v, out, ref

    # --- B2: fused LN -> MLP -> residual ---------------------------------
    worst, timing = 0.0, None
    # (rows, d, h): the vision tower at batch 8, then the text tower over
    # MVTec's 240 prompt sentences of 77 tokens.
    for m, d, h in ((B * TOKENS, WIDTH, 4 * WIDTH), (240 * 77, 768, 3072)):
        def rnd(*shape, std=1.0):
            return torch.randn(shape, generator=gen, device=dev) * std
        ln = {"scale": 1.0 + 0.1 * rnd(d), "bias": 0.1 * rnd(d)}
        mlp = {"c_fc": {"w": rnd(d, h, std=d ** -0.5).to(bf16), "b": rnd(h, std=0.02)},
               "c_proj": {"w": rnd(h, d, std=h ** -0.5).to(bf16), "b": rnd(d, std=0.02)}}
        x = rnd(m, d).to(bf16)
        out = fused_mlp.ln_mlp_residual(ln, mlp, x, gelu)
        ref = fused_mlp.ln_mlp_residual_reference(ln, mlp, x, gelu)
        # Held on the MLP branch y - x: the residual x is the same in both.
        worst = max(worst, hold(f"B2 ln_mlp_residual M={m} d={d} h={h}", out, ref, x))
        if timing is None:
            no_bias = {n: {"w": p["w"], "b": torch.zeros_like(p["b"])} for n, p in mlp.items()}
            planted("B2 biases dropped",
                    fused_mlp.ln_mlp_residual_reference(ln, no_bias, x, gelu), ref, x)
            planted("B2 QuickGELU for exact GELU",
                    fused_mlp.ln_mlp_residual_reference(ln, mlp, x, quick_gelu), ref, x)
            ms = cuda_time(lambda: fused_mlp.ln_mlp_residual(ln, mlp, x, gelu), 20)
            plain_ms = cuda_time(
                lambda: fused_mlp.ln_mlp_residual_reference(ln, mlp, x, gelu), 5)
            xn = F.layer_norm(x, (d,))
            b_fc, b_proj = mlp["c_fc"]["b"].to(bf16), mlp["c_proj"]["b"].to(bf16)
            lib_ms = cuda_time(lambda: torch.addmm(
                b_proj, F.gelu(torch.addmm(b_fc, xn, mlp["c_fc"]["w"])),
                mlp["c_proj"]["w"]), 20)
            flops = 4 * m * d * h
            nbytes = 2 * m * d * 2 + 2 * d * h * 2 + (3 * d + h) * 4
            b_ms, b_by = bound(flops, nbytes)
            log(f"# B2 time: kernel {ms:.3f} ms, twin {plain_ms:.3f} ms, "
                f"addmm-gelu-addmm {lib_ms:.3f} ms, bound {b_ms:.4f} ms "
                f"({b_by}; {flops:.3e} FLOP, {nbytes / 1e6:.1f} MB)")
            timing = {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                      "bound_by": b_by, "library_ms": lib_ms}
    results["ln_mlp_residual"] = {
        "name": "ln_mlp_residual", "route": "cuda",
        "source": "aa_clip_iqm_tpu_torch/csrc/ln_mlp_residual.cu",
        "replaces": "aa_clip_iqm_tpu/ops/pallas_mlp.py:142",
        "max_abs_err": worst, **timing}
    del x, out, ref, mlp, xn

    # --- B3: fused LN -> int8 MLP -> residual at ViT-L/518, batch 8 --------
    m, d, h = B * TOKENS, WIDTH, 4 * WIDTH

    def rnd(*shape, std=1.0):
        return torch.randn(shape, generator=gen, device=dev) * std

    ln = {"scale": 1.0 + 0.1 * rnd(d), "bias": 0.1 * rnd(d)}
    mlp = {n: quant.quantize_linear_params(p) for n, p in (
        ("c_fc", {"w": rnd(d, h, std=d ** -0.5), "b": rnd(h, std=0.02)}),
        ("c_proj", {"w": rnd(h, d, std=h ** -0.5), "b": rnd(d, std=0.02)}))}
    x = rnd(m, d).to(bf16)
    worst = 0.0
    for act in (gelu, quick_gelu):
        out = fused_mlp.ln_mlp_residual_int8(ln, mlp, x, act)
        ref = fused_mlp.ln_mlp_residual_int8_reference(ln, mlp, x, act)
        torch.cuda.synchronize()
        differing = (out != ref).float().mean().item()
        worst = max(worst, hold(f"B3 ln_mlp_residual_int8 M={m} d={d} h={h} {act.__name__} "
                                f"({differing:.2e} of the elements differ)", out, ref, x))
    ref = fused_mlp.ln_mlp_residual_int8_reference(ln, mlp, x, gelu)
    require(torch.equal(int8_twin_variant(ln, mlp, x, gelu), ref),
            "the B3 twin's second transcription differs from the twin")
    planted("B3 one hidden scale per row (4096 wide) for one per 1024-wide chunk",
            int8_twin_variant(ln, mlp, x, gelu, chunk=h), ref, x)
    planted("B3 c_fc weight scales dropped",
            int8_twin_variant(ln, mlp, x, gelu, drop_fc_scale=True), ref, x)
    probe = rounding_probe(ln, x)
    ref_p = fused_mlp.ln_mlp_residual_int8_reference(probe, mlp, x, gelu)
    hold("B3 on the rounding probe (every input a tie)",
         fused_mlp.ln_mlp_residual_int8(probe, mlp, x, gelu), ref_p, x)
    planted("B3 round-half-away on the rounding probe",
            int8_twin_variant(probe, mlp, x, gelu, half_away=True), ref_p, x)
    ms = cuda_time(lambda: fused_mlp.ln_mlp_residual_int8(ln, mlp, x, gelu), 20)
    plain_ms = cuda_time(
        lambda: fused_mlp.ln_mlp_residual_int8_reference(ln, mlp, x, gelu), 3)
    xn = layer_norm(ln, x)
    lib_ms = cuda_time(lambda: quant.int8_linear(
        mlp["c_proj"], gelu(quant.int8_linear(mlp["c_fc"], xn))), 10)
    ops = 4 * m * d * h
    nbytes = 2 * m * d * 2 + 2 * d * h + (h + d) * 4 + (3 * d + h) * 4
    b_ms, b_by = bound(ops, nbytes, PEAK_INT8_OPS)
    log(f"# B3 time: kernel {ms:.3f} ms, twin {plain_ms:.3f} ms, unfused int8_linear-gelu-"
        f"int8_linear on torch._int_mm {lib_ms:.3f} ms, bound {b_ms:.4f} ms "
        f"({b_by}; {ops:.3e} int8 operations, {nbytes / 1e6:.1f} MB)")
    results["ln_mlp_residual_int8"] = {
        "name": "ln_mlp_residual_int8", "route": "cuda",
        "source": "aa_clip_iqm_tpu_torch/csrc/ln_mlp_residual_int8.cu",
        "replaces": "aa_clip_iqm_tpu/ops/pallas_mlp.py:161",
        "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
        "bound_by": b_by, "library_ms": lib_ms}
    return results


def attn_tail_unmasked(qkv, num_heads, scale, vv=False, valid_len=None):
    """Planted fault: the B1 twin with the zero-filled rows of the ragged
    last 64-key tile counted as keys."""
    from aa_clip_iqm_tpu_torch.ops.packed_attention import flash_mha_packed_reference

    b, l, c = qkv.shape
    padded = qkv.new_zeros((b, -(-l // 64) * 64, c))
    padded[:, :l] = qkv
    return flash_mha_packed_reference(padded, num_heads, scale, vv, valid_len)[:, :l]


def mlp_quick_gelu(ln, mlp, x, act, eps=1e-5):
    """Planted fault: the B2 twin with QuickGELU for whatever it was given."""
    from aa_clip_iqm_tpu_torch.ops.fused_mlp import ln_mlp_residual_reference
    from aa_clip_iqm_tpu_torch.ops.layers import quick_gelu

    return ln_mlp_residual_reference(ln, mlp, x, quick_gelu, eps)


class _Twins:
    """Route the port's three kernel call sites to their plain twins, or to
    the given stand-ins (used only to compare the main path against the
    twins)."""

    def __init__(self, attn=None, mlp=None, mlp_int8=None, keep_attn=False):
        self._attn, self._mlp, self._mlp_int8 = attn, mlp, mlp_int8
        self._keep_attn = keep_attn          # leave B1 on its kernel

    def __enter__(self):
        from aa_clip_iqm_tpu_torch.models import clip
        from aa_clip_iqm_tpu_torch.ops import attention, fused_mlp, packed_attention

        self._saved = (attention.flash_mha_packed, clip.ln_mlp_residual,
                       clip.ln_mlp_residual_int8)
        if not self._keep_attn:
            attention.flash_mha_packed = (self._attn
                                          or packed_attention.flash_mha_packed_reference)
        clip.ln_mlp_residual = self._mlp or fused_mlp.ln_mlp_residual_reference
        clip.ln_mlp_residual_int8 = (self._mlp_int8
                                     or fused_mlp.ln_mlp_residual_int8_reference)
        return self

    def __exit__(self, *exc):
        from aa_clip_iqm_tpu_torch.models import clip
        from aa_clip_iqm_tpu_torch.ops import attention

        (attention.flash_mha_packed, clip.ln_mlp_residual,
         clip.ln_mlp_residual_int8) = self._saved


def phase_main_path(card):
    import numpy as np
    import torch

    from aa_clip_iqm_tpu_torch.loader import build_model_config, init_trainable, random_backbone
    from aa_clip_iqm_tpu_torch.ops import fused_mlp, packed_attention as pa
    from aa_clip_iqm_tpu_torch.serving import AnomalyDetector

    t0 = time.perf_counter()
    cfg = build_model_config("ViT-L-14-336", img_size=IMG)
    frozen = random_backbone(cfg, seed=0, device="cuda", dtype=torch.bfloat16)
    trainable = init_trainable(cfg, seed=111, device="cuda", dtype=torch.bfloat16)
    torch.cuda.synchronize()
    log(f"# main path: ViT-L-14-336 @ {IMG}px, random weights in "
        f"{time.perf_counter() - t0:.1f} s")
    layers = cfg.clip.vision.layers
    rng = np.random.default_rng(7)

    def images(n):
        return rng.integers(0, 256, (n, 3, IMG, IMG), dtype=np.uint8)

    def check(maps, scores, n, what):
        require(maps.shape == (n, IMG, IMG), f"{what}: maps {maps.shape}")
        require(scores.shape == (n,), f"{what}: scores {scores.shape}")
        require(np.isfinite(maps).all() and np.isfinite(scores).all(),
                f"{what}: non-finite output")

    reset_counts()
    det = AnomalyDetector(frozen, trainable, cfg, "MVTec", img_size=IMG,
                          compute_dtype=torch.bfloat16, device="cuda")
    torch.cuda.synchronize()
    counts = read_counts()
    log(f"# anchors: {len(det.class_names())} classes, launches {counts}")
    require(counts == {"packed_attention": 0, "ln_mlp_residual": cfg.clip.text.layers,
                       "ln_mlp_residual_int8": 0}, f"anchor build launches {counts}")

    classes = det.class_names()
    requests = [("predict b1", images(1), ["bottle"]),
                ("predict b8", images(B), ["screw"] * B),
                ("predict_multi b5", images(5), [classes[i % len(classes)] for i in range(5)])]
    for what, imgs, names in requests:
        before = (pa.LAUNCHES, fused_mlp.LAUNCHES)
        if len(set(names)) == 1:
            maps, scores = det.predict(imgs, names[0])
        else:
            maps, scores = det.predict_multi(imgs, names)
        got = (pa.LAUNCHES - before[0], fused_mlp.LAUNCHES - before[1])
        log(f"# {what}: maps {maps.shape} in [{maps.min():.4f}, {maps.max():.4f}], "
            f"scores {np.round(scores, 4).tolist()}, launches B1 {got[0]} B2 {got[1]}")
        check(maps, scores, len(imgs), what)
        require(got == (layers, layers), f"{what}: launches {got}, want {layers} each")
        counts["packed_attention"] += got[0]
        counts["ln_mlp_residual"] += got[1]
    require(counts == read_counts(), "launch counts drifted")

    # The same batch-8 request through the twins, on the card; then through
    # twins with a planted fault, which the comparison must catch.
    imgs8 = images(B)
    maps_k, scores_k = det.predict(imgs8, "screw")
    with _Twins():
        before = (pa.LAUNCHES, fused_mlp.LAUNCHES)
        maps_t, scores_t = det.predict(imgs8, "screw")
        require(before == (pa.LAUNCHES, fused_mlp.LAUNCHES), "twin run launched a kernel")
    rel = map_diff(maps_k, maps_t)
    score_diff = float(np.abs(scores_k - scores_t).max())
    log(f"# kernels vs twins, batch 8 map: rms diff / std {rel:.3e} (tol {MAP_TOL:.0e}); "
        f"scores max abs diff {score_diff:.3e}")
    require(rel <= MAP_TOL, f"map differs from the twins' by {rel}")
    for what, twins in (("B1 key tail unmasked", _Twins(attn=attn_tail_unmasked)),
                        ("B2 QuickGELU", _Twins(mlp=mlp_quick_gelu))):
        with twins:
            rel_f = map_diff(det.predict(imgs8, "screw")[0], maps_t)
        log(f"# planted fault, {what}, batch 8 map: rms diff / std {rel_f:.3e}")
        require(rel_f > MAP_TOL, f"map comparison missed the planted fault: {what}")

    # Throughput and latency at batch 8 (host clock; each request ends in a
    # device-to-host copy of its maps).
    time_requests(det, imgs8, card, "bf16 tier")
    profile_request(det, imgs8)
    ctx = {"cfg": cfg, "frozen": frozen, "trainable": trainable, "det": det,
           "imgs8": imgs8, "maps_bf16": maps_k, "check": check}
    return counts, ctx


def time_requests(det, imgs, card, what, n=8):
    """Throughput and latency of batch requests (host clock; each request
    ends in a device-to-host copy of its maps)."""
    import numpy as np
    import torch

    lat = []
    for _ in range(n):
        t = time.perf_counter()
        det.predict(imgs, "screw")
        lat.append(time.perf_counter() - t)
    p50 = float(np.median(lat))
    log(f"# {what}, batch {len(imgs)}: {len(imgs) / p50:.2f} images/s, p50 {p50 * 1e3:.1f} ms "
        f"on {card} (median of {len(lat)} requests), peak memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.1f} GB")


def phase_int8_tiers(card, ctx):
    """AnomalyDetector(quantize=t) at full width and depth, a batch-8 request
    per tier, with the launch counts the tier must show."""
    import torch

    from aa_clip_iqm_tpu_torch.serving import AnomalyDetector

    cfg, imgs8 = ctx["cfg"], ctx["imgs8"]
    layers, text_layers = cfg.clip.vision.layers, cfg.clip.text.layers
    total = dict.fromkeys(KERNELS, 0)
    # Per vision forward: (B1, B2, B3).
    want = {"int8": (layers, 0, layers), "int8_attn": (layers, layers, 0),
            "int8_mlp": (layers, 0, layers)}
    for tier, (b1, b2, b3) in want.items():
        t0 = time.perf_counter()
        reset_counts()
        det = AnomalyDetector(ctx["frozen"], ctx["trainable"], cfg, "MVTec", img_size=IMG,
                              compute_dtype=torch.bfloat16, quantize=tier, device="cuda")
        torch.cuda.synchronize()
        got = read_counts()
        require(got == {"packed_attention": 0, "ln_mlp_residual": text_layers,
                        "ln_mlp_residual_int8": 0},
                f"{tier}: anchor build launches {got} (the text tower is never quantized)")
        maps, scores = det.predict(imgs8, "screw")
        got = read_counts()
        log(f"# tier {tier}: quantized and anchors built in {time.perf_counter() - t0:.1f} s; "
            f"batch-8 maps in [{maps.min():.4f}, {maps.max():.4f}], launches {got}")
        ctx["check"](maps, scores, B, f"tier {tier}")
        require(got == {"packed_attention": b1, "ln_mlp_residual": text_layers + b2,
                        "ln_mlp_residual_int8": b3}, f"tier {tier}: launches {got}")
        add_counts(total, got)
        rel_bf16 = map_diff(maps, ctx["maps_bf16"])
        log(f"# tier {tier} vs the bf16 tier, batch 8 map: rms diff / std {rel_bf16:.3e} "
            f"(random weights: a plumbing number, not an accuracy one)")
        if tier == "int8":
            with _Twins():
                before = read_counts()
                maps_t, scores_t = det.predict(imgs8, "screw")
                require(before == read_counts(), "twin run launched a kernel")
            with _Twins(keep_attn=True):
                maps_b1, _ = det.predict(imgs8, "screw")
            rel = map_diff(maps, maps_t)
            rel_b3 = map_diff(maps, maps_b1)
            log(f"# tier int8, kernels vs twins, batch 8 map: rms diff / std {rel:.3e} "
                f"(tol {INT8_MAP_TOL:.0e}); with only B3 swapped for its twin {rel_b3:.3e}; "
                f"with only B1 swapped {map_diff(maps_b1, maps_t):.3e}")
            require(rel <= INT8_MAP_TOL, f"int8 map differs from the twins' by {rel}")
            require(rel_b3 <= INT8_MAP_TOL, f"int8 map: B3 differs from its twin by {rel_b3}")
            with _Twins(mlp_int8=mlp_int8_no_fc_scale):
                rel_f = map_diff(det.predict(imgs8, "screw")[0], maps_t)
            log(f"# planted fault, B3 c_fc scales dropped, batch 8 map: rms diff / std {rel_f:.3e}")
            require(rel_f > INT8_MAP_TOL, "map comparison missed the planted fault in B3")
            # For the record: a fault as small as another hidden-scale grid
            # drowns in that amplification at map level; only the kernel
            # phase's ulp check sees it.
            with _Twins(mlp_int8=mlp_int8_row_scale):
                rel_f = map_diff(det.predict(imgs8, "screw")[0], maps_t)
            log(f"# B3 twin with one hidden scale per row, batch 8 map: rms diff / std "
                f"{rel_f:.3e} (not held: within the tier's noise)")
            ctx["det_int8"] = det
        time_requests(det, imgs8, card, f"tier {tier}")
        if tier == "int8":
            profile_request(det, imgs8)
        else:
            del det
    return total


class MemoryDataset:
    """One class of an in-memory test set with the interface the sweep reads
    (``__len__`` and ``batches``): textured uint8 images, the second half
    with painted blobs and their masks. numpy only."""

    def __init__(self, class_name, n, size, seed):
        import numpy as np

        from aa_clip_iqm_tpu_torch.data.synthetic import paint_defect

        rng = np.random.default_rng(seed)
        self.class_name, self.items = class_name, []
        base = rng.uniform(40, 140, 3)
        cells = -(-size // 8)
        for i in range(n):
            low = rng.uniform(0, 80, (8, 8, 3))
            img = np.kron(low, np.ones((cells, cells, 1)))[:size, :size] + base
            mask = np.zeros((size, size), np.uint8)
            if i >= n // 2:
                img, mask = paint_defect(rng, img, size)
            self.items.append((np.uint8(np.clip(img, 0, 255)).transpose(2, 0, 1),
                               (mask != 0).astype(np.float32)[None], int(i >= n // 2)))

    def __len__(self):
        return len(self.items)

    def batches(self, batch_size):
        import numpy as np

        for start in range(0, len(self.items), batch_size):
            part = self.items[start:start + batch_size]
            yield {"image": np.stack([p[0] for p in part]),
                   "mask": np.stack([p[1] for p in part]),
                   "label": np.asarray([p[2] for p in part], np.int64),
                   "file_name": [f"{self.class_name}/{start + i:03d}" for i in range(len(part))],
                   "class_name": [self.class_name] * len(part), "n_valid": len(part)}


def phase_sweep(card, ctx):
    """evaluate_dataset over an in-memory synthetic dataset, for the bf16 and
    the int8 tier; device metrics against the host's on the fetched maps."""
    import numpy as np
    import torch

    from aa_clip_iqm_tpu_torch.configs import EvalConfig
    from aa_clip_iqm_tpu_torch.evaluation import predict as ev
    from aa_clip_iqm_tpu_torch.ops.metrics import metrics_eval_raw

    cfg = ctx["cfg"]
    layers = cfg.clip.vision.layers
    sizes = {"bottle": 24, "screw": 19}      # 19 = 8 + 8 + a tail of 3 (bucket 4)
    datasets = {c: MemoryDataset(c, n, IMG, seed=i) for i, (c, n) in enumerate(sizes.items())}
    n_images = sum(sizes.values())
    batches = sum(-(-n // B) for n in sizes.values())
    eval_cfg = EvalConfig(dataset="MVTec", img_size=IMG, batch_size=B)
    total = dict.fromkeys(KERNELS, 0)
    for tier, det in (("none", ctx["det"]), ("int8", ctx["det_int8"])):
        shapes = []
        inner = ev.make_predict_fn

        def spying(*a, **k):
            fn = inner(*a, **k)

            def predict(frozen, trainable, images, anchors):
                shapes.append(images.shape[0])
                return fn(frozen, trainable, images, anchors)

            return predict

        reset_counts()
        ev.make_predict_fn = spying
        try:
            t0 = time.perf_counter()
            rows = ev.evaluate_dataset(det.frozen, det.trainable, cfg, eval_cfg, datasets,
                                       det.anchors, compute_dtype=torch.bfloat16)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
        finally:
            ev.make_predict_fn = inner
        got = read_counts()
        log(f"# sweep, tier {tier}: {n_images} images in {seconds:.2f} s = "
            f"{n_images / seconds:.2f} images/s on {card} (decode, predict and device "
            f"metrics), batches {shapes}, launches {got}")
        require(shapes == [8, 8, 8, 8, 8, 4], f"sweep batches {shapes}: tail bucket not used")
        mlp = "ln_mlp_residual_int8" if tier == "int8" else "ln_mlp_residual"
        want = dict.fromkeys(KERNELS, 0)
        want.update({"packed_attention": batches * layers, mlp: batches * layers})
        require(got == want, f"sweep tier {tier}: launches {got}, want {want}")
        add_counts(total, got)
        for line in ev.results_table(rows).splitlines():
            log(f"#   {line}")
        require([r["class name"] for r in rows] == list(sizes) + ["Average"], "sweep rows")
        predict_fn = ev.make_predict_fn(cfg, IMG, "Industrial", compute_dtype=torch.bfloat16)
        for row, (name, ds) in zip(rows, datasets.items()):
            preds = ev.predict_class(predict_fn, det.frozen, det.trainable, ds,
                                     det.anchors[name], B, device_resident=True)
            dev = ev.class_metrics_device(preds, name, "Industrial", defer=True)["_device"]
            dev = dev.cpu().numpy()
            host = metrics_eval_raw(preds["masks"].cpu().numpy(), preds["labels"],
                                    preds["maps"].cpu().numpy(),
                                    preds["image_scores"].cpu().numpy(), "Industrial",
                                    use_device=False)
            diff = float(np.abs(dev - np.asarray(host)).max())
            log(f"#   {name}: device metrics {np.round(dev, 6).tolist()}, host "
                f"{np.round(host, 6).tolist()}, max abs diff {diff:.2e} (tol {METRIC_TOL:.0e})")
            require(np.isfinite(dev).all() and ((dev >= 0) & (dev <= 1)).all(),
                    f"sweep {name}: metrics {dev}")
            require(diff <= METRIC_TOL, f"sweep {name}: device and host metrics differ by {diff}")
            for key, v in zip(ev.METRIC_KEYS, dev):
                require(abs(row[key] - round(float(v), 4) * 100) < 1e-9,
                        f"sweep {name}: row {key} {row[key]} is not the device metric {v}")
    return total


def phase_metrics_scale(card):
    """The pixel metrics alone at the size of the largest shipped class
    (Brain: 3,714 maps of 518 x 518): seconds and peak device memory."""
    import torch

    from aa_clip_iqm_tpu_torch.ops.metrics import DEFAULT_CHUNK, pixel_metrics_device

    n = 3714
    torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda").manual_seed(5)
    maps = torch.empty((n, IMG, IMG), device="cuda")
    masks = torch.empty((n, IMG, IMG), dtype=torch.bool, device="cuda")
    for i in range(0, n, 256):               # filled in slices: no second copy
        part = torch.rand((min(256, n - i), IMG, IMG), generator=gen, device="cuda")
        masks[i:i + 256] = part > 0.95
        maps[i:i + 256] = torch.rand(part.shape, generator=gen, device="cuda") + 0.3 * masks[i:i + 256]
    del part
    valid = torch.ones(n, dtype=torch.bool, device="cuda")
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    auc, ap, pmax = pixel_metrics_device(maps, masks, valid, n * IMG * IMG)
    auc, ap = float(auc), float(ap)
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    log(f"# pixel metrics at scale: {n} maps, {n * IMG * IMG:.3e} pixels, "
        f"{int(masks.sum())} positive, chunk {DEFAULT_CHUNK}: AUROC {auc:.6f}, AP {ap:.6f} in "
        f"{seconds:.2f} s on {card}; input {held / 1e9:.2f} GB, peak {peak / 1e9:.2f} GB "
        f"({(peak - held) / 1e9:.2f} GB beyond the input)")
    require(0.5 < auc < 1.0 and 0.0 < ap < 1.0 and pmax.shape == (n,), "metrics at scale")


def map_diff(maps, ref):
    """RMS of maps - ref over the standard deviation of ref: the maps share a
    large offset, so the difference is held to how much the maps vary."""
    import numpy as np

    d = maps.astype(np.float64) - ref
    return float(np.sqrt((d ** 2).mean()) / ref.std())


def profile_request(det, imgs):
    """Device time by kernel group for one batch-8 request (torch.profiler):
    where the time goes, and the device's idle share of the request."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        det.predict(imgs, "screw")
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    groups = {"B1 packed_attention": 0.0, "B2 ln_mlp_residual": 0.0,
              "B3 ln_mlp_residual_int8": 0.0, "GEMM (cuBLAS)": 0.0, "memcpy": 0.0,
              "other": 0.0}
    kernels = []
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        ms = evt.self_device_time_total / 1e3
        name = evt.key
        low = name.lower()
        if "packed_attention" in low:
            group = "B1 packed_attention"
        elif "ln_mlp_residual_int8" in low:
            group = "B3 ln_mlp_residual_int8"
        elif "ln_mlp_residual" in low:
            group = "B2 ln_mlp_residual"
        elif "memcpy" in low:
            group = "memcpy"
        elif any(k in low for k in ("gemm", "nvjet", "sm90_xmma", "cutlass", "imma", "i8816")):
            group = "GEMM (cuBLAS)"
        else:
            group = "other"
        groups[group] += ms
        kernels.append((ms, evt.count, name[:90]))
    busy = sum(groups.values())
    idle = 1.0 - busy / wall_ms
    log(f"# profile, one batch-{len(imgs)} request: wall {wall_ms:.1f} ms under the "
        f"profiler, device busy {busy:.1f} ms, idle share {idle:.3f}")
    for group, ms in groups.items():
        if ms:
            log(f"#   {group}: {ms:.2f} ms ({ms / busy:.1%} of device time)")
    for ms, count, name in sorted(kernels, reverse=True)[:8]:
        log(f"#   {ms:8.2f} ms x{count:<4d} {name}")


def main():
    t_start = time.perf_counter()
    try:
        card = phase_device()
        sys.path.insert(0, ROOT)
        import aa_clip_iqm_tpu_torch  # noqa: F401  (fails outside a checkout)

        phase_build()
        kernels = phase_kernels()
        launches, ctx = phase_main_path(card)
        add_counts(launches, phase_int8_tiers(card, ctx))
        add_counts(launches, phase_sweep(card, ctx))
        del ctx
        phase_metrics_scale(card)
        for name in KERNELS:
            require(launches[name] > 0, f"the driven paths never launched {name}")
    except (Failure, ImportError, RuntimeError, subprocess.CalledProcessError) as exc:
        log(f"# FAILED: {type(exc).__name__}: {exc}")
        return 1
    for name, entry in kernels.items():
        entry["launches"] = launches[name]
    import torch

    log(f"# total {time.perf_counter() - t_start:.1f} s")
    log(card)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    log(json.dumps({"kernels": [{k: e[k] for k in keys} for e in kernels.values()]}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                          "kind": torch.cuda.get_device_name(0),
                                          "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
