#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (aa_clip_iqm_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases (each prints its lines; any failure exits nonzero before the last
line):
  1. device: needs CUDA; prints the card's name and power limit;
  2. build: compiles csrc/*.cu with nvcc (one process per source, in
     parallel) and prints the seconds, each kernel's registers and spills,
     and the wgmma (HGMMA; IGMMA for int8) and UTMALDG (TMA load)
     instructions in the SASS of the eight sources on wgmma (B2, B8, B5 and
     EVA-02's S1 on the GEMM core, B3 on its int8 form, B4/B6, and B1 and B7
     on the attention walk), which must not be zero; then the native transform
     pipeline (data/native.py, g++ on the port's copy of the C++ source),
     which must build, against PIL at sizes that resize (the bicubic resize
     within one level, masks and the nearest warp exactly) and on 4
     threads against 1;
  3. kernels: each hand-written kernel (six forward, three backward) against
     its plain PyTorch twin at the main path's shapes in bf16 (largest and
     RMS error in bf16 ulps, ops/compare.py), with CUDA-event times of the
     kernel, the twin and one stock PyTorch call as a yardstick, and the
     bound from bytes and operations (with TFLOP/s for the attention
     kernels); B1's optional log-sum-exp against the plain logsumexp (1e-5
     relative to max(|lse|, 1)); B1, B7 and B8 also against the plain
     version of the attention walk (within 2 ulps), at valid_len None, 1300
     and 1 and at lengths about its 128-row and 128-key tiles (1, 63, 64,
     127, 129, 1370, 8282); B2, B3, B8, B5 and B4/B6 also against the
     plain version of their stages (B3's x_q and h_q within one step of
     its), B2 and B5 at ragged row counts, B4/B6 at
     batch 8 and 1 (B6: 2) with valid_len None and 1300, fed the forward's
     log-sum-exp, with each stage's device time
     (torch.profiler; a stage read at 0 ms is measured again, up to three
     times), and B2's two GEMMs at both tile widths.
     Planted faults (a twin with its key tail unmasked, its biases dropped,
     the wrong activation, the last k-slice of B2's hidden layer dropped,
     B2's rows past 1,280 left at zero; for the int8
     MLP one hidden scale per row instead of per chunk, the c_fc weight
     scales dropped, round-half-away, the hidden maximum taken over GEMM 1's
     128-wide tile instead of the chunk, the s32 accumulator carried across
     a chunk boundary unscaled; for the attention backward the key
     tail unmasked, the scale on dK dropped, D = 0 and the log-sum-exp taken
     over the keys that valid_len masks; for the MLP dx the wrong activation
     derivative, the LayerNorm backward without its mean terms, act' taken
     without b_fc and GEMM 3 without its last 64-deep k-slice; for the
     unpacked flash attention the key tail unmasked; for the attention
     walk the running rescale skipped and the ragged key tile left unmasked
     past valid_len 1300; for the value-value
     backward the key term dropped; for the fused attention half-block the
     out bias dropped and, under vv, q read from the q section) must fail
     the same check. B9, the int8 probe's kernel, in each of the sweep's
     (ep_bf16, ch) variants at M = 10,960, held to its plain version and its
     stages, and on a sign probe whose outputs the compare-free sign
     decides; planted there: copysign for that sign, an fp32 epilogue where
     bf16 was asked, ch 1024 where 2048 was asked. B2 at the other configs'
     widths (896/3584, 640/2560, 512/2048) and B1 at 14 heads over 1025
     tokens, held and timed;
 3b. EVA-02 (EVA02-CLIP-L-14-336 at 518 px, the cell offline-eva02l-518-b32):
     its three kernel entries at the cell's shapes, bf16, each held in bf16
     ulps to the stock calls it stands for and timed against them, with the
     bound from bytes and operations: S1, ln_swiglu_residual, at M = 10,960
     and 43,840 (batch 8 and 32), d 1024, h 2730, against the stock chain
     (LayerNorm, cuBLAS, SiLU, multiply, LayerNorm, cuBLAS, add) run in
     float32 on the same bf16 input and weights, and no further from it
     (RMS) than the same chain in bf16, which rounds more often; and
     against the plain version of its stages, with each stage's device
     time; its
     LayerNorm pass alone (LN1 and the attention sub-LN) at M = 43,840
     against layers.layer_norm; R1, rope_qk, at batch 32 (1,370 tokens, 16
     heads of 64) against its plain version. Planted faults: the sub-LN
     averaged over the padded hidden width, the rotation from the class row
     on, the rotation left off k. Then AnomalyDetector on seeded random
     EVA-02 weights at batch 32 (MVTec, one captured bucket): a mixed-class
     predict_multi, whose replay must run 24 B1, 24 S1, 48 LayerNorm passes
     and 24 R1 and whose forwards must count no stock-chain MLP
     (mlp.swiglu_chain 0); its map against the same batch through the plain
     versions (and against a planted fault, the rotation dropped); timings;
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
     two classes, for the bf16 and the int8 tier, its predict calls replayed
     as one CUDA graph a bucket (train/graphs.py): each replay's launches
     (24 B1 and 24 of the tier's MLP), the replays by bucket, the metrics of
     two sweeps on graphs against the eager sweep's to 1e-4, images/s of
     both; the device metrics must equal the host's on the fetched maps.
     Then the sweep over 48 PNGs at 600 px that the data layer resizes, on
     graphs, with the native transforms on and off at 1 and 4 decode
     threads. Then the pixel metrics alone on random maps of the largest
     shipped class (3,714 images), for their time and peak memory;
  7. training: run_training on a synthetic dataset of two classes written
     at 600 px (resized to 518 by the native transforms), ViT-L-14-336 at
     518 px, full depth, bf16 compute with float32 adapters: stage 1 for 2
     steps at batch 16, the anchors, stage 2 for 3 steps at batch 8, every
     feature batch and step a CUDA graph replay. Finite losses; each
     graph's replay measured launching 43 B1 + 43 B2 (stage-1 features), 12
     B2 (stage-1 step), 24 B1 + 24 B2 + 23 B4 + 23 B5 (stage-2 step); the
     replays and the optimizers' step counters are the steps taken; every
     trained tensor moved and every frozen one did not; a step checkpoint
     of the graphed run restores bit for bit, and a resume from the one
     after stage-2 step 1 captures anew and ends on the uninterrupted run's
     adapters; the first stage-2 step's gradients from the replay against
     the eager step, against the same step with the backward kernels
     swapped for their plain versions (and for a planted fault that the
     comparison must catch) and with every kernel swapped; checkpointed
     blocks give the same loss; one stage-2 step with the fused attention
     half-block (24 of it, 23 MLP dx, no attention backward kernel). Then,
     from one snapshot of the trained adapters and optimizer, 3 replays of
     a captured stage-2 step against 3 eager steps of the capturable
     optimizer at accum 1 and 2, with patch dropout and on the fused route
     (bit for bit where two eager runs agree bit for bit, else within
     1e-3), replays on stale inputs that must fail that gate, the
     capturable optimizer's update against the other's, and the same for
     stage 1 at batch 16 (features, losses, text adapter, moments);
     images/s of both stages on graphs and eagerly, and profiles of a
     replayed and an eager step (idle share, pool size, peak memory);
  8. fused attention (models.clip.FUSED_ATTN, AACLIP_FUSED_ATTN=1): a batch-8
     request at 518 px (24 fused blocks per vision forward, no packed
     attention), its map against the flag off and the twins, timings and a
     profile; one no-grad stage-1 feature batch of 16 (43 fused blocks);
  9. high resolution: AnomalyDetector at 1274 px (8,282 tokens, past the
     packed kernel's 8,192): requests at batch 1 and 2 through the unpacked
     flash kernel (24 per vision forward, no packed attention), the batch-2
     map against the twins (and a planted fault), timings and a profile;
 10. surgery backward: dual_vision_features at 518 px, batch 2, full depth,
     differentiated to a float32 image: the value-value backward once per
     surgery block and the packed backward once per shared-prefix block; the
     input's and every tap's gradient against the same backward with the
     value-value kernel alone swapped for its plain version (and for a
     planted fault);
 11. deploy: AnomalyDetector's per-bucket CUDA graphs against its eager
     program (det._predict) on the same padded input, bit for bit expected
     and held to 4e-2 (8e-2 for the int8 tiers): 518 px at batch 1, 8 and
     a mixed-class 5, the fused attention half at batch 8, 1274 px at batch
     2 and each int8 tier at batch 8, with the launches each replay runs; a
     planted fault (a replay whose copy-in is skipped) must fail; graph and
     eager images/s, p50 and idle share at batch 1 and 8; captures,
     replays and the graphs' memory. Then export_predictor for bf16 at
     buckets (1, 8) and the int8 tier at (8), each artifact loaded by
     ExportedPredictor in a fresh python3 (this script with
     --exported-child), held to the detector and counted launching the
     aaclip:: ops' CUDA implementations, with a planted fault (two classes'
     anchors swapped) that must fail; and a short HTTP window of
     cli.serve --exported (8 clients x 2 requests) against predict_multi;
 12. tools: the measuring and inspecting entry points on the main path's
     weights, in the process: the bench's latency mode (cli/bench.py
     measure_latency) at batch 1 and 8 on a detector's graphs, p50 and p95,
     each replay 24 B1 + 24 B2 (replay_launches), and the same detector
     under NaN checks running its eager program; the eval mode (eval_sweeps:
     anchors and evaluate_dataset over 48 synthetic PNGs, one timed sweep),
     metrics finite and in [0, 1]; the batch x route grid at batch 8, the
     stock PyTorch route (use_pallas=False: SDPA and the cuBLAS chain)
     moving no kernel counter and its map within MAP_TOL of the kernels',
     images/s of both; --profile_dir around an inference block, read back
     by the port's tools/trace_summary --device (each kernel of B1 and B2
     once a block a call; a directory without a trace must fail it); a
     train block at --accum 2 with finite losses; a stage-2 step under
     utils.profiling.enable_nan_checks, which must pass on a clean batch
     and raise FloatingPointError with one NaN pixel;
 13. models: ViT-B-16-plus-240 (seeded, full width, bf16) encode_image at
     batch 8 at 240 px (12 B2, no B1: 226 tokens take the plain attention)
     and 512 px (12 B1 + 12 B2), text_forward over MVTec's prompts (12 B2),
     each held to the stock route; RN50 at 224 px, batch 8: encode_image on
     cuDNN held to its float32 forward, its text tower (12 B2 at width 512)
     held to the stock route, and the same weights as an OpenAI RN .pt
     through the converter, bit for bit; images/s of each;
 14. repo tools: the port's int8_outlier_study --size flagship (every row
     landed), parity_run --random_backbone at 518 px (exit 0 on the default
     table, 1 on a shifted one, the int8 tier), and the three probes at
     their shapes, every B9 variant landed;
 15. serve: the main path's seeded ViT-L-14-336 weights at their native
     336 px grid written as an OpenAI-layout fp16 .pt, and seeded adapters
     written by the trainer's checkpoint writer and as the reference's
     text_adapter.pth / image_adapter_3.pth (imported back bit for bit);
     AnomalyDetector.from_checkpoint at 518 px twice, the first converting
     the .pt and writing <stem>.518.npz, the second reading it (both bit for
     bit the seeded weights rounded fp16 -> fp32 -> bf16, the positional
     embedding resized, and the saved adapters); predict_paths on 8 PNGs
     against predict on their decoded uint8 arrays, bit for bit; every
     bucket's graph captured; the HTTP server (cli.serve.make_server) over
     MicroBatchingService(max_batch=32, max_latency_ms=5) under 32 client
     threads of 2 requests each over 3 classes, half .npy and half JSON with
     a base64 PNG, and one /v1/predict_batch of 8, every map against
     predict_multi; requests/s, p50 and p99 latency, the device batches (the
     B1 launches their graph replays ran / 24) and their mean size, the same
     window on the eager program, and the idle share of the same traffic
     under the profiler;
     cli.single_image zero-shot (B1 in value-value mode) and from the
     checkpoint, each saved map against the same computation done directly;
 16. parallel (the port's multi-GPU paths, parallel/, on the one card, at
     ViT-L-14-336, 518 px, full width and depth, bf16, seeded weights):
     (a) a world-size-1 NCCL process group in this process, 3 stage-2 steps
     at batch 8 on its mesh replayed from a captured graph (the gradient
     all-reduce in it) against eager steps, bit for bit where two eager
     runs agree, and step ms of both; `torchrun --standalone
     --nproc_per_node 1 -m aa_clip_iqm_tpu_torch.cli.train --data_parallel
     --random_backbone` for 2 stage-2 steps at batch 8 on graphs against
     the same command without torchrun, run at once: losses and saved
     adapters bit for bit; (b) two gloo processes sharing the card
     (`--parallel-child`; NCCL refuses two ranks on one GPU): a DP stage-2
     step at global batch 8 and at 7 valid rows (4 and 3 a rank), the loss
     within 1e-4 and the gradients within 1e-3 of one process's step over
     the ranks' halves as two microbatches (GRAD_BWD_TOL of its whole-batch
     step), a planted fault (DDP's mean of the ranks' mean-loss gradients)
     that must fail; a DP evaluate_dataset over two in-memory classes,
     its table within 1e-6 of one process's; the gradients' gloo
     all-reduce ms; (c) predict at batch 8 with the backbone split over 2
     gloo ranks (n_model=2, B1 at 8 heads), the map within MAP_TOL of one
     process's, and a planted fault (the attention out-projection's
     all-reduce dropped) that must fail; a stage-2 step at batch 8 through
     the split backbone (24 B1 and 23 B4 on the local heads, no B2 or B5),
     its loss and gradients within GRAD_TOL of one process's. The children print their kernel
     counters (their parallel paths only) on a line each, and the phase
     adds them to the launches.
On the card every AnomalyDetector request replays the CUDA graph of its
bucket (captured at the bucket's first request, after a warm-up run), and
the training steps and the sweep's predict calls replay theirs
(train/graphs.py). The
kernels' counters count a launch where a wrapper launches its kernel, so a
bucket's warm-up and capture count and a replay does not. What a replay
runs is measured instead, once per graph: one replay under the profiler
must run the port's device kernels that the eager program runs on the
graph's buffers, as many times each, and the counters count the eager
run's launches (replay_launches); a request's launches are then its
graphs' replays times that (graph_request). Comparisons with the plain
twins run the eager program. Launch counts are set to 0 before each driven
path and read after it; the kernels' "launches" are the counters' totals,
replays not included. The second-to-last line is a JSON object with one
entry per kernel; the last line is {"ok": true, "device": {...}}.
"""
import base64
import contextlib
import copy
import io
import json
import os
import shutil
import subprocess
import sys
import time
import traceback
import weakref

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
# The CUDA sources (one nvcc each) and the kernels' rows: the value-value
# backward (B6) lives in packed_attention_bwd.cu beside B4.
SOURCES = ("packed_attention", "ln_mlp_residual", "ln_mlp_residual_int8",
           "packed_attention_bwd", "ln_mlp_residual_dx", "flash_attention",
           "ln_attn_residual", "ln_swiglu_residual", "rope_qk")
# The sources whose kernels run on wgmma fed by TMA (csrc/gemm_sm90.cuh):
# the GEMM core's B2, B8, B5 and S1 and its int8 form's B3, B4/B6's tile
# kernels, and the attention forward walk of B1 and B7
# (csrc/attention_fwd.cuh, B8's attention stage).
GEMM_SOURCES = ("ln_mlp_residual", "ln_attn_residual", "ln_mlp_residual_dx",
                "packed_attention_bwd", "packed_attention", "flash_attention",
                "ln_mlp_residual_int8", "ln_swiglu_residual")
# B3 runs on the core's int8 form: its SASS shows wgmma as IGMMA.
GMMA_FORM = {"ln_mlp_residual_int8": "IGMMA"}
# B9, the int8 probe's kernel, lives in ln_mlp_residual_int8.cu beside B3;
# S1's LayerNorm pass alone (EVA-02's LN1 and attention sub-LN) is a second
# entry of ln_swiglu_residual.cu.
KERNELS = ("packed_attention", "ln_mlp_residual", "ln_mlp_residual_int8",
           "packed_attention_bwd", "ln_mlp_residual_dx", "packed_attention_vv_bwd",
           "flash_attention", "ln_attn_residual", "ln_mlp_residual_int8_probe",
           "ln_swiglu_residual", "ln_swiglu_residual_layer_norm", "rope_qk")
# EVA02-CLIP-L-14-336 (phase 3b): the offline cell's batch, the MLP's hidden
# width (2730, padded to 2816 inside S1) and the LayerNorms' eps.
EVA_MODEL, EVA_B, EVA_HIDDEN, EVA_EPS = "EVA02-CLIP-L-14-336", 32, 2730, 1e-6
HR_IMG = 1274                            # ViT-L/14 at 91 x 91 patches
HR_TOKENS = (HR_IMG // 14) ** 2 + 1      # 8282, past the packed kernel's 8192
# The 1274 px map against its twins', as the 518 px one: the kernels' own
# rounding reads 2e-2 to 3e-2 at both sizes, a planted fault several times that.
HR_MAP_TOL = 4e-2
# The surgery backward with only B6 swapped for its plain version: the
# forward is shared, so only B6's own rounding is left (PR 3's rule).
SURGERY_TOL = 1e-2
DEVICE = "cuda"                          # the training phase's device
GRAD_TOL = 5e-2                          # per tensor: rms(diff) / rms(plain gradient)
# The same with only the backward kernels swapped for their plain versions:
# the forward is shared, so only the backward kernels' own rounding is left
# (a few 1e-3), and a planted fault in the MLP dx (3e-2 to 4e-2 on this
# random backbone, whose MLP branch is small beside the residual) stands out.
GRAD_BWD_TOL = 1e-2
# Graph replays against eager steps where two eager runs do not agree bit for
# bit: rms(diff) / rms per tensor (losses, updated tensors, optimizer state).
REPLAY_TOL = 1e-3
# The capturable optimizer's update against that of the one that is not,
# per element, relative to the update, beyond two float32 roundings of the
# parameter: the capturable step computes its bias corrections in float32
# on the device (about 1e-5 relative at the steps run here), the other in
# float64 on the host.
UPDATE_TOL = 1e-4
METRIC_TOL = 1e-4                        # device vs host AUROC / AP, in [0, 1]
# B1's log-sum-exp against the plain logsumexp of the masked scaled scores,
# relative: both are fp32 sums of the same exponentials in other orders.
LSE_TOL = 1e-5
# The serve phase: the OpenAI checkpoint's own grid (24 x 24 patches, 577
# positional rows) that the loader resizes to 518 px; 32 HTTP clients of 2
# requests each over three classes; every HTTP call and future waits at most
# SERVE_TIMEOUT seconds.
SERVE_MODEL, NATIVE_IMG = "ViT-L-14-336", 336
SERVE_CLASSES = ("bottle", "screw", "carpet")
SERVE_CLIENTS, SERVE_REQUESTS = 32, 2
SERVE_TIMEOUT = 300
# The models phase: each bf16 route (the kernels' and the stock PyTorch
# one, use_pallas=False) against the float32 stock forward, as rms(diff) /
# rms(reference) of the embeddings. On an H100 (NVIDIA H100 80GB HBM3,
# 700.00 W) the sound routes read 9.75e-3 to 1.20e-2 (RN50's cuDNN tower
# 4.5e-3), the kernels' route 0.934 to 1.009 times the stock route's; the
# control, the kernels' route with QuickGELU for GELU, 1.40e-2 to 1.67e-2,
# 1.343 to 1.408 times the stock route's. bf16 rounding alone is worth
# about 1e-2 on these seeded weights, so MODEL_TOL bounds both routes and
# MODEL_RATIO, between the two ratios, is the gate the control must fail.
MODEL_TOL = 2e-2
MODEL_RATIO = 1.2
# The probes' reported errors (max |diff| relative to the reference's
# largest value), bounded about a third above what an H100 read on these
# seeded inputs: the sweep's 24-layer int8 chain against the float chain, 3.39e-2
# (fp32 epilogue) and 3.81e-2 (bf16); probe_mlp_int8's one int8 layer
# against the bf16 one, 1.46e-2; probe_attn_fused's 24-layer fused chain
# against the unfused one, 1.15e-2 to 1.89e-2. They bound the tools'
# reports; the kernels are held at the probes' shapes to their plain
# versions.
SWEEP_TOL = 5e-2
PROBE_MLP_TOL = 2e-2
PROBE_ATTN_TOL = 2.5e-2


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


# The stage profiles measured again after lost records (stage_times).
STAGE_RETRIES = []


def stage_times(what, fn, stages, reps=5):
    """Device ms per call of each stage kernel of ``fn`` (torch.profiler
    over ``reps`` calls), found by a part of its name; ``stages`` maps that
    part to (label, "flop", "ops" (int8) or "bytes", the amount one call
    does), from which the stage's rate is printed."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    # The profiler now and then loses a stage's records, so a stage read at
    # 0 ms is measured again, up to three times in all (as replay_launches).
    for attempt in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        ms = dict.fromkeys(stages, 0.0)
        for evt in prof.key_averages():
            if evt.device_type == torch.autograd.DeviceType.CUDA:
                for part in stages:
                    if part in evt.key:
                        ms[part] += evt.self_device_time_total / 1e3 / reps
        missing = [part for part in stages if ms[part] <= 0]
        if not missing:
            break
        STAGE_RETRIES.append(what)
        log(f"# {what} stages, measurement {attempt + 1}: the profiler saw no "
            f"{', '.join(missing)} kernel")
    parts = []
    for part, (label, kind, amount) in stages.items():
        require(ms[part] > 0, f"{what}: the profiler saw no {part} kernel in 3 measurements")
        rate = {"flop": f"{amount / ms[part] / 1e9:.1f} TFLOP/s",
                "ops": f"{amount / ms[part] / 1e9:.1f} TOP/s",
                "bytes": f"{amount / ms[part] / 1e6:.1f} GB/s"}[kind]
        parts.append(f"{label} {ms[part]:.4f} ms ({rate})")
    log(f"# {what} stages (device ms a call, torch.profiler over {reps} calls): "
        f"{'; '.join(parts)}; sum {sum(ms.values()):.4f} ms")
    return ms


def gemm_tiles(ln, mlp, x):
    """B2's two GEMMs through the core alone at both tile widths, in turns
    (128, 256, 256, 128): the measurement behind the core's choice of 256
    where N allows it."""
    import torch

    from aa_clip_iqm_tpu_torch.ops import gemm
    from aa_clip_iqm_tpu_torch.ops.layers import gelu, layer_norm

    c_fc, c_proj = mlp["c_fc"], mlp["c_proj"]
    xin = layer_norm(ln, x)
    hid = gemm.gemm_bias_act(xin, c_fc["w"], c_fc["b"], gelu)
    m, d = x.shape
    flop = 2 * m * d * hid.shape[-1]
    times = {1: {128: [], 256: []}, 2: {128: [], 256: []}}
    for tile in (128, 256, 256, 128):
        times[1][tile].append(cuda_time(
            lambda: gemm.gemm_bias_act(xin, c_fc["w"], c_fc["b"], gelu, tile), 10))
        times[2][tile].append(cuda_time(
            lambda: gemm.gemm_bias_residual(hid, c_proj["w"], c_proj["b"], x, tile), 10))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for which, (n, k) in ((1, (hid.shape[-1], d)), (2, (d, hid.shape[-1]))):
        cells = []
        for tile in (128, 256):
            ms = sum(times[which][tile]) / 2
            tiles = -(-m // 128) * (n // tile)
            cells.append(f"{tile} wide {ms:.4f} ms ({flop / ms / 1e9:.1f} TFLOP/s, {tiles} tiles "
                         f"= {tiles / sms:.2f} waves on {sms} SMs)")
        log(f"# GEMM core, B2's GEMM {which} (M={m}, N={n}, K={k}): {'; '.join(cells)}")


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

    names = list(SOURCES)
    t0 = time.perf_counter()
    seconds = _build.build(names)
    total = time.perf_counter() - t0
    log(f"# build: {total:.1f} s wall ({', '.join(f'{n} {s:.1f} s' for n, s in seconds.items())})")
    for name in names:
        for entry, regs, spill in ptxas_entries(_build.BUILD_LOGS.get(name, "")):
            log(f"#   {name}: {entry}: {regs}; {spill}")
    # The kernels on the GEMM core and B4/B6 must really run on wgmma fed by
    # TMA: the bf16 form of the tensor-core instruction (HGMMA), or for B3
    # the integer one (IGMMA).
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    for name in GEMM_SOURCES:
        sass = subprocess.run([cuobjdump, "-sass", _build._paths(name)[1]], capture_output=True,
                              text=True, check=True).stdout
        gmma = GMMA_FORM.get(name, "HGMMA")
        counts = {op: sum(op in line for line in sass.splitlines())
                  for op in (gmma, "GMMA", "UTMALDG")}
        log(f"# SASS of {name}: {counts[gmma]} {gmma} ({counts['GMMA']} of any GMMA form), "
            f"{counts['UTMALDG']} UTMALDG")
        require(counts[gmma] > 0 and counts["UTMALDG"] > 0,
                f"{name}: no {gmma} (wgmma) or no TMA load in its SASS")


def ptxas_entries(build_log):
    """(kernel, registers, spills) per entry function in nvcc's -Xptxas -v
    output, the kernel's name demangled by cu++filt where the toolkit has
    it."""
    import re

    entries, entry, spill = [], None, ""
    for line in build_log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            entry = m.group(1)
        elif "spill stores" in line:
            spill = line.strip()
        elif "Used" in line and entry:
            entries.append((entry, line.split(":", 1)[-1].strip(), spill))
            entry, spill = None, ""
    filt = shutil.which("cu++filt") or "/usr/local/cuda/bin/cu++filt"
    names = [e[0] for e in entries]
    if names and os.path.isfile(filt):
        out = subprocess.run([filt], input="\n".join(names), capture_output=True, text=True)
        if out.returncode == 0 and len(out.stdout.splitlines()) == len(names):
            names = [re.sub(r"\(\w+\)|<unnamed>::|\(anonymous namespace\)::|^void ", "", n)
                     .split("(")[0] for n in out.stdout.splitlines()]
    return [(n[:100], regs, spill) for n, (_, regs, spill) in zip(names, entries)]


def hold(what, out, ref, base=None, max_tol=None):
    """Hold a bf16 kernel output to its twin's (ops/compare.py), the largest
    error to ``max_tol`` ulps where given; returns the max abs error."""
    import torch

    from aa_clip_iqm_tpu_torch.ops.compare import BF16_MAX_ULPS, BF16_RMS_ULPS, bf16_error

    max_tol = BF16_MAX_ULPS if max_tol is None else max_tol
    torch.cuda.synchronize()
    max_ulps, rms_ulps = bf16_error(out, ref, base)
    err = (out.float() - ref.float()).abs().max().item()
    log(f"# {what}: max_abs_err {err:.3e}; ulps max {max_ulps:.2f} (tol {max_tol}), "
        f"rms {rms_ulps:.3f} (tol {BF16_RMS_ULPS})")
    require(torch.isfinite(out).all().item(), f"{what}: output not finite")
    require(max_ulps <= max_tol and rms_ulps <= BF16_RMS_ULPS,
            f"{what}: kernel disagrees with twin")
    return err


def hold_walk(what, out, stages, base=None):
    """Hold an attention forward to the plain version of its tile walk
    (flash_attention.attention_fwd_stages), within WALK_MAX_ULPS."""
    from aa_clip_iqm_tpu_torch.ops.compare import WALK_MAX_ULPS

    return hold(what, out, stages, base, WALK_MAX_ULPS)


def hold_lse(what, lse, want):
    """B1's log-sum-exp against the plain logsumexp, to LSE_TOL relative to
    max(|want|, 1): a row whose only key is real (valid_len 1) has the one
    scaled score as its log-sum-exp, which can lie near 0, and the tensor
    cores' fp32 sum of its 64 products is exact only to the products' scale."""
    import torch

    torch.cuda.synchronize()
    rel = ((lse - want).abs() / want.abs().clamp_min(1.0)).max().item()
    log(f"# {what}: max error relative to max(|lse|, 1) {rel:.3e} (tol {LSE_TOL:.0e})")
    require(torch.isfinite(lse).all().item() and rel <= LSE_TOL, f"{what}: off by {rel}")


def tflops(flops, ms):
    return f"{flops / ms / 1e9:.1f} TFLOP/s"


def planted(what, fault, ref, base=None):
    """A twin with a planted fault must fail the check that the kernel
    passes."""
    from aa_clip_iqm_tpu_torch.ops.compare import bf16_close, bf16_error

    max_ulps, rms_ulps = bf16_error(fault, ref, base)
    log(f"# planted fault, {what}: ulps max {max_ulps:.2f}, rms {rms_ulps:.3f}: "
        f"{'passed (NOT caught)' if bf16_close(fault, ref, base) else 'caught'}")
    require(not bf16_close(fault, ref, base), f"check missed planted fault: {what}")


def reset_counts():
    from aa_clip_iqm_tpu_torch.ops import attn_block, flash_attention, fused_mlp, rope, swiglu
    from aa_clip_iqm_tpu_torch.ops import packed_attention as pa

    pa.reset_launches()
    fused_mlp.reset_launches()
    flash_attention.reset_launches()
    attn_block.reset_launches()
    swiglu.reset_launches()
    rope.reset_launches()


def read_counts():
    from aa_clip_iqm_tpu_torch.ops import attn_block, flash_attention, fused_mlp, rope, swiglu
    from aa_clip_iqm_tpu_torch.ops import packed_attention as pa

    return {"packed_attention": pa.LAUNCHES, "ln_mlp_residual": fused_mlp.LAUNCHES,
            "ln_mlp_residual_int8": fused_mlp.INT8_LAUNCHES,
            "packed_attention_bwd": pa.BWD_LAUNCHES,
            "ln_mlp_residual_dx": fused_mlp.DX_LAUNCHES,
            "packed_attention_vv_bwd": pa.VV_BWD_LAUNCHES,
            "flash_attention": flash_attention.LAUNCHES,
            "ln_attn_residual": attn_block.LAUNCHES,
            "ln_mlp_residual_int8_probe": fused_mlp.PROBE_LAUNCHES,
            "ln_swiglu_residual": swiglu.LAUNCHES,
            "ln_swiglu_residual_layer_norm": swiglu.LN_LAUNCHES,
            "rope_qk": rope.LAUNCHES}


def diff_counts(after, before):
    return {n: after[n] - before[n] for n in KERNELS}


def counts_of(**launched):
    """A full launch-count dict: zero but for the kernels named."""
    return {**dict.fromkeys(KERNELS, 0), **launched}


def add_counts(total, got):
    for name in KERNELS:
        total[name] += got[name]


def port_kernels(fn):
    """Run ``fn`` under torch.profiler; return the port's device kernels it
    ran (those kernel_group files under a kernel), as {name: times}."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from aa_clip_iqm_tpu_torch.tools.trace_summary import kernel_group

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {evt.key: evt.count for evt in prof.key_averages()
            if evt.device_type == torch.autograd.DeviceType.CUDA
            and kernel_group(evt.key).split()[-1] in KERNELS}


# Launches per replay, measured once per captured graph.
_PER_REPLAY = weakref.WeakKeyDictionary()


def replay_launches(det, key):
    """The kernel launches that one replay of ``det``'s graph ``key`` runs,
    measured: the graph replayed under the profiler must run the port's
    device kernels that the eager program runs on the graph's own buffers,
    each as many times, and the counters count the eager run's launches (a
    replay moves no counter)."""
    from aa_clip_iqm_tpu_torch.models import clip as clip_mod

    g = det._graphs[key]
    if g in _PER_REPLAY:
        return _PER_REPLAY[g]
    require(key[2] == clip_mod.FUSED_ATTN, f"graph {key}: FUSED_ATTN has changed")
    # The profiler now and then loses a few kernel records of a run, so a
    # disagreement is measured again, up to three times in all.
    for attempt in range(3):
        with det._graph_lock:
            replayed = port_kernels(g.graph.replay)
        before = read_counts()
        eager = port_kernels(lambda: det._predict(det.frozen, det.trainable, g.images, g.anchors))
        launched = diff_counts(read_counts(), before)
        if replayed and replayed == eager:
            _PER_REPLAY[g] = launched
            return launched
        log(f"# graph {key}, measurement {attempt + 1}: a replay ran the port's kernels "
            f"{sorted(replayed.values())} times, the eager program "
            f"{sorted(eager.values())}")
    raise Failure(f"graph {key}: a replay ran the port's kernels {replayed}, the eager "
                  f"program {eager}")


def graph_request(det, fn):
    """Run ``fn`` (requests to ``det``; each a graph replay, the first of a
    bucket after its warm-up and capture) and return (its result, the kernel
    launches its replays ran): each graph's replays in the call times its
    launches per replay (replay_launches)."""
    def replays():
        with det._graph_lock:
            return {key: g.replays for key, g in det._graphs.items()}

    before = replays()
    out = fn()
    ran = counts_of()
    for key, n in replays().items():
        n -= before.get(key, 0)
        if n:
            add_counts(ran, {k: v * n for k, v in replay_launches(det, key).items()})
    return out, ran


def log_graphs(det, what):
    """Captures, replays and launches per replay of each of ``det``'s graphs,
    and the device memory of their shared pool."""
    stats = det.graph_stats()
    for key, g in zip(list(det._graphs), stats):      # graph_stats() keeps their order
        per = {k: v for k, v in replay_launches(det, key).items() if v}
        log(f"# graphs, {what}: bucket {g['bucket']} {g['dtype']} fused_attn "
            f"{g['fused_attn']}: 1 capture ({g['capture_s']:.2f} s with its warm-up, the "
            f"pool grown by {g['pool_bytes'] / 1e9:.3f} GB), {g['replays']} replays, "
            f"launches per replay {per} (measured)")
    log(f"# graphs, {what}: {len(stats)} graphs holding {det.graph_memory() / 1e9:.3f} GB "
        "of device memory in their pool")
    return stats


class _Eager:
    """Run AnomalyDetector requests through the eager program instead of
    the bucket's graph (the detector's ``_run_eager``)."""

    def __enter__(self):
        from aa_clip_iqm_tpu_torch.serving import AnomalyDetector

        self._saved = AnomalyDetector._run
        AnomalyDetector._run = AnomalyDetector._run_eager
        return self

    def __exit__(self, *exc):
        from aa_clip_iqm_tpu_torch.serving import AnomalyDetector

        AnomalyDetector._run = self._saved


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


def int8_stages_carry(ln, mlp, x, act, eps=1e-5):
    """Planted fault for B3's GEMM 2: the plain stages with the s32
    accumulator carried from chunk to chunk instead of restarted, so each
    chunk's fold scales the products of every chunk before it by its sh."""
    import torch

    from aa_clip_iqm_tpu_torch.ops.fused_mlp import hidden_chunk, ln_mlp_residual_int8_stages
    from aa_clip_iqm_tpu_torch.ops.quant import int8_matmul

    st = ln_mlp_residual_int8_stages(ln, mlp, x, act, eps)
    c_proj = mlp["c_proj"]
    d, h = x.shape[-1], mlp["c_fc"]["w_q"].shape[-1]
    ch = hidden_chunk(h)
    x32 = x.reshape(-1, d).float()
    f = torch.zeros_like(x32)
    carried = torch.zeros(x32.shape, dtype=torch.int32, device=x.device)
    for i, j in enumerate(range(0, h, ch)):
        carried = carried + int8_matmul(st["h_q"][:, j:j + ch].contiguous(), c_proj["w_q"][j:j + ch])
        f = f + carried.float() * st["sh"][:, i:i + 1]
    y = x32 + f * c_proj["scale"].reshape(d) + c_proj["b"]
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


def gelu_nocmp_copysign(u):
    """Planted fault for B9: the probe's fp32 GELU with its compare-free sign
    x / (|x| + 1e-3) taken as copysign(1, x)."""
    import torch

    from aa_clip_iqm_tpu_torch.ops import fused_mlp

    x = u * torch.tensor(fused_mlp._SQRT_HALF, dtype=u.dtype)
    erf = torch.copysign(torch.ones_like(x), x) * fused_mlp.erf_as(x.abs())
    return 0.5 * u * (1.0 + erf)


def sign_probe(mlp, x):
    """Inputs on which B9's compare-free sign decides the output: c_fc's
    bias lowered by 4 puts the fp32 pre-activations in GELU's negative
    tail, where 1 + erf cancels and the sign's 1e-3 outweighs it; c_proj's
    bias zeroed and its scales raised 2^12, and x scaled by 2^-10 (which
    LayerNorm does not see), make the MLP branch the whole output, so the
    hold sees it. Returns (mlp, x)."""
    import torch

    fc = dict(mlp["c_fc"], b=mlp["c_fc"]["b"] - 4.0)
    proj = dict(mlp["c_proj"], b=torch.zeros_like(mlp["c_proj"]["b"]),
                scale=mlp["c_proj"]["scale"] * 2.0 ** 12)
    return {"c_fc": fc, "c_proj": proj}, x * 2.0 ** -10


def hold_int8_probe(what, ln, mlp, x, ep, ch):
    """B9 in one (ep_bf16, ch) variant held to the plain version: its GEMMs
    on its own row pass (x_q, sx), y in bf16 ulps and h_q within one step;
    x_q within one step of the plain stages', on all but 1e-5 of its
    elements; h_q within one step of theirs and the whole in bf16 ulps.
    Where the LayerNorm's fp32 sums, taken in another order, flip an x_q,
    the row's hidden values move; with the bf16 epilogue one of them may
    move its chunk's bf16 maximum by an ulp, which requantizes the whole
    (row, chunk): h_q then moves by more than a step and y by up to 8.5
    ulps on an H100. An sx one fp32 ulp off does the same to h_q, though
    not to y. So with the bf16 epilogue the rows with a flipped x_q are
    held on the kernel's own row pass only (above, where the flip is the
    kernel's input), h_q is held to the plain stages on the rows whose x_q
    and sx both agree, y on those whose x_q agrees, and the RMS over all
    rows stays within its tolerance. Returns (out, ref, max abs error)."""
    import torch

    from aa_clip_iqm_tpu_torch.ops import fused_mlp
    from aa_clip_iqm_tpu_torch.ops.compare import BF16_RMS_ULPS, bf16_error

    got = fused_mlp.ln_mlp_residual_int8_probe(ln, mlp, x, ep, ch, stages=True)
    out = got["y"]
    ref = fused_mlp.ln_mlp_residual_int8_probe_reference(ln, mlp, x, ep, ch)
    st = fused_mlp.ln_mlp_residual_int8_probe_stages(ln, mlp, x, ep, ch)
    require(torch.equal(st["y"], ref), f"{what}: its stages' y differs from its plain y")
    torch.cuda.synchronize()
    differing = (out != ref).float().mean().item()
    # What is left on the kernel's own row pass is GEMM 2's fp32 fold order.
    own = fused_mlp.ln_mlp_residual_int8_probe_stages(ln, mlp, x, ep, ch,
                                                      rows=(got["x_q"], got["sx"]))
    hold(f"{what} against the plain version of GEMM 1 and GEMM 2 on its own row pass",
         out, own["y"], x)
    require((got["h_q"].int() - own["h_q"].int()).abs().max().item() <= 1,
            f"{what}: h_q off its own row pass's by more than one step")
    x_q_flips = (got["x_q"] != st["x_q"]).float().mean().item()
    require((got["x_q"].int() - st["x_q"].int()).abs().max().item() <= 1 and x_q_flips <= 1e-5,
            f"{what}: x_q differs from the plain row pass's on {x_q_flips:.2e} of its elements "
            f"or by more than one step")
    # The rows held to the plain version itself: all, or with the bf16
    # epilogue y on those whose x_q agrees with the plain row pass's and h_q
    # on those whose sx agrees too (an sx one fp32 ulp off moves a bf16
    # rounding of the hidden values, and with it the chunk's maximum).
    rows = len(out)
    full = torch.ones(rows, dtype=torch.bool, device=out.device)
    same = (got["x_q"] == st["x_q"]).all(dim=-1) if ep else full
    same_sx = (same & (got["sx"].reshape(rows, -1) == st["sx"].reshape(rows, -1)).all(dim=-1)
               if ep else full)
    h_q_diff = (got["h_q"][same_sx].int() - st["h_q"][same_sx].int()).abs()
    log(f"# {what} against the plain version of its stages: x_q {x_q_flips:.3e} differ; "
        f"h_q {(h_q_diff > 0).float().mean().item():.3e} differ, by at most "
        f"{h_q_diff.max().item()}, on the {int(same_sx.sum())} rows held "
        f"({rows - int(same.sum())} rows with a flipped x_q, "
        f"{int((same & ~same_sx).sum())} more with another sx)")
    require(h_q_diff.max().item() <= 1, f"{what}: h_q off by more than one step")
    err = (out.float() - ref.float()).abs().max().item()
    if not ep:
        hold(f"{what} against its plain version ({differing:.2e} of the elements differ)",
             out, ref, x)
        return out, ref, err
    n_flipped = int((~same).sum().item())
    hold(f"{what} against its plain version on the {int(same.sum().item())} rows whose x_q "
         f"agrees ({differing:.2e} of all elements differ)", out[same], ref[same], x[same])
    max_ulps, rms_ulps = bf16_error(out, ref, x)
    log(f"# {what} against its plain version on all rows: ulps max {max_ulps:.2f}, rms "
        f"{rms_ulps:.3f} (tol {BF16_RMS_ULPS})")
    require(rms_ulps <= BF16_RMS_ULPS, f"{what}: rms {rms_ulps} against its plain version")
    if n_flipped:
        max_ulps, rms_ulps = bf16_error(out[~same], ref[~same], x[~same])
        log(f"# {what} on the {n_flipped} rows with a flipped x_q (held on its own row "
            f"pass): against its plain version ulps max {max_ulps:.2f}, rms {rms_ulps:.3f}")
    return out, ref, err


def int8_probe_kernel(gen, dev):
    """B9 in each of the sweep's (ep_bf16, ch) variants
    (probe_mlp_int8_sweep.VARIANTS), held by :func:`hold_int8_probe` at the
    main path's M = 10,960, d 1024, h 4096 and on the sign probe, and again
    on the probe sweep's own inputs at its M = 22,528; three planted faults
    (copysign for the sign term, an fp32 epilogue where bf16 was asked, ch
    1024 where 2048 was asked) must fail the same hold, at both shapes;
    each variant's times, its stages' device times, the bound and the two
    bare products on torch._int_mm. Returns the kernel's JSON row (the
    fp32-epilogue, ch 1024 variant's times)."""
    import torch

    from aa_clip_iqm_tpu_torch.ops import fused_mlp, quant
    from aa_clip_iqm_tpu_torch.tools import probe_mlp_int8_sweep as sweep

    m, d, h = B * TOKENS, WIDTH, 4 * WIDTH

    def rnd(*shape, std=1.0):
        return torch.randn(shape, generator=gen, device=dev) * std

    ln = {"scale": 1.0 + 0.1 * rnd(d), "bias": 0.1 * rnd(d)}
    mlp = {n: quant.quantize_linear_params(p) for n, p in (
        ("c_fc", {"w": rnd(d, h, std=d ** -0.5), "b": rnd(h, std=0.02)}),
        ("c_proj", {"w": rnd(h, d, std=h ** -0.5), "b": rnd(d, std=0.02)}))}
    x = rnd(m, d).to(torch.bfloat16)
    probe_mlp, probe_x = sign_probe(mlp, x)
    variants = sweep.VARIANTS
    refs, worst, times = {}, 0.0, {}
    ops = 4 * m * d * h

    def faults(where, refs, x):
        planted(f"B9 fp32 epilogue where bf16 was asked (ch 1024), {where}",
                refs[(False, 1024)], refs[(True, 1024)], x)
        planted(f"B9 ch 1024 where 2048 was asked (fp32 epilogue), {where}",
                refs[(False, 1024)], refs[(False, 2048)], x)

    for ep, ch in variants:
        what = f"B9 ln_mlp_residual_int8_probe M={m} ep_bf16={int(ep)} ch={ch}"
        out, refs[(ep, ch)], err = hold_int8_probe(what, ln, mlp, x, ep, ch)
        worst = max(worst, err)
        if not ep:
            # The sign probe: the compare-free sign decides these outputs.
            out_p = fused_mlp.ln_mlp_residual_int8_probe(ln, probe_mlp, probe_x, ep, ch)
            ref_p = fused_mlp.ln_mlp_residual_int8_probe_reference(ln, probe_mlp, probe_x, ep, ch)
            hold(f"{what} on the sign probe", out_p, ref_p, probe_x)
            if ch == 1024:
                planted("B9 copysign(1, x) for the compare-free sign x / (|x| + 1e-3), on the "
                        "sign probe", fused_mlp.ln_mlp_residual_int8_reference(
                            ln, probe_mlp, probe_x, gelu_nocmp_copysign, 1e-5, ch),
                        ref_p, probe_x)
            del out_p, ref_p
        ms = cuda_time(lambda: fused_mlp.ln_mlp_residual_int8_probe(ln, mlp, x, ep, ch), 20)
        plain_ms = cuda_time(
            lambda: fused_mlp.ln_mlp_residual_int8_probe_reference(ln, mlp, x, ep, ch), 3)
        times[(ep, ch)] = (ms, plain_ms)
        log(f"# B9 time, ep_bf16={int(ep)} ch={ch}: kernel {ms:.3f} ms "
            f"({ops / ms / 1e9:.1f} TOP/s), plain {plain_ms:.3f} ms")
        stage_times(f"B9 ep_bf16={int(ep)} ch={ch}",
                    lambda: fused_mlp.ln_mlp_residual_int8_probe(ln, mlp, x, ep, ch),
                    {"ln_quant_rows": ("LN + row quantize", "bytes", m * d * 2 + m * d + m * 4),
                     "hidden_epilogue": ("GEMM 1 (hid, chunk maxima exchanged, h_q)", "ops",
                                         2 * m * d * h),
                     "proj_epilogue": ("GEMM 2 (chunk fold, x)", "ops", 2 * m * d * h)})
        del out
    faults(f"M={m}", refs, x)
    st = fused_mlp.ln_mlp_residual_int8_probe_stages(ln, mlp, x, False, 1024)
    w_fc, w_p = mlp["c_fc"]["w_q"], mlp["c_proj"]["w_q"]
    int_mm_ms = cuda_time(lambda: (torch._int_mm(st["x_q"], w_fc), torch._int_mm(st["h_q"], w_p)),
                          10)
    nbytes = 2 * m * d * 2 + 2 * d * h + (h + d) * 4 + (3 * d + h) * 4
    b_ms, b_by = bound(ops, nbytes, PEAK_INT8_OPS)
    ms, plain_ms = times[(False, 1024)]
    log(f"# B9 time: kernel {ms:.3f} ms (ep_bf16=0 ch=1024; "
        + ", ".join(f"ep_bf16={int(e)} ch={c} {times[(e, c)][0]:.3f} ms" for e, c in variants[1:])
        + f"), plain {plain_ms:.3f} ms, the two bare products on torch._int_mm {int_mm_ms:.3f} ms "
        f"({ops / int_mm_ms / 1e9:.1f} TOP/s), bound {b_ms:.4f} ms ({b_by}; {ops:.3e} int8 "
        f"operations, {nbytes / 1e6:.1f} MB)")
    del st, refs, x, probe_x
    # The probe sweep's own inputs at its M: twice the row blocks of the
    # main path's, through the same cooperative chunk-maxima exchange.
    s_ln, _, s_mlp, s_x = sweep.make_case(sweep.ROWS, dev)
    refs = {}
    for ep, ch in variants:
        _, refs[(ep, ch)], _ = hold_int8_probe(
            f"B9 on the probe sweep's inputs M={sweep.ROWS} ep_bf16={int(ep)} ch={ch}",
            s_ln, s_mlp, s_x, ep, ch)
    faults(f"M={sweep.ROWS} (the probe sweep's inputs)", refs, s_x)
    del refs, s_x
    return {"name": "ln_mlp_residual_int8_probe", "route": "cuda",
            "source": "aa_clip_iqm_tpu_torch/csrc/ln_mlp_residual_int8.cu",
            "replaces": "tools/probe_mlp_int8_sweep.py:53",
            "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": int_mm_ms}


def other_widths(gen, dev):
    """B2 at the widths of the two other configs (ViT-B-16-plus-240's vision
    896/3584 at 512 and 240 px, its text 640/2560, RN50's text 512/2048) and B1 at
    ViT-B-16-plus's 14 heads over 1025 tokens (512 px), each held to its
    plain version and its stages or walk, with the kernel's, the plain
    version's and the stock call's times and the bound. N = 896 and 640 are
    no multiples of 256: the GEMM core takes 128-wide tiles there."""
    import torch
    import torch.nn.functional as F

    from aa_clip_iqm_tpu_torch.ops import fused_mlp, packed_attention as pa
    from aa_clip_iqm_tpu_torch.ops.layers import gelu

    bf16 = torch.bfloat16

    def rnd(*shape, std=1.0):
        return torch.randn(shape, generator=gen, device=dev) * std

    # (what, rows, d, h): ViT-B-16-plus at 512 and 240 px, batch 8 (8 x 1025
    # and 8 x 226 rows); the two text towers over MVTec's 240 prompt
    # sentences of 77 tokens.
    for what, m, d, h in (("ViT-B-16-plus vision", B * 1025, 896, 3584),
                          ("ViT-B-16-plus vision 240 px", B * 226, 896, 3584),
                          ("ViT-B-16-plus text", 240 * 77, 640, 2560),
                          ("RN50 text", 240 * 77, 512, 2048)):
        ln = {"scale": 1.0 + 0.1 * rnd(d), "bias": 0.1 * rnd(d)}
        mlp = {"c_fc": {"w": rnd(d, h, std=d ** -0.5).to(bf16), "b": rnd(h, std=0.02)},
               "c_proj": {"w": rnd(h, d, std=h ** -0.5).to(bf16), "b": rnd(d, std=0.02)}}
        x = rnd(m, d).to(bf16)
        out = fused_mlp.ln_mlp_residual(ln, mlp, x, gelu)
        hold(f"B2 {what} M={m} d={d} h={h}", out,
             fused_mlp.ln_mlp_residual_reference(ln, mlp, x, gelu), x)
        hold(f"B2 {what} against the plain version of its stages", out,
             fused_mlp.ln_mlp_residual_stages(ln, mlp, x, gelu), x)
        ms = cuda_time(lambda: fused_mlp.ln_mlp_residual(ln, mlp, x, gelu), 20)
        plain_ms = cuda_time(lambda: fused_mlp.ln_mlp_residual_reference(ln, mlp, x, gelu), 5)
        xn = F.layer_norm(x, (d,))
        b_fc, b_proj = mlp["c_fc"]["b"].to(bf16), mlp["c_proj"]["b"].to(bf16)
        lib_ms = cuda_time(lambda: torch.addmm(
            b_proj, F.gelu(torch.addmm(b_fc, xn, mlp["c_fc"]["w"])), mlp["c_proj"]["w"]), 20)
        flops = 4 * m * d * h
        nbytes = 2 * m * d * 2 + 2 * d * h * 2 + (3 * d + h) * 4
        b_ms, b_by = bound(flops, nbytes)
        log(f"# B2 time, {what} (M={m}, d={d}, h={h}): kernel {ms:.3f} ms ({tflops(flops, ms)}), "
            f"plain {plain_ms:.3f} ms, addmm-gelu-addmm {lib_ms:.3f} ms, bound {b_ms:.4f} ms "
            f"({b_by})")
        del ln, mlp, x, out, xn

    heads, tokens, width = 14, 1025, 896
    qkv = rnd(B, tokens, 3 * width).to(bf16)
    scale = HD ** -0.5
    out = pa.flash_mha_packed(qkv, heads, scale)
    hold(f"B1 packed_attention {heads} heads L={tokens}", out,
         pa.flash_mha_packed_reference(qkv, heads, scale))
    hold_walk(f"B1 {heads} heads against the plain version of its walk", out,
              pa.flash_mha_packed_stages(qkv, heads, scale, False, None))
    ms = cuda_time(lambda: pa.flash_mha_packed(qkv, heads, scale), 20)
    plain_ms = cuda_time(lambda: pa.flash_mha_packed_reference(qkv, heads, scale), 3)
    q, k, v = qkv.view(B, tokens, 3, heads, HD).permute(2, 0, 3, 1, 4)
    lib_ms = cuda_time(lambda: F.scaled_dot_product_attention(q, k, v, scale=scale), 20)
    flops = 4 * B * heads * tokens * tokens * HD
    b_ms, b_by = bound(flops, qkv.numel() * 2 + B * tokens * width * 2)
    log(f"# B1 time, {heads} heads x {tokens} tokens, batch {B}: kernel {ms:.3f} ms "
        f"({tflops(flops, ms)}), plain {plain_ms:.3f} ms, sdpa {lib_ms:.3f} ms, bound "
        f"{b_ms:.4f} ms ({b_by})")


def phase_models(card):
    """The repository's two other configs at full width, seeded weights in
    bf16 on the card: ViT-B-16-plus-240 (12 blocks of 896, 14 heads; text 12
    blocks of 640) encode_image at batch 8 at 240 px (226 tokens: the plain
    attention, 12 B2) and at 512 px (1025 tokens: 12 B1 + 12 B2) and
    text_forward over MVTec's prompts (12 B2): the kernels' route and the
    stock route (use_pallas=False, no kernel launched), both in bf16, each
    held to the float32 stock forward within MODEL_TOL, and the kernels'
    route with QuickGELU for GELU, the control, must fail that gate; the
    240 px forward profiled on both routes. RN50 at 224 px, batch 8:
    encode_image on cuDNN (no kernel) held to its float32 forward, the text
    tower (12 B2 at width 512) held as ViT-B-16-plus-240's, and the same
    weights written as an OpenAI RN .pt, converted and encoded again, bit
    for bit. Images/s of every forward."""
    import dataclasses
    import tempfile

    import numpy as np
    import torch

    from aa_clip_iqm_tpu_torch.configs import ModelConfig, get_model_config
    from aa_clip_iqm_tpu_torch.models import clip as clip_mod
    from aa_clip_iqm_tpu_torch.models.convert import (
        init_clip_params_np,
        load_openai_checkpoint,
        params_from_jax,
    )
    from aa_clip_iqm_tpu_torch.prompts import batched_prompt_tokens

    t_phase = time.perf_counter()
    bf16, f32 = torch.bfloat16, torch.float32
    total = counts_of()
    rng = np.random.default_rng(13)
    _, tokens, _, _ = batched_prompt_tokens("MVTec")
    tokens = torch.from_numpy(np.asarray(tokens, np.int64)).to(DEVICE)

    def rel(a, b):
        a, b = a.float(), b.float()
        return ((a - b).square().mean().sqrt() / b.square().mean().sqrt()).item()

    def images(n, size):
        return torch.from_numpy(rng.standard_normal((n, 3, size, size))
                                .astype(np.float32)).to(DEVICE)

    def routes(what, fn, want, n, control):
        """fn(use_pallas, dtype): the kernels' route in bf16, launching
        ``want``, and the stock route in bf16, which launches nothing, each
        held to the float32 stock forward within MODEL_TOL; ``control()``,
        the kernels' route with QuickGELU for GELU, must fail that gate; n
        items a call."""
        reset_counts()
        out = fn(True, bf16)
        torch.cuda.synchronize()
        got = read_counts()
        add_counts(total, got)
        require(got == want, f"{what}: launches { {k: v for k, v in got.items() if v} }, "
                f"want { {k: v for k, v in want.items() if v} }")
        reset_counts()
        stock = fn(False, bf16)
        torch.cuda.synchronize()
        require(read_counts() == counts_of(), f"{what}: the stock route launched a kernel")
        want_f32 = fn(False, f32)
        r_k, r_s, r_c = rel(out, want_f32), rel(stock, want_f32), rel(control(), want_f32)
        require(torch.isfinite(out).all().item() and r_k <= MODEL_TOL and r_s <= MODEL_TOL
                and r_k <= MODEL_RATIO * r_s,
                f"{what}: against float32, the kernels' route {r_k:.3e}, the stock route "
                f"{r_s:.3e} (tol {MODEL_TOL:.1e}, and {MODEL_RATIO} x the stock route's)")
        require(r_c > MODEL_RATIO * r_s,
                f"{what}: the QuickGELU control passed the gate ({r_c:.3e})")
        ms, ms_stock = cuda_time(lambda: fn(True, bf16), 5), cuda_time(lambda: fn(False, bf16), 5)
        log(f"# models, {what}: {tuple(out.shape)}, launches "
            f"{ {k: v for k, v in got.items() if v} }; against float32 rms: kernels' route "
            f"{r_k:.3e} ({r_k / r_s:.3f} x the stock route's), stock route {r_s:.3e} (tol "
            f"{MODEL_TOL:.1e}, and {MODEL_RATIO} x the stock route's), QuickGELU control "
            f"{r_c:.3e} ({r_c / r_s:.3f} x, caught); kernels' route against the stock route "
            f"{rel(out, stock):.3e}; {n / ms * 1e3:.1f} per s on the kernels, "
            f"{n / ms_stock * 1e3:.1f} per s on the stock route, on {card}")
        return out

    clip = get_model_config("ViT-B-16-plus-240")
    cfg = ModelConfig(clip=clip)
    params = init_clip_params_np(cfg, seed=3)
    frozen = {dt: params_from_jax(params, None, cfg, device=DEVICE, dtype=dt)[0]
              for dt in (bf16, f32)}
    layers = clip.vision.layers
    for img in (240, 512):
        c = clip.with_image_size(img)
        quick = dataclasses.replace(c, act="quick_gelu")
        visual = {dt: {"visual": frozen[dt]["visual"]} for dt in (bf16, f32)}
        if img != 240:
            pos = torch.from_numpy(clip_mod.resize_pos_embed_np(
                params["visual"]["positional_embedding"], c.vision.grid)).to(DEVICE)
            visual = {dt: {"visual": dict(v["visual"], positional_embedding=pos)}
                      for dt, v in visual.items()}
        x = images(B, img)
        want = counts_of(ln_mlp_residual=layers) if img == 240 else counts_of(
            packed_attention=layers, ln_mlp_residual=layers)

        def encode(up, dt, cc=c, visual=visual, x=x):
            return clip_mod.encode_image(visual[dt], cc, x, compute_dtype=dt, use_pallas=up)

        routes(f"ViT-B-16-plus-240 encode_image {img} px batch {B}", encode, want, B,
               lambda quick=quick, encode=encode: encode(True, bf16, quick))
        if img == 240:
            # Where the 240 px forward's time goes on each route: the plain
            # attention (226 tokens, below B1's 256) against B2 at M = 1,808.
            profile_call(lambda: encode(True, bf16), f"ViT-B-16-plus-240 encode_image 240 px "
                         f"batch {B}, the kernels' route")
            profile_call(lambda: encode(False, bf16), f"ViT-B-16-plus-240 encode_image 240 px "
                         f"batch {B}, the stock route")

    def text_of(frozen, clip):
        def text(up, dt, act=clip.act):
            return clip_mod.text_forward(frozen[dt]["text"], clip.text, tokens, act_name=act,
                                         compute_dtype=dt, use_pallas=up)
        return text

    vit_text = text_of(frozen, clip)
    routes(f"ViT-B-16-plus-240 text_forward, MVTec's {len(tokens)} prompts", vit_text,
           counts_of(ln_mlp_residual=clip.text.layers), len(tokens),
           lambda: vit_text(True, bf16, "quick_gelu"))
    del frozen, params

    clip = get_model_config("RN50")
    cfg = ModelConfig(clip=clip)
    params = init_clip_params_np(cfg, seed=4)
    frozen = {dt: params_from_jax(params, None, cfg, device=DEVICE, dtype=dt)[0]
              for dt in (bf16, f32)}
    x = images(B, clip.vision.image_size)
    reset_counts()
    pooled = clip_mod.encode_image(frozen[bf16], clip, x, compute_dtype=bf16)
    torch.cuda.synchronize()
    require(read_counts() == counts_of(), "RN50 encode_image launched a kernel")
    r = rel(pooled, clip_mod.encode_image(frozen[f32], clip, x))
    require(torch.isfinite(pooled).all().item() and pooled.shape == (B, clip.embed_dim)
            and r <= MODEL_TOL, f"RN50 encode_image: bf16 against float32 {r:.3e}")
    ms = cuda_time(lambda: clip_mod.encode_image(frozen[bf16], clip, x, compute_dtype=bf16), 5)
    log(f"# models, RN50 encode_image 224 px batch {B} (cuDNN, no kernel of the port): "
        f"{tuple(pooled.shape)}, bf16 against float32 rms {r:.3e} (tol {MODEL_TOL:.1e}), "
        f"{B / ms * 1e3:.1f} images/s on {card}")
    rn_text = text_of(frozen, clip)
    text = routes(f"RN50 text_forward, MVTec's {len(tokens)} prompts", rn_text,
                  counts_of(ln_mlp_residual=clip.text.layers), len(tokens),
                  lambda: rn_text(True, bf16, "quick_gelu"))
    # The same weights as an OpenAI RN checkpoint (float32, so no rounding on
    # the way), through the converter: the same embeddings, bit for bit.
    with tempfile.TemporaryDirectory() as tmp:
        pt = os.path.join(tmp, "RN50.pt")
        torch.save(openai_state_dict(params, cfg, torch.float32), pt)
        conv, _ = params_from_jax(load_openai_checkpoint(pt, clip), None, cfg, device=DEVICE,
                                  dtype=bf16)
    reset_counts()
    again = clip_mod.encode_image(conv, clip, x, compute_dtype=bf16)
    text_again = clip_mod.text_forward(conv["text"], clip.text, tokens, act_name=clip.act,
                                       compute_dtype=bf16)
    torch.cuda.synchronize()
    add_counts(total, read_counts())
    require(torch.equal(again, pooled) and torch.equal(text_again, text),
            "RN50 through the converter differs from the seeded weights")
    log("# models, RN50 through an OpenAI .pt and the converter: encode_image and "
        "text_forward bit for bit the seeded weights'")
    del frozen, conv, params
    torch.cuda.empty_cache()
    log(f"# models phase: {time.perf_counter() - t_phase:.1f} s, launches {total}")
    return total


def phase_kernels():
    import torch
    import torch.nn.functional as F

    from aa_clip_iqm_tpu_torch.ops import attn_block as ab, flash_attention as fa
    from aa_clip_iqm_tpu_torch.ops import fused_mlp, packed_attention as pa, quant
    from aa_clip_iqm_tpu_torch.ops.compare import bf16_error
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
        for valid_len in (None, 1300, 1):
            what = f"B1 packed_attention vv={vv} valid_len={valid_len}"
            out = pa.flash_mha_packed(qkv, HEADS, scale, vv=vv, valid_len=valid_len)
            ref = pa.flash_mha_packed_reference(qkv, HEADS, scale, vv=vv,
                                                valid_len=valid_len)
            worst = max(worst, hold(what, out, ref))
            # The log-sum-exp that the backward reads, asked for on the same
            # launch, against the plain logsumexp, and the output against
            # the plain version of the tile walk; the output must not move
            # with the log-sum-exp on.
            out_l, lse = pa._forward(qkv, HEADS, scale, vv, valid_len, with_lse=True)
            stages = pa.flash_mha_packed_stages(qkv, HEADS, scale, vv, valid_len)
            hold_walk(f"{what} against the plain version of its walk", out, stages)
            hold_lse(f"B1 log-sum-exp vv={vv} valid_len={valid_len}", lse,
                     pa.packed_lse_reference(qkv, HEADS, scale, vv, valid_len))
            require(torch.equal(out_l, out), "B1's output moved with the log-sum-exp on")
            if not vv and valid_len == 1300:
                require(torch.equal(walk_variant(qkv, HEADS, scale, False, 1300), stages),
                        "the walk's second transcription differs from the plain walk")
                planted("B1 running rescale skipped (alpha taken as 1)",
                        walk_variant(qkv, HEADS, scale, False, 1300, skip_rescale=True), stages)
                planted("B1 ragged key tile left unmasked past valid_len 1300",
                        walk_variant(qkv, HEADS, scale, False, 1300, unmask_ragged=True), stages)
            del out_l, lse, stages
    planted("B1 key tail unmasked", attn_tail_unmasked(qkv, HEADS, scale),
            pa.flash_mha_packed_reference(qkv, HEADS, scale))
    # Lengths about the walk's 128-row query and 128-key tiles, one item of
    # 16 heads each, up to the 1274 px tower's.
    for l, vv, valid_len in ((1, False, None), (63, True, 1), (64, False, None),
                             (127, True, None), (129, False, 1), (8282, True, 1300)):
        x = torch.randn((1, l, 3 * WIDTH), generator=gen, device=dev).to(bf16)
        what = f"B1 packed_attention L={l} vv={vv} valid_len={valid_len}"
        out, lse = pa._forward(x, HEADS, scale, vv, valid_len, with_lse=True)
        hold(what, out, pa.flash_mha_packed_reference(x, HEADS, scale, vv, valid_len))
        hold_walk(f"{what} against the plain version of its walk", out,
                  pa.flash_mha_packed_stages(x, HEADS, scale, vv, valid_len))
        hold_lse(f"B1 log-sum-exp L={l}", lse,
                 pa.packed_lse_reference(x, HEADS, scale, vv, valid_len))
        del x, out, lse
    ms = cuda_time(lambda: pa.flash_mha_packed(qkv, HEADS, scale), 20)
    lse_ms = cuda_time(lambda: pa._forward(qkv, HEADS, scale, False, None, with_lse=True), 20)
    plain_ms = cuda_time(lambda: pa.flash_mha_packed_reference(qkv, HEADS, scale), 3)
    q, k, v = qkv.view(B, TOKENS, 3, HEADS, HD).permute(2, 0, 3, 1, 4)
    lib_ms = cuda_time(lambda: F.scaled_dot_product_attention(q, k, v, scale=scale), 20)
    flops = 4 * B * HEADS * TOKENS * TOKENS * HD
    nbytes = qkv.numel() * 2 + B * TOKENS * WIDTH * 2
    b_ms, b_by = bound(flops, nbytes)
    log(f"# B1 time: kernel {ms:.3f} ms ({tflops(flops, ms)}; with the log-sum-exp written "
        f"{lse_ms:.3f} ms), twin {plain_ms:.3f} ms, sdpa {lib_ms:.3f} ms "
        f"({tflops(flops, lib_ms)}), bound {b_ms:.4f} ms ({b_by}; {flops:.3e} FLOP, "
        f"{nbytes / 1e6:.1f} MB)")
    results["packed_attention"] = {
        "name": "packed_attention", "route": "cuda",
        "source": "aa_clip_iqm_tpu_torch/csrc/packed_attention.cu",
        "replaces": "aa_clip_iqm_tpu/ops/pallas_attention.py:88",
        "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
        "bound_by": b_by, "library_ms": lib_ms}
    del qkv, q, k, v, ref

    # --- B2: fused LN -> MLP -> residual ---------------------------------
    worst, timing = 0.0, None
    # (rows, d, h): the vision tower at batch 8, the text tower over MVTec's
    # 240 prompt sentences of 77 tokens, then ragged row counts at the vision
    # widths: one row, one sentence, one 518 px image (10 x 128 + 90 rows),
    # two 1274 px images.
    shapes = ((B * TOKENS, WIDTH, 4 * WIDTH), (240 * 77, 768, 3072), (1, WIDTH, 4 * WIDTH),
              (77, WIDTH, 4 * WIDTH), (TOKENS, WIDTH, 4 * WIDTH),
              (2 * HR_TOKENS, WIDTH, 4 * WIDTH))
    for m, d, h in shapes:
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
        hold(f"B2 against the plain version of its stages M={m}", out,
             fused_mlp.ln_mlp_residual_stages(ln, mlp, x, gelu), x)
        if m == TOKENS:
            fault = ref.clone()
            fault[1280:] = 0
            planted("B2 ragged tail rows past 1,280 left at zero (M=1370)", fault, ref, x)
            del fault
        if timing is None:
            no_bias = {n: {"w": p["w"], "b": torch.zeros_like(p["b"])} for n, p in mlp.items()}
            planted("B2 biases dropped",
                    fused_mlp.ln_mlp_residual_reference(ln, no_bias, x, gelu), ref, x)
            planted("B2 QuickGELU for exact GELU",
                    fused_mlp.ln_mlp_residual_reference(ln, mlp, x, quick_gelu), ref, x)
            planted("B2 last 64-wide k-slice of the hidden layer dropped",
                    mlp_lost_stage(ln, mlp, x, gelu), ref, x)
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
            stage_times("B2", lambda: fused_mlp.ln_mlp_residual(ln, mlp, x, gelu),
                        {"layer_norm_rows": ("LayerNorm pass", "bytes", 2 * m * d * 2),
                         "gemm_bias_act": ("GEMM 1 (+ b_fc, GELU)", "flop", 2 * m * d * h),
                         "gemm_bias_residual": ("GEMM 2 (+ b_proj, x)", "flop", 2 * m * d * h)})
            gemm_tiles(ln, mlp, x)
            timing = {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                      "bound_by": b_by, "library_ms": lib_ms}
            del xn
        del x, out, ref, mlp
    results["ln_mlp_residual"] = {
        "name": "ln_mlp_residual", "route": "cuda",
        "source": "aa_clip_iqm_tpu_torch/csrc/ln_mlp_residual.cu",
        "replaces": "aa_clip_iqm_tpu/ops/pallas_mlp.py:142",
        "max_abs_err": worst, **timing}

    # --- B3: fused LN -> int8 MLP -> residual at ViT-L/518, batch 8 --------
    m, d, h = B * TOKENS, WIDTH, 4 * WIDTH

    def rnd(*shape, std=1.0):
        return torch.randn(shape, generator=gen, device=dev) * std

    def int8_case(d, h):
        ln = {"scale": 1.0 + 0.1 * rnd(d), "bias": 0.1 * rnd(d)}
        mlp = {n: quant.quantize_linear_params(p) for n, p in (
            ("c_fc", {"w": rnd(d, h, std=d ** -0.5), "b": rnd(h, std=0.02)}),
            ("c_proj", {"w": rnd(h, d, std=h ** -0.5), "b": rnd(d, std=0.02)}))}
        return ln, mlp

    # Ragged row counts (one row, one 518 px image: 10 x 128 + 90 rows) and
    # a width past ViT-L's (1280, 1024-wide chunks), held to the twin.
    for rows, dr, hr in ((1, WIDTH, 4 * WIDTH), (TOKENS, WIDTH, 4 * WIDTH), (77, 1280, 5120)):
        ln_r, mlp_r = int8_case(dr, hr)
        xr = rnd(rows, dr).to(bf16)
        hold(f"B3 ln_mlp_residual_int8 M={rows} d={dr} h={hr} quick_gelu",
             fused_mlp.ln_mlp_residual_int8(ln_r, mlp_r, xr, quick_gelu),
             fused_mlp.ln_mlp_residual_int8_reference(ln_r, mlp_r, xr, quick_gelu), xr)
        del ln_r, mlp_r, xr
    ln, mlp = int8_case(d, h)
    x = rnd(m, d).to(bf16)
    worst = 0.0
    for act in (gelu, quick_gelu):
        out = fused_mlp.ln_mlp_residual_int8(ln, mlp, x, act)
        ref = fused_mlp.ln_mlp_residual_int8_reference(ln, mlp, x, act)
        torch.cuda.synchronize()
        differing = (out != ref).float().mean().item()
        worst = max(worst, hold(f"B3 ln_mlp_residual_int8 M={m} d={d} h={h} {act.__name__} "
                                f"({differing:.2e} of the elements differ)", out, ref, x))
        # The plain version of the stages, and the kernel's own intermediates
        # against its: x_q and h_q may differ by one step where the
        # LayerNorm's fp32 sums, taken in another order, move a value across
        # a rounding boundary.
        got = fused_mlp.ln_mlp_residual_int8_with_stages(ln, mlp, x, act)
        st = fused_mlp.ln_mlp_residual_int8_stages(ln, mlp, x, act)
        require(torch.equal(got["y"], out), "B3: two launches on the same inputs differ")
        hold(f"B3 against the plain version of its stages {act.__name__}", out, st["y"], x)
        steps = []
        for name in ("x_q", "h_q"):
            diff = (got[name].int() - st[name].int()).abs()
            steps.append(f"{name} {(diff > 0).float().mean().item():.3e} of the elements differ, "
                         f"by at most {diff.max().item()} step")
            require(diff.max().item() <= 1, f"B3 {name} off by more than one step")
        for name in ("sx", "amax", "sh"):
            rel = ((got[name] - st[name]).abs() / st[name].abs().clamp_min(1e-30)).max().item()
            steps.append(f"{name} max relative difference {rel:.2e}")
        log(f"# B3 intermediates against the stages' ({act.__name__}): {'; '.join(steps)}; "
            f"the stages' y equals the twin's: {torch.equal(st['y'], ref)}")
        del got, st
    ref = fused_mlp.ln_mlp_residual_int8_reference(ln, mlp, x, gelu)
    require(torch.equal(int8_twin_variant(ln, mlp, x, gelu), ref),
            "the B3 twin's second transcription differs from the twin")
    planted("B3 one hidden scale per row (4096 wide) for one per 1024-wide chunk",
            int8_twin_variant(ln, mlp, x, gelu, chunk=h), ref, x)
    planted("B3 c_fc weight scales dropped",
            int8_twin_variant(ln, mlp, x, gelu, drop_fc_scale=True), ref, x)
    planted("B3 hidden maximum over a 128-wide GEMM 1 tile for the 1024-wide chunk",
            int8_twin_variant(ln, mlp, x, gelu, chunk=128), ref, x)
    planted("B3 s32 accumulator carried across a chunk boundary unscaled",
            int8_stages_carry(ln, mlp, x, gelu), ref, x)
    probe = rounding_probe(ln, x)
    ref_p = fused_mlp.ln_mlp_residual_int8_reference(probe, mlp, x, gelu)
    hold("B3 on the rounding probe (every input a tie)",
         fused_mlp.ln_mlp_residual_int8(probe, mlp, x, gelu), ref_p, x)
    planted("B3 round-half-away on the rounding probe",
            int8_twin_variant(probe, mlp, x, gelu, half_away=True), ref_p, x)
    ms = cuda_time(lambda: fused_mlp.ln_mlp_residual_int8(ln, mlp, x, gelu), 20)
    plain_ms = cuda_time(
        lambda: fused_mlp.ln_mlp_residual_int8_reference(ln, mlp, x, gelu), 3)
    stage_times("B3", lambda: fused_mlp.ln_mlp_residual_int8(ln, mlp, x, gelu),
                {"ln_quant_rows": ("LN + row quantize", "bytes", m * d * 2 + m * d + m * 4),
                 "hidden_epilogue": ("GEMM 1 (hid, chunk maxima exchanged, h_q)", "ops",
                                     2 * m * d * h),
                 "proj_epilogue": ("GEMM 2 (chunk fold, x)", "ops", 2 * m * d * h)})
    xn = layer_norm(ln, x)
    lib_ms = cuda_time(lambda: quant.int8_linear(
        mlp["c_proj"], gelu(quant.int8_linear(mlp["c_fc"], xn))), 10)
    st = fused_mlp.ln_mlp_residual_int8_stages(ln, mlp, x, gelu)
    w_fc, w_p = mlp["c_fc"]["w_q"], mlp["c_proj"]["w_q"]
    int_mm_ms = cuda_time(lambda: (torch._int_mm(st["x_q"], w_fc), torch._int_mm(st["h_q"], w_p)),
                          10)
    ops = 4 * m * d * h
    nbytes = 2 * m * d * 2 + 2 * d * h + (h + d) * 4 + (3 * d + h) * 4
    b_ms, b_by = bound(ops, nbytes, PEAK_INT8_OPS)
    log(f"# B3 time: kernel {ms:.3f} ms ({ops / ms / 1e9:.1f} TOP/s), twin {plain_ms:.3f} ms, "
        f"unfused int8_linear-gelu-int8_linear on torch._int_mm {lib_ms:.3f} ms, the two bare "
        f"products on torch._int_mm {int_mm_ms:.3f} ms ({ops / int_mm_ms / 1e9:.1f} TOP/s), "
        f"bound {b_ms:.4f} ms ({b_by}; {ops:.3e} int8 operations, {nbytes / 1e6:.1f} MB)")
    results["ln_mlp_residual_int8"] = {
        "name": "ln_mlp_residual_int8", "route": "cuda",
        "source": "aa_clip_iqm_tpu_torch/csrc/ln_mlp_residual_int8.cu",
        "replaces": "aa_clip_iqm_tpu/ops/pallas_mlp.py:161",
        "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
        "bound_by": b_by, "library_ms": lib_ms}
    del x, out, ref, mlp, xn, st, w_fc, w_p

    # --- B9: the int8 probe's kernel at the main path's M ------------------
    results["ln_mlp_residual_int8_probe"] = int8_probe_kernel(gen, dev)

    # --- B2 at the other two configs' widths, B1 at ViT-B-16-plus's heads ---
    other_widths(gen, dev)

    # --- B4: packed attention backward at ViT-L/518, batch 8 --------------
    # The kernels take the forward's log-sum-exp (B1 with it on), as the
    # autograd Function hands it over.
    w = WIDTH
    qkv = torch.randn((B, TOKENS, 3 * w), generator=gen, device=dev).to(bf16)
    d_out = torch.randn((B, TOKENS, w), generator=gen, device=dev).to(bf16)

    def hold_sections(what, out, ref):
        # dq, dk and dv each on its own scale.
        return max(hold(f"{what} {name}", out[..., i * w:(i + 1) * w],
                        ref[..., i * w:(i + 1) * w]) for i, name in enumerate(("dq", "dk", "dv")))

    def saved_lse(qkv, batch, vv, valid_len):
        return pa._forward(qkv[:batch], HEADS, scale, vv, valid_len, with_lse=True)[1]

    worst = 0.0
    ref_full = None
    for batch, valid_len in ((B, None), (B, 1300), (1, None), (1, 1300)):
        lse = saved_lse(qkv, batch, False, valid_len)
        out = pa.flash_mha_packed_bwd(qkv[:batch], d_out[:batch], HEADS, scale,
                                      valid_len=valid_len, lse=lse)
        ref = pa.flash_mha_packed_bwd_reference(qkv[:batch], d_out[:batch], HEADS, scale,
                                                valid_len=valid_len)
        what = f"B4 packed_attention_bwd batch={batch} valid_len={valid_len}"
        worst = max(worst, hold_sections(what, out, ref))
        stages = pa.flash_mha_packed_bwd_stages(qkv[:batch], d_out[:batch], HEADS, scale, False,
                                                valid_len, lse)
        hold_sections(f"{what} against the plain version of its stages", out, stages)
        if ref_full is None:
            ref_full = ref
        if batch == B and valid_len == 1300:
            require(torch.equal(attn_bwd_stages_variant(qkv, d_out, HEADS, scale, 1300, lse),
                                stages),
                    "the plain stages' second transcription differs from the plain stages")
            planted("B4 with D = 0 (dq)", attn_bwd_stages_variant(
                qkv, d_out, HEADS, scale, 1300, lse, zero_d=True)[..., :w], ref[..., :w])
            planted("B4 log-sum-exp over the unmasked keys at valid_len 1300 (dv)",
                    attn_bwd_stages_variant(qkv, d_out, HEADS, scale, 1300,
                                            pa.packed_lse_reference(qkv, HEADS, scale))
                    [..., 2 * w:], ref[..., 2 * w:])
            # Why D is summed from P * dP: the stages with D = rowsum(dO * O)
            # from the forward's bf16 output instead, against the plain
            # backward (not held).
            o = pa.flash_mha_packed(qkv, HEADS, scale, valid_len=1300)
            via_o = attn_bwd_stages_variant(qkv, d_out, HEADS, scale, 1300, lse, out=o)
            log("# B4's stages with D = rowsum(dO * O) from the bf16 O, against the plain "
                "backward (not held): " + "; ".join(
                    f"{name} ulps max {u[0]:.2f}, rms {u[1]:.3f}" for name, u in
                    (("dq", bf16_error(via_o[..., :w], ref[..., :w])),
                     ("dk", bf16_error(via_o[..., w:2 * w], ref[..., w:2 * w])))))
            del o, via_o
        del out, ref, stages, lse
    lse = saved_lse(qkv, B, False, None)
    require(torch.equal(pa.flash_mha_packed_bwd(qkv, d_out, HEADS, scale, lse=lse),
                        pa.flash_mha_packed_bwd(qkv, d_out, HEADS, scale, lse=lse)),
            "B4: two launches on the same inputs differ (the design has no atomics)")
    fault = attn_bwd_tail_unmasked(qkv, d_out, HEADS, scale)
    planted("B4 key tail unmasked (dv)", fault[..., 2 * w:], ref_full[..., 2 * w:])
    fault = ref_full.clone()
    fault[..., w:2 * w] = (ref_full[..., w:2 * w].float() / scale).to(bf16)
    planted("B4 scale on dK dropped (dk)", fault[..., w:2 * w], ref_full[..., w:2 * w])
    del fault, ref_full
    ms = cuda_time(lambda: pa.flash_mha_packed_bwd(qkv, d_out, HEADS, scale, lse=lse), 10)
    plain_ms = cuda_time(
        lambda: pa.flash_mha_packed_bwd_reference(qkv, d_out, HEADS, scale), 2)
    n = B * HEADS * TOKENS * TOKENS * HD
    stage_times("B4", lambda: pa.flash_mha_packed_bwd(qkv, d_out, HEADS, scale, lse=lse),
                {"attention_bwd_dq_kernel": ("dq (D pass: S, dP; then S, dP, dQ)", "flop", 10 * n),
                 "attention_bwd_dkv_kernel": ("dk/dv (S^T, dP^T, dV, dK)", "flop", 8 * n)})
    q, k, v = (t.detach().requires_grad_(True)
               for t in qkv.view(B, TOKENS, 3, HEADS, HD).permute(2, 0, 3, 1, 4))
    attn = F.scaled_dot_product_attention(q, k, v, scale=scale)
    g_heads = d_out.view(B, TOKENS, HEADS, HD).transpose(1, 2)
    lib_ms = cuda_time(
        lambda: torch.autograd.grad(attn, (q, k, v), g_heads, retain_graph=True), 10)
    flops = 10 * n
    # qkv, dO and the log-sum-exp read once, dqkv written once.
    nbytes = (2 * qkv.numel() + d_out.numel()) * 2 + lse.numel() * 4
    b_ms, b_by = bound(flops, nbytes)
    log(f"# B4 time: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, sdpa backward {lib_ms:.3f} ms, "
        f"bound {b_ms:.4f} ms ({b_by}; {flops:.3e} FLOP, {nbytes / 1e6:.1f} MB); its nine "
        f"products at the peak {9 * 2 * n / PEAK_BF16_FLOPS * 1e3:.4f} ms")
    results["packed_attention_bwd"] = {
        "name": "packed_attention_bwd", "route": "cuda",
        "source": "aa_clip_iqm_tpu_torch/csrc/packed_attention_bwd.cu",
        "replaces": "aa_clip_iqm_tpu/ops/pallas_attention.py:332",
        "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
        "bound_by": b_by, "library_ms": lib_ms}
    del qkv, d_out, q, k, v, attn, g_heads, lse

    # --- B5: dx of the fused LN -> MLP -> residual, frozen parameters ------
    # The stage-2 shape for both activations, then ragged row counts: one
    # row, one sentence, one and two 518 px images.
    d, h = WIDTH, 4 * WIDTH
    ln = {"scale": 1.0 + 0.1 * rnd(d), "bias": 0.1 * rnd(d)}
    mlp = {"c_fc": {"w": rnd(d, h, std=d ** -0.5).to(bf16), "b": rnd(h, std=0.02)},
           "c_proj": {"w": rnd(h, d, std=h ** -0.5).to(bf16), "b": rnd(d, std=0.02)}}
    worst = 0.0
    for m, act in ((B * TOKENS, gelu), (B * TOKENS, quick_gelu), (1, gelu), (77, quick_gelu),
                   (TOKENS, gelu), (2 * TOKENS, quick_gelu)):
        x, g = rnd(m, d).to(bf16), rnd(m, d).to(bf16)
        out = fused_mlp.ln_mlp_residual_dx(ln, mlp, x, g, act)
        ref = fused_mlp.ln_mlp_residual_dx_reference(ln, mlp, x, g, act)
        # Held on dx - g: the residual cotangent g is the same in both.
        worst = max(worst, hold(f"B5 ln_mlp_residual_dx M={m} d={d} h={h} {act.__name__}",
                                out, ref, g))
        hold(f"B5 against the plain version of its stages M={m}", out,
             fused_mlp.ln_mlp_residual_dx_stages(ln, mlp, x, g, act), g)
        del out, ref
    x, g = rnd(B * TOKENS, d).to(bf16), rnd(B * TOKENS, d).to(bf16)
    m = B * TOKENS
    ref = fused_mlp.ln_mlp_residual_dx_reference(ln, mlp, x, g, gelu)
    require(torch.equal(dx_variant(ln, mlp, x, g, gelu), ref),
            "the plain dx's second transcription differs from the plain dx")
    planted("B5 act' of QuickGELU for GELU",
            fused_mlp.ln_mlp_residual_dx_reference(ln, mlp, x, g, quick_gelu), ref, g)
    planted("B5 LayerNorm backward without its mean terms",
            dx_variant(ln, mlp, x, g, gelu, ln_means=False), ref, g)
    planted("B5 act' taken without b_fc", dx_variant(ln, mlp, x, g, gelu, b_fc=False), ref, g)
    planted("B5 GEMM 3 without its last 64-deep k-slice",
            dx_variant(ln, mlp, x, g, gelu, drop_last_slice=True), ref, g)
    del ref
    ms = cuda_time(lambda: fused_mlp.ln_mlp_residual_dx(ln, mlp, x, g, gelu), 10)
    plain_ms = cuda_time(
        lambda: fused_mlp.ln_mlp_residual_dx_reference(ln, mlp, x, g, gelu), 3)
    stage_times("B5", lambda: fused_mlp.ln_mlp_residual_dx(ln, mlp, x, g, gelu),
                {"layer_norm_rows": ("LayerNorm pass", "bytes", 2 * m * d * 2),
                 "gemm_dual_dact": ("dual GEMM (hid, da, act')", "flop", 4 * m * d * h),
                 "gemm_f32": ("GEMM 3 (du * ln_g)", "flop", 2 * m * d * h),
                 "ln_dx_rows": ("row pass", "bytes", 3 * m * d * 2 + m * d * 4 + m * d * 2)})
    xg = x.detach().requires_grad_(True)
    ln_w, ln_b = ln["scale"].to(bf16), ln["bias"].to(bf16)
    b_fc, b_proj = mlp["c_fc"]["b"].to(bf16), mlp["c_proj"]["b"].to(bf16)

    def library_chain():
        y = xg + torch.addmm(b_proj, F.gelu(torch.addmm(
            b_fc, F.layer_norm(xg, (d,), ln_w, ln_b), mlp["c_fc"]["w"])), mlp["c_proj"]["w"])
        return torch.autograd.grad(y, xg, g)

    lib_ms = cuda_time(library_chain, 10)
    flops = 6 * m * d * h
    nbytes = 3 * m * d * 2 + 2 * d * h * 2 + (2 * d + h) * 4
    b_ms, b_by = bound(flops, nbytes)
    log(f"# B5 time: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, forward + backward of the "
        f"cuBLAS LN-addmm-gelu-addmm chain (x alone requiring grad) {lib_ms:.3f} ms, "
        f"bound {b_ms:.4f} ms ({b_by}; {flops:.3e} FLOP, {nbytes / 1e6:.1f} MB)")
    results["ln_mlp_residual_dx"] = {
        "name": "ln_mlp_residual_dx", "route": "cuda",
        "source": "aa_clip_iqm_tpu_torch/csrc/ln_mlp_residual_dx.cu",
        "replaces": "aa_clip_iqm_tpu/ops/pallas_mlp.py:200",
        "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
        "bound_by": b_by, "library_ms": lib_ms}
    del x, g, mlp, xg

    # --- B6: value-value attention backward at ViT-L/518, batch 8 ----------
    qkv = torch.randn((B, TOKENS, 3 * w), generator=gen, device=dev).to(bf16)
    d_out = torch.randn((B, TOKENS, w), generator=gen, device=dev).to(bf16)
    worst = 0.0
    for batch, valid_len in ((B, None), (B, 1300), (2, None), (2, 1300)):
        lse = saved_lse(qkv, batch, True, valid_len)
        out = pa.flash_mha_packed_bwd(qkv[:batch], d_out[:batch], HEADS, scale, vv=True,
                                      valid_len=valid_len, lse=lse)
        ref = pa.flash_mha_packed_bwd_reference(qkv[:batch], d_out[:batch], HEADS, scale,
                                                vv=True, valid_len=valid_len)
        require(not out[..., :2 * w].any().item(), "B6 wrote to the q or k columns")
        # Held on the value columns, dA: the q and k columns are zero in both.
        what = f"B6 packed_attention_vv_bwd batch={batch} valid_len={valid_len} (dA)"
        worst = max(worst, hold(what, out[..., 2 * w:], ref[..., 2 * w:]))
        hold(f"{what} against the plain version of its stages", out[..., 2 * w:],
             pa.flash_mha_packed_bwd_stages(qkv[:batch], d_out[:batch], HEADS, scale, True,
                                            valid_len, lse)[..., 2 * w:])
        del out, ref, lse
    lse = saved_lse(qkv, B, True, None)
    require(torch.equal(pa.flash_mha_packed_bwd(qkv, d_out, HEADS, scale, True, lse=lse),
                        pa.flash_mha_packed_bwd(qkv, d_out, HEADS, scale, True, lse=lse)),
            "B6: two launches on the same inputs differ (the design has no atomics)")
    ref = pa.flash_mha_packed_bwd_reference(qkv, d_out, HEADS, scale, vv=True)
    require(torch.equal(vv_bwd_variant(qkv, d_out, HEADS, scale), ref),
            "the plain vv backward's second transcription differs from the plain one")
    planted("B6 key term dropped (dA)",
            vv_bwd_variant(qkv, d_out, HEADS, scale, key_term=False)[..., 2 * w:],
            ref[..., 2 * w:])
    del ref
    ms = cuda_time(lambda: pa.flash_mha_packed_bwd(qkv, d_out, HEADS, scale, True, lse=lse), 10)
    plain_ms = cuda_time(
        lambda: pa.flash_mha_packed_bwd_reference(qkv, d_out, HEADS, scale, vv=True), 2)
    stage_times("B6", lambda: pa.flash_mha_packed_bwd(qkv, d_out, HEADS, scale, True, lse=lse),
                {"attention_bwd_dq_kernel": ("dq (D pass: S, dP; then S, dP, dQ)", "flop", 10 * n),
                 "attention_bwd_dkv_kernel": ("dk/dv (S^T, dP^T, dV, dK)", "flop", 8 * n)})
    a = qkv[..., 2 * w:].reshape(B, TOKENS, HEADS, HD).transpose(1, 2).detach()
    a.requires_grad_(True)
    attn = F.scaled_dot_product_attention(a, a, a, scale=scale)
    g_heads = d_out.view(B, TOKENS, HEADS, HD).transpose(1, 2)
    lib_ms = cuda_time(lambda: torch.autograd.grad(attn, a, g_heads, retain_graph=True), 10)
    flops = 10 * n
    # The value columns, dO and the log-sum-exp read once, the whole dqkv
    # written once.
    nbytes = (qkv.numel() // 3 + d_out.numel() + qkv.numel()) * 2 + lse.numel() * 4
    b_ms, b_by = bound(flops, nbytes)
    log(f"# B6 time: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, sdpa backward with q = k = v "
        f"{lib_ms:.3f} ms, bound {b_ms:.4f} ms ({b_by}; {flops:.3e} FLOP, {nbytes / 1e6:.1f} MB)")
    results["packed_attention_vv_bwd"] = {
        "name": "packed_attention_vv_bwd", "route": "cuda",
        "source": "aa_clip_iqm_tpu_torch/csrc/packed_attention_bwd.cu",
        "replaces": "aa_clip_iqm_tpu/ops/pallas_attention.py:400",
        "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
        "bound_by": b_by, "library_ms": lib_ms}
    del qkv, d_out, a, attn, g_heads, lse

    # --- B7: unpacked flash attention on (B*H, L, 64) ----------------------
    # The 518 px heads at batch 8 (the TPU's whole-row kernel region), then
    # ViT-L at 1274 px, batch 1 (past ROW_KERNEL_MAX_TOKENS: its online
    # kernel); the latter is the main path's shape and the row's timing.
    # Then lengths about the walk's 128-row and 128-key tiles, through the
    # kernel entry (flash_mha sends fewer than 256 tokens to the plain sdpa).
    worst, timing = 0.0, None
    for bh, l in ((B * HEADS, TOKENS), (HEADS, HR_TOKENS), (HEADS, 1), (HEADS, 63), (HEADS, 64),
                  (HEADS, 127), (HEADS, 129)):
        q, k, v = (torch.randn((1, bh, l, HD), generator=gen, device=dev).to(bf16)
                   for _ in range(3))
        what = f"B7 flash_attention BH={bh} L={l}"
        out = fa.flash_mha(q, k, v, scale) if l >= 2 * fa.BLK_Q else fa._forward(
            q[0], k[0], v[0], scale)[None]
        ref = fa.flash_mha_reference(q, k, v, scale)
        worst = max(worst, hold(what, out, ref))
        hold_walk(f"{what} against the plain version of its walk", out,
                  fa.attention_fwd_stages(q[0], k[0], v[0], scale)[None])
        if l == TOKENS:
            planted("B7 key tail unmasked", flash_tail_unmasked(q, k, v, scale), ref)
        del out, ref
        if l < TOKENS:
            del q, k, v
            continue
        ms = cuda_time(lambda: fa.flash_mha(q, k, v, scale), 10)
        plain_ms = cuda_time(lambda: fa.flash_mha_reference(q, k, v, scale), 2)
        lib_ms = cuda_time(lambda: F.scaled_dot_product_attention(q, k, v, scale=scale), 10)
        flops = 4 * bh * l * l * HD
        nbytes = 4 * bh * l * HD * 2
        b_ms, b_by = bound(flops, nbytes)
        log(f"# {'B7a' if l == TOKENS else 'B7b'} time at BH={bh} L={l}: kernel {ms:.3f} ms "
            f"({tflops(flops, ms)}), plain {plain_ms:.3f} ms, sdpa {lib_ms:.3f} ms "
            f"({tflops(flops, lib_ms)}), bound {b_ms:.4f} ms ({b_by}; {flops:.3e} FLOP, "
            f"{nbytes / 1e6:.1f} MB)")
        if l == HR_TOKENS:
            # The TPU's online region (B7b), the main path's: the row's timing.
            timing = {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                      "library_ms": lib_ms}
        del q, k, v
    results["flash_attention"] = {
        "name": "flash_attention", "route": "cuda",
        "source": "aa_clip_iqm_tpu_torch/csrc/flash_attention.cu",
        "replaces": "aa_clip_iqm_tpu/ops/pallas_attention.py:45",
        "max_abs_err": worst, **timing}

    # --- B8: fused attention half-block at ViT-L/518, batch 8 ---------------
    d = WIDTH
    ln = {"scale": 1.0 + 0.1 * rnd(d), "bias": 0.1 * rnd(d)}
    attn_p = {"qkv": {"w": rnd(d, 3 * d, std=d ** -0.5).to(bf16), "b": rnd(3 * d, std=0.1)},
              "out": {"w": rnd(d, d, std=d ** -0.5).to(bf16), "b": rnd(d, std=0.1)}}
    worst, refs = 0.0, {}
    for batch in (1, B):
        x = rnd(batch, TOKENS, d).to(bf16)
        for vv in (False, True):
            for valid_len in (None, 1360):
                out = ab.ln_attn_residual(ln, attn_p, x, HEADS, vv, valid_len)
                ref = ab.ln_attn_residual_reference(ln, attn_p, x, HEADS, vv, valid_len)
                # Held on y - x: the residual x is the same in both.
                worst = max(worst, hold(f"B8 ln_attn_residual B={batch} L={TOKENS} vv={vv} "
                                        f"valid_len={valid_len}", out, ref, x))
                hold(f"B8 against the plain version of its stages B={batch} vv={vv} "
                     f"valid_len={valid_len}", out,
                     ab.ln_attn_residual_stages(ln, attn_p, x, HEADS, vv, valid_len), x)
                hold_walk(f"B8 against its stages with the attention walk B={batch} vv={vv} "
                          f"valid_len={valid_len}", out,
                          ab.ln_attn_residual_stages(ln, attn_p, x, HEADS, vv, valid_len,
                                                     walk=True), x)
                if valid_len is None:
                    refs[vv] = ref
                del out, ref
    # Lengths about the walk's 128-row and 128-key tiles.
    for l, vv, valid_len in ((1, False, None), (63, True, None), (64, False, 1), (127, True, 1),
                             (129, False, None)):
        xr = rnd(2, l, d).to(bf16)
        out = ab.ln_attn_residual(ln, attn_p, xr, HEADS, vv, valid_len)
        what = f"B8 ln_attn_residual B=2 L={l} vv={vv} valid_len={valid_len}"
        hold(what, out, ab.ln_attn_residual_reference(ln, attn_p, xr, HEADS, vv, valid_len), xr)
        hold_walk(f"{what} against its stages with the attention walk", out,
                  ab.ln_attn_residual_stages(ln, attn_p, xr, HEADS, vv, valid_len, walk=True), xr)
        del xr, out
    planted("B8 out bias dropped", block_no_out_bias(ln, attn_p, x, HEADS), refs[False], x)
    planted("B8 q read from the q section under vv", block_q_from_q_section(ln, attn_p, x, HEADS),
            refs[True], x)
    del refs
    ms = cuda_time(lambda: ab.ln_attn_residual(ln, attn_p, x, HEADS), 10)
    plain_ms = cuda_time(lambda: ab.ln_attn_residual_reference(ln, attn_p, x, HEADS), 3)
    m = B * TOKENS
    stage_times("B8", lambda: ab.ln_attn_residual(ln, attn_p, x, HEADS),
                {"layer_norm_rows": ("LayerNorm pass", "bytes", 2 * m * d * 2),
                 "gemm_bias_act": ("qkv GEMM (+ b_qkv)", "flop", 2 * m * d * 3 * d),
                 "attention_wgmma_kernel": ("attention (B1's walk)", "flop",
                                          4 * B * HEADS * TOKENS * TOKENS * HD),
                 "gemm_bias_residual": ("out-projection GEMM (+ b_out, x)", "flop",
                                        2 * m * d * d)})
    ln_w, ln_b = ln["scale"].to(bf16), ln["bias"].to(bf16)
    b_qkv, b_o = attn_p["qkv"]["b"].to(bf16), attn_p["out"]["b"].to(bf16)

    def library_block():
        h = F.layer_norm(x, (d,), ln_w, ln_b).view(-1, d)
        qkv_h = torch.addmm(b_qkv, h, attn_p["qkv"]["w"]).view(B, TOKENS, 3, HEADS, HD)
        q, k, v = qkv_h.permute(2, 0, 3, 1, 4)
        o = F.scaled_dot_product_attention(q, k, v, scale=scale).transpose(1, 2).reshape(-1, d)
        return x + torch.addmm(b_o, o, attn_p["out"]["w"]).view_as(x)

    lib_ms = cuda_time(library_block, 10)
    flops = 8 * B * TOKENS * d * d + 4 * B * HEADS * TOKENS * TOKENS * HD
    nbytes = 2 * x.numel() * 2 + 4 * d * d * 2 + 6 * d * 4
    b_ms, b_by = bound(flops, nbytes)
    log(f"# B8 time: kernel {ms:.3f} ms ({tflops(flops, ms)}), plain {plain_ms:.3f} ms, "
        f"layer_norm-addmm-sdpa-addmm {lib_ms:.3f} ms ({tflops(flops, lib_ms)}), bound "
        f"{b_ms:.4f} ms ({b_by}; {flops:.3e} FLOP, {nbytes / 1e6:.1f} MB)")
    results["ln_attn_residual"] = {
        "name": "ln_attn_residual", "route": "cuda",
        "source": "aa_clip_iqm_tpu_torch/csrc/ln_attn_residual.cu",
        "replaces": "aa_clip_iqm_tpu/ops/pallas_attn_block.py:47",
        "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
        "bound_by": b_by, "library_ms": lib_ms}
    return results


def vv_bwd_variant(qkv, d_out, num_heads, scale, vv=True, valid_len=None, key_term=True):
    """The plain value-value backward written out once more (as
    ``flash_mha_packed_bwd_reference`` with ``vv``), with its planted fault:
    the key term of dA dropped. Without the fault it is the plain version.
    The signature is ``flash_mha_packed_bwd``'s, so it can stand in for it."""
    import torch

    b, l, threew = qkv.shape
    w = threew // 3
    hd = w // num_heads
    dt = qkv.dtype

    def heads(t):
        return t.reshape(b, l, num_heads, hd).transpose(1, 2)

    def rounded(t):
        return t.to(dt).float()

    a = heads(qkv[..., 2 * w:])
    g = rounded(heads(d_out).float())
    s = torch.matmul(a.float() * scale, a.float().transpose(-1, -2))
    if valid_len is not None and valid_len < l:
        keys = torch.arange(l, device=qkv.device)
        s = s + torch.where(keys < valid_len, 0.0, float("-inf"))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    d_val = torch.matmul(rounded(p).transpose(-1, -2), g)
    dp = torch.matmul(g, a.float().transpose(-1, -2))
    d_row = (p * dp).sum(dim=-1, keepdim=True)
    dsb = rounded(p * (dp - d_row))
    af = a.float()
    d_a = d_val + torch.matmul(dsb, af) * scale
    if key_term:
        d_a = d_a + torch.matmul(dsb.transpose(-1, -2), af) * scale
    zeros = qkv.new_zeros((b, l, 2 * w))
    return torch.cat([zeros, d_a.transpose(1, 2).reshape(b, l, w).to(dt)], dim=-1)


def vv_bwd_no_key_term(qkv, d_out, num_heads, scale, vv=True, valid_len=None):
    """Planted fault for the surgery backward: B6 without the key term."""
    return vv_bwd_variant(qkv, d_out, num_heads, scale, vv, valid_len, key_term=False)


def flash_tail_unmasked(q, k, v, scale):
    """Planted fault: the B7 twin with the zero-filled rows of the ragged last
    64-key tile counted as keys."""
    import torch

    from aa_clip_iqm_tpu_torch.ops.flash_attention import flash_mha_reference

    pad = -k.shape[-2] % 64

    def padded(t):
        return torch.cat([t, t.new_zeros(t.shape[:-2] + (pad, t.shape[-1]))], dim=-2)

    return flash_mha_reference(q, padded(k), padded(v), scale)


def flash_scale_dropped(q, k, v, scale, attn_mask=None):
    """Planted fault for the 1274 px map: the twin of flash_mha without the
    1/sqrt(hd) scale on unmasked calls."""
    from aa_clip_iqm_tpu_torch.ops.attention import sdpa

    return sdpa(q, k, v, scale if attn_mask is not None else 1.0, attn_mask)


def block_no_out_bias(ln, attn_p, x, num_heads, vv=False, valid_len=None, eps=1e-5):
    """Planted fault: the B8 twin without the out-projection bias."""
    import torch

    from aa_clip_iqm_tpu_torch.ops.attn_block import ln_attn_residual_reference

    no_bias = {"qkv": attn_p["qkv"], "out": {"w": attn_p["out"]["w"],
                                             "b": torch.zeros_like(attn_p["out"]["b"])}}
    return ln_attn_residual_reference(ln, no_bias, x, num_heads, vv, valid_len, eps)


def block_scale_dropped(ln, attn_p, x, num_heads, vv=False, valid_len=None, eps=1e-5):
    """Planted fault for the fused-attention map: the B8 twin without the
    1/sqrt(hd) scale of the scores."""
    from aa_clip_iqm_tpu_torch.ops.layers import layer_norm, linear
    from aa_clip_iqm_tpu_torch.ops.packed_attention import flash_mha_packed_reference

    qkv = linear(attn_p["qkv"], layer_norm(ln, x, eps=eps))
    out = flash_mha_packed_reference(qkv, num_heads, 1.0, vv, valid_len)
    return x + linear(attn_p["out"], out)


def block_q_from_q_section(ln, attn_p, x, num_heads, eps=1e-5):
    """Planted fault: the value-value B8 twin with q read from the q section
    of the projection (k and v from the value section)."""
    from aa_clip_iqm_tpu_torch.ops.attention import sdpa
    from aa_clip_iqm_tpu_torch.ops.layers import layer_norm, linear

    b, l, w = x.shape
    hd = w // num_heads
    q, _, v = linear(attn_p["qkv"], layer_norm(ln, x, eps=eps)).split(w, dim=-1)

    def heads(t):
        return t.reshape(b, l, num_heads, hd).transpose(1, 2)

    out = sdpa(heads(q), heads(v), heads(v), hd ** -0.5).transpose(1, 2).reshape(b, l, w)
    return x + linear(attn_p["out"], out)


def attn_bwd_tail_unmasked(qkv, d_out, num_heads, scale):
    """Planted fault: the plain attention backward with the zero-filled rows
    of the ragged last 64-key tile counted as keys."""
    from aa_clip_iqm_tpu_torch.ops.packed_attention import flash_mha_packed_bwd_reference

    b, l, c = qkv.shape
    lp = -(-l // 64) * 64
    padded, g = qkv.new_zeros((b, lp, c)), d_out.new_zeros((b, lp, c // 3))
    padded[:, :l], g[:, :l] = qkv, d_out
    return flash_mha_packed_bwd_reference(padded, g, num_heads, scale)[:, :l]


def attn_bwd_stages_variant(qkv, d_out, num_heads, scale, valid_len, lse, zero_d=False,
                            out=None):
    """The plain stages of B4 written out once more (as
    ``flash_mha_packed_bwd_stages`` without vv), with a planted fault: D
    taken as zero; or, given the forward's output ``out``, D = rowsum(dO *
    O) in place of rowsum(P * dP). Without either it is the plain stages."""
    import torch

    from aa_clip_iqm_tpu_torch.ops.packed_attention import _scores

    b, l, threew = qkv.shape
    w = threew // 3
    hd = w // num_heads
    dt = qkv.dtype

    def heads(t):
        return t.reshape(b, l, num_heads, hd).transpose(1, 2)

    def merge(t):
        return t.transpose(1, 2).reshape(b, l, w).to(dt)

    s, k, v = _scores(qkv, num_heads, scale, False, valid_len)
    g = heads(d_out).float()
    p = torch.exp(s - lse.float()[..., None])
    d_val = torch.matmul(p.to(dt).float().transpose(-1, -2), g)
    dp = torch.matmul(g, v.float().transpose(-1, -2))
    d_row = (0.0 if zero_d else (p * dp).sum(dim=-1, keepdim=True) if out is None
             else (g * heads(out).float()).sum(dim=-1, keepdim=True))
    dsb = (p * (dp - d_row)).to(dt).float()
    d_q = torch.matmul(dsb, k.float()) * scale
    d_k = torch.matmul(dsb.transpose(-1, -2), heads(qkv[..., :w]).float()) * scale
    return torch.cat([merge(d_q), merge(d_k), merge(d_val)], dim=-1)


def dx_variant(ln, mlp, x, g, act, ln_means=True, b_fc=True, drop_last_slice=False,
               eps=1e-5):
    """The plain dx written out once more, with its planted faults: the
    LayerNorm backward without its two mean terms; act' taken without b_fc;
    GEMM 3 (du = dh W_fc^T) without its last 64-deep k-slice, as a pipeline
    that loses its last stage would. Without a fault it is the plain dx."""
    import torch

    from aa_clip_iqm_tpu_torch.ops import fused_mlp
    from aa_clip_iqm_tpu_torch.ops.gemm import DACTS

    dact = DACTS[act]
    dt, d = x.dtype, x.shape[-1]
    w_fc, w_proj = mlp["c_fc"]["w"].float(), mlp["c_proj"]["w"].float()
    h = w_fc.shape[-1]
    ch = fused_mlp.hidden_chunk(h)
    x32, g32 = x.reshape(-1, d).float(), g.reshape(-1, d).float()
    mu = x32.mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt((x32 - mu).square().mean(dim=-1, keepdim=True) + eps)
    xn = (x32 - mu) * rstd
    xin = (xn * ln["scale"] + ln["bias"]).to(dt).float()
    du = torch.zeros_like(x32)
    for j in range(0, h, ch):
        hid = xin @ w_fc[:, j:j + ch]
        if b_fc:
            hid = hid + mlp["c_fc"]["b"][j:j + ch]
        dh = ((g32 @ w_proj[j:j + ch].t()) * dact(hid)).to(dt).float()
        if drop_last_slice and j + ch == h:
            dh[:, -64:] = 0
        du = du + dh @ w_fc[:, j:j + ch].t()
    dxh = du * ln["scale"]
    if ln_means:
        dxh = dxh - dxh.mean(dim=-1, keepdim=True) - xn * (dxh * xn).mean(dim=-1, keepdim=True)
    return (dxh * rstd + g32).to(dt).reshape(x.shape)


def dx_no_ln_means(ln, mlp, x, g, act, eps=1e-5):
    """Planted fault for the end-to-end gradient check."""
    return dx_variant(ln, mlp, x, g, act, ln_means=False, eps=eps)


def walk_variant(qkv, num_heads, scale, vv=False, valid_len=None, skip_rescale=False,
                 unmask_ragged=False):
    """The plain version of the attention walk (``flash_mha_packed_stages``)
    written out once more, with its planted faults: the running rescale
    skipped (alpha taken as 1), or the ragged last key tile left unmasked
    (keys past valid_len, and past L the zero rows the kernel reads there,
    counted as keys). Without a fault it is the plain walk."""
    import torch

    from aa_clip_iqm_tpu_torch.ops.flash_attention import LOG2E, TILE_KEYS

    b, l, threew = qkv.shape
    w = threew // 3
    hd = w // num_heads
    bh = b * num_heads
    dt = qkv.dtype

    def heads(t):
        return t.reshape(b, l, num_heads, hd).transpose(1, 2).reshape(bh, l, hd)

    q, k, v = (heads(t) for t in qkv.split(w, dim=-1))
    if vv:
        q = k = v
    qf, kf, vf = q.float(), k.float(), v.float()
    if unmask_ragged:
        pad = kf.new_zeros((bh, -l % TILE_KEYS, hd))
        kf, vf = torch.cat([kf, pad], dim=1), torch.cat([vf, pad], dim=1)
    n = l if valid_len is None else min(valid_len, l)
    m = torch.full((bh, l, 1), float("-inf"), device=qkv.device)
    lsum = torch.zeros((bh, l, 1), device=qkv.device)
    acc = torch.zeros((bh, l, hd), device=qkv.device)
    for k0 in range(0, n, TILE_KEYS):
        k1 = min(k0 + TILE_KEYS, kf.shape[1])
        s = torch.matmul(qf, kf[:, k0:k1].transpose(-1, -2))
        if k1 > n and not unmask_ragged:
            s[..., n - k0:] = float("-inf")
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True) * (scale * LOG2E))
        alpha = torch.ones_like(m) if skip_rescale else torch.exp2(m - m_new)
        p = torch.exp2(s * (scale * LOG2E) - m_new)
        lsum = lsum * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.matmul(p.to(dt).float(), vf[:, k0:k1])
        m = m_new
    out = (acc * (1.0 / lsum)).to(dt)
    return out.reshape(b, num_heads, l, hd).transpose(1, 2).reshape(b, l, w)


def attn_tail_unmasked(qkv, num_heads, scale, vv=False, valid_len=None):
    """Planted fault: the B1 twin with the zero-filled rows of the ragged
    last 64-key tile counted as keys."""
    from aa_clip_iqm_tpu_torch.ops.packed_attention import flash_mha_packed_reference

    b, l, c = qkv.shape
    padded = qkv.new_zeros((b, -(-l // 64) * 64, c))
    padded[:, :l] = qkv
    return flash_mha_packed_reference(padded, num_heads, scale, vv, valid_len)[:, :l]


def mlp_lost_stage(ln, mlp, x, act, eps=1e-5):
    """Planted fault: the plain version of B2's stages with the last 64-wide
    k-slice of the hidden layer dropped from GEMM 2, as a pipeline that
    loses its last stage would."""
    from aa_clip_iqm_tpu_torch.ops.gemm import gemm_bias_act_reference, gemm_bias_residual_reference
    from aa_clip_iqm_tpu_torch.ops.layers import layer_norm

    c_fc, c_proj = mlp["c_fc"], mlp["c_proj"]
    hid = gemm_bias_act_reference(layer_norm(ln, x, eps=eps), c_fc["w"], c_fc["b"], act)
    hid[..., -64:] = 0
    return gemm_bias_residual_reference(hid, c_proj["w"], c_proj["b"], x)


def mlp_quick_gelu(ln, mlp, x, act, eps=1e-5):
    """Planted fault: the B2 twin with QuickGELU for whatever it was given."""
    from aa_clip_iqm_tpu_torch.ops.fused_mlp import ln_mlp_residual_reference
    from aa_clip_iqm_tpu_torch.ops.layers import quick_gelu

    return ln_mlp_residual_reference(ln, mlp, x, quick_gelu, eps)


class _Twins:
    """Route the port's kernel call sites to their plain twins, or to the
    given stand-ins (used only to compare the main path against the twins).
    Autograd differentiates the twins themselves, so the backward kernels
    are out of the way too."""

    def __init__(self, attn=None, mlp=None, mlp_int8=None, flash=None, block=None,
                 keep_attn=False, rope=None):
        self._attn, self._mlp, self._mlp_int8 = attn, mlp, mlp_int8
        self._flash, self._block, self._rope = flash, block, rope
        self._keep_attn = keep_attn          # leave B1 on its kernel
        self._eager = _Eager()               # a graph replay would keep the kernels

    def __enter__(self):
        from aa_clip_iqm_tpu_torch.models import clip
        from aa_clip_iqm_tpu_torch.ops import attention, attn_block, fused_mlp, packed_attention
        from aa_clip_iqm_tpu_torch.ops import layers, rope, swiglu

        self._eager.__enter__()
        self._saved = (attention.flash_mha_packed, attention.flash_mha, clip.ln_attn_residual,
                       clip.ln_mlp_residual, clip.ln_mlp_residual_int8,
                       clip.ln_mlp_residual_frozen, clip.layer_norm_rows, clip.rope_qk,
                       clip.ln_swiglu_residual)
        # EVA-02's block: its LayerNorm pass, rotation and MLP half.
        clip.layer_norm_rows = layers.layer_norm
        clip.rope_qk = self._rope or rope.rope_qk_reference
        clip.ln_swiglu_residual = swiglu.ln_swiglu_residual_reference
        if not self._keep_attn:
            attention.flash_mha_packed = (self._attn
                                          or packed_attention.flash_mha_packed_reference)
        # flash_mha's plain twin, fallbacks included, is the plain sdpa.
        attention.flash_mha = self._flash or attention.sdpa
        clip.ln_attn_residual = self._block or attn_block.ln_attn_residual_reference
        clip.ln_mlp_residual = self._mlp or fused_mlp.ln_mlp_residual_reference
        clip.ln_mlp_residual_int8 = (self._mlp_int8
                                     or fused_mlp.ln_mlp_residual_int8_reference)
        clip.ln_mlp_residual_frozen = clip.ln_mlp_residual
        return self

    def __exit__(self, *exc):
        from aa_clip_iqm_tpu_torch.models import clip
        from aa_clip_iqm_tpu_torch.ops import attention

        (attention.flash_mha_packed, attention.flash_mha, clip.ln_attn_residual,
         clip.ln_mlp_residual, clip.ln_mlp_residual_int8, clip.ln_mlp_residual_frozen,
         clip.layer_norm_rows, clip.rope_qk, clip.ln_swiglu_residual) = self._saved
        self._eager.__exit__(*exc)


def plain_attention_bwd(qkv, d_out, num_heads, scale, vv=False, valid_len=None, lse=None):
    """The plain attention backward with the kernels' signature: it recomputes
    the softmax and does not read the forward's log-sum-exp."""
    from aa_clip_iqm_tpu_torch.ops.packed_attention import flash_mha_packed_bwd_reference

    return flash_mha_packed_bwd_reference(qkv, d_out, num_heads, scale, vv, valid_len)


class _PlainBackward:
    """Keep the forward kernels and route the two backward kernels' call
    sites to their plain versions, or to the given stand-in."""

    def __init__(self, mlp_dx=None):
        self._mlp_dx = mlp_dx

    def __enter__(self):
        from aa_clip_iqm_tpu_torch.ops import fused_mlp, packed_attention

        self._saved = (packed_attention.flash_mha_packed_bwd, fused_mlp.ln_mlp_residual_dx)
        packed_attention.flash_mha_packed_bwd = plain_attention_bwd
        fused_mlp.ln_mlp_residual_dx = self._mlp_dx or fused_mlp.ln_mlp_residual_dx_reference
        return self

    def __exit__(self, *exc):
        from aa_clip_iqm_tpu_torch.ops import fused_mlp, packed_attention

        packed_attention.flash_mha_packed_bwd, fused_mlp.ln_mlp_residual_dx = self._saved


class _PlainVvBackward:
    """Keep every kernel but the value-value backward (B6), which goes to its
    plain version, or to the given stand-in."""

    def __init__(self, fault=None):
        self._fault = fault

    def __enter__(self):
        from aa_clip_iqm_tpu_torch.ops import packed_attention

        kernel = self._saved = packed_attention.flash_mha_packed_bwd
        plain = self._fault or packed_attention.flash_mha_packed_bwd_reference

        def route(qkv, d_out, num_heads, scale, vv=False, valid_len=None, lse=None):
            if vv:
                return plain(qkv, d_out, num_heads, scale, vv, valid_len)
            return kernel(qkv, d_out, num_heads, scale, vv, valid_len, lse)

        packed_attention.flash_mha_packed_bwd = route
        return self

    def __exit__(self, *exc):
        from aa_clip_iqm_tpu_torch.ops import packed_attention

        packed_attention.flash_mha_packed_bwd = self._saved


def f32_tree(tree):
    """A parameter tree's tensors in float32."""
    return {k: f32_tree(v) if isinstance(v, dict) else v.float() for k, v in tree.items()}


def rope_off_k(qkv, table, num_heads):
    """A planted fault: the rotation applied to q alone."""
    from aa_clip_iqm_tpu_torch.ops.rope import rope_qk_reference

    w = qkv.shape[-1] // 3
    out = rope_qk_reference(qkv, table, num_heads)
    out[..., w:2 * w] = qkv[..., w:2 * w]
    return out


def rope_from_class_row(qkv, table, num_heads):
    """A planted fault: the table aligned to the sequence's start, so the
    class row takes patch 0's angles and each patch its predecessor's."""
    from aa_clip_iqm_tpu_torch.ops.rope import rotate

    l, w = qkv.shape[1], qkv.shape[-1] // 3
    hd = w // num_heads
    turned = rotate(qkv[:, :-1, :2 * w].unflatten(-1, (2 * num_heads, hd)),
                    table[0][None, :, None, :], table[1][None, :, None, :])
    out = qkv.clone()
    out[:, :l - 1, :2 * w] = turned.flatten(-2)
    return out


def rope_dropped(qkv, table, num_heads):
    """A planted fault for the whole model: no rotation at all."""
    return qkv


def phase_eva02(card):
    """EVA02-CLIP-L-14-336 at 518 px (module docstring, phase 3b). Returns
    the rows of its three kernel entries and the launches of its detector
    run (the counters' eager launches, as the main path counts them)."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from aa_clip_iqm_tpu_torch.loader import build_model_config, init_trainable, random_backbone
    from aa_clip_iqm_tpu_torch.ops import rope, swiglu
    from aa_clip_iqm_tpu_torch.ops.compare import bf16_error
    from aa_clip_iqm_tpu_torch.ops.layers import layer_norm
    from aa_clip_iqm_tpu_torch.serving import AnomalyDetector
    from aa_clip_iqm_tpu_torch.utils import profiling

    t_phase = time.perf_counter()
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(4321)
    bf16, d, h, eps = torch.bfloat16, WIDTH, EVA_HIDDEN, EVA_EPS
    src = "aa_clip_iqm_tpu_torch/csrc/"
    results = {}

    def rnd(*shape, std=1.0):
        return torch.randn(shape, generator=gen, device=dev) * std

    # --- S1: ln_swiglu_residual, at batch 8 and the cell's batch 32 --------
    ln = {"scale": 1.0 + 0.02 * rnd(d), "bias": 0.02 * rnd(d)}
    mlp = {"w12": {"w": rnd(d, 2 * h, std=d ** -0.5).to(bf16), "b": rnd(2 * h, std=0.02)},
           "ln": {"scale": 1.0 + 0.02 * rnd(h), "bias": 0.02 * rnd(h)},
           "w3": {"w": rnd(h, d, std=h ** -0.5).to(bf16), "b": rnd(d, std=0.02)}}
    worst, timing = 0.0, None
    for b in (B, EVA_B):
        m = b * TOKENS
        x = rnd(m, d).to(bf16)
        out = swiglu.ln_swiglu_residual(ln, mlp, x, eps, eps)
        chain = swiglu.ln_swiglu_residual_reference(ln, mlp, x, eps, eps)
        stages = swiglu.ln_swiglu_residual_stages(ln, mlp, x, eps, eps)
        # The bf16 chain rounds both products, g and LN_ffn(g) where S1
        # rounds g alone, so both are held to the chain's function: the same
        # stock calls in float32 on the same bf16 input and weights. S1 must
        # be within the kernels' ulps of it and no further (RMS) than the
        # bf16 chain.
        exact = swiglu.ln_swiglu_residual_reference(f32_tree(ln), f32_tree(mlp), x.float(),
                                                    eps, eps)
        worst = max(worst, hold(f"S1 against the stock chain in float32 (M={m}, d {d}, h {h})",
                                out, exact, x))
        k_err, c_err = bf16_error(out, exact, x), bf16_error(chain, exact, x)
        log(f"# S1 / the stock bf16 chain against the chain in float32 (M={m}): ulps max "
            f"{k_err[0]:.2f} / {c_err[0]:.2f}, rms {k_err[1]:.3f} / {c_err[1]:.3f}; S1 against "
            f"the bf16 chain: ulps max, rms {bf16_error(out, chain, x)}")
        require(k_err[1] <= c_err[1], f"S1 is further from the chain's function than the stock "
                                      f"bf16 chain (M={m})")
        hold(f"S1 against its stages (M={m})", out, stages, x)
        ops = swiglu.lay_out(*swiglu.leaves(mlp))
        ops.h = ops.hp
        planted(f"S1 sub-LN averaged over the padded width {ops.hp} (M={m})",
                swiglu.ln_swiglu_residual_stages(ln, mlp, x, eps, eps, ops=ops), exact, x)
        del stages, ops, exact
        ms = cuda_time(lambda: swiglu.ln_swiglu_residual(ln, mlp, x, eps, eps), 20)
        plain_ms = cuda_time(lambda: swiglu.ln_swiglu_residual_stages(ln, mlp, x, eps, eps), 5)
        lib_ms = cuda_time(lambda: swiglu.ln_swiglu_residual_reference(ln, mlp, x, eps, eps), 10)
        flops = 2 * m * 3 * d * h
        nbytes = (2 * m * d + 3 * d * h + 2 * m * h) * 2
        b_ms, b_by = bound(flops, nbytes)
        log(f"# S1 time (M={m}): kernel {ms:.4f} ms ({tflops(flops, ms)}), stages {plain_ms:.4f} "
            f"ms, stock chain {lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}; {flops:.3e} FLOP, "
            f"{nbytes / 1e6:.1f} MB)")
        hp = -(-h // swiglu.HIDDEN_TILE) * swiglu.HIDDEN_TILE
        stage_times(f"S1 (M={m})", lambda: swiglu.ln_swiglu_residual(ln, mlp, x, eps, eps),
                    {"layer_norm_rows": ("LayerNorm pass", "bytes", 2 * m * d * 2),
                     "swiglu_dual": ("dual product (+ b12, SiLU *)", "flop", 2 * m * d * 2 * hp),
                     "swiglu_out": ("out product (+ sub-LN, b3', x)", "flop", 2 * m * hp * d)})
        if b == EVA_B:
            timing = {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                      "library_ms": lib_ms}
        del x, out, chain
    results["ln_swiglu_residual"] = {
        "name": "ln_swiglu_residual", "route": "cuda", "source": src + "ln_swiglu_residual.cu",
        "replaces": "none (EVA-02's MLP half)", "max_abs_err": worst, **timing}

    # --- S1's LayerNorm pass alone: LN1 and the attention sub-LN ---------
    m = EVA_B * TOKENS
    x = (3 * rnd(m, d) + 1).to(bf16)
    out = swiglu.layer_norm_rows(ln, x, eps)
    err = hold(f"S1's LayerNorm pass against layers.layer_norm (M={m}, d {d})", out,
               layer_norm(ln, x, eps=eps))
    ms = cuda_time(lambda: swiglu.layer_norm_rows(ln, x, eps), 20)
    plain_ms = cuda_time(lambda: layer_norm(ln, x, eps=eps), 10)
    lib_ms = cuda_time(lambda: F.layer_norm(x, (d,), ln["scale"].to(bf16), ln["bias"].to(bf16),
                                            eps), 20)
    b_ms, b_by = bound(7 * m * d, 2 * m * d * 2 + 2 * d * 4)
    log(f"# S1 LayerNorm pass time (M={m}): kernel {ms:.4f} ms, layers.layer_norm "
        f"{plain_ms:.4f} ms, F.layer_norm in bf16 {lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    results["ln_swiglu_residual_layer_norm"] = {
        "name": "ln_swiglu_residual_layer_norm", "route": "cuda",
        "source": src + "ln_swiglu_residual.cu", "replaces": "none (EVA-02's LN1 and sub-LN)",
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": lib_ms}
    del x, out

    # --- R1: rope_qk on the cell's packed projection ---------------------
    grid = IMG // 14
    table = rope.rope_table(grid, 16, HD, dev)
    qkv = rnd(EVA_B, TOKENS, 3 * d).to(bf16)
    want = rope.rope_qk_reference(qkv, table, HEADS)
    got = rope.rope_qk(qkv.clone(), table, HEADS)
    err = hold(f"R1 rope_qk against its plain version (batch {EVA_B}, {TOKENS} tokens)", got,
               want)
    require(torch.equal(got[:, 0], qkv[:, 0]) and torch.equal(got[..., 2 * d:], qkv[..., 2 * d:]),
            "R1 moved the class row or the v columns")
    planted("R1 rotation left off k", rope_off_k(qkv, table, HEADS), want)
    planted("R1 rotation from the class row on", rope_from_class_row(qkv, table, HEADS), want)
    buf = qkv.clone()
    ms = cuda_time(lambda: rope.rope_qk(buf, table, HEADS), 20)
    plain_ms = cuda_time(lambda: rope.rope_qk_reference(qkv, table, HEADS), 10)
    elems = EVA_B * (TOKENS - 1) * 2 * d
    b_ms, b_by = bound(3 * elems, 2 * elems * 2 + 2 * (TOKENS - 1) * HD * 4)
    log(f"# R1 time (batch {EVA_B}): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
        f"{b_ms:.4f} ms ({b_by}; {(2 * elems * 2) / ms / 1e6:.1f} GB/s)")
    results["rope_qk"] = {
        "name": "rope_qk", "route": "cuda", "source": src + "rope_qk.cu",
        "replaces": "none (EVA-02's rotation of q and k)", "max_abs_err": err, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}
    del qkv, want, got, buf, ln, mlp

    # --- The detector on the three kernels, at the cell's batch ----------
    t0 = time.perf_counter()
    cfg = build_model_config(EVA_MODEL, img_size=IMG)
    frozen = random_backbone(cfg, seed=0, device=DEVICE, dtype=bf16)
    trainable = init_trainable(cfg, seed=111, device=DEVICE, dtype=bf16)
    torch.cuda.synchronize()
    layers = cfg.clip.vision.layers
    log(f"# EVA-02: {EVA_MODEL} @ {IMG}px, hidden {cfg.clip.vision.mlp_hidden}, random weights "
        f"in {time.perf_counter() - t0:.1f} s")
    reset_counts()
    profiling.reset_counters()
    det = AnomalyDetector(frozen, trainable, cfg, "MVTec", img_size=IMG,
                          compute_dtype=bf16, batch_buckets=(EVA_B,), device=DEVICE)
    torch.cuda.synchronize()
    counts = read_counts()
    require(counts == counts_of(ln_mlp_residual=cfg.clip.text.layers),
            f"EVA-02 anchor build launches {counts}")
    classes = det.class_names()
    rng = np.random.default_rng(17)
    imgs = rng.integers(0, 256, (EVA_B, 3, IMG, IMG), dtype=np.uint8)
    names = [classes[i % len(classes)] for i in range(EVA_B)]
    (maps, scores), ran = graph_request(det, lambda: det.predict_multi(imgs, names))
    require(maps.shape == (EVA_B, IMG, IMG) and scores.shape == (EVA_B,),
            f"EVA-02 predict_multi: maps {maps.shape}, scores {scores.shape}")
    require(np.isfinite(maps).all() and np.isfinite(scores).all(), "EVA-02: non-finite output")
    want_ran = counts_of(packed_attention=layers, ln_swiglu_residual=layers,
                         ln_swiglu_residual_layer_norm=2 * layers, rope_qk=layers)
    log(f"# EVA-02 predict_multi b{EVA_B}: maps in [{maps.min():.4f}, {maps.max():.4f}], "
        f"launches per replay { {k: v for k, v in ran.items() if v} } (graph replay)")
    require(ran == want_ran, f"EVA-02 replay launches {ran}, want {want_ran}")
    c = profiling.counters()
    log(f"# EVA-02 counters: blocks.eva02 {c.get('blocks.eva02', 0)}, mlp.swiglu_fused "
        f"{c.get('mlp.swiglu_fused', 0)}, mlp.swiglu_chain {c.get('mlp.swiglu_chain', 0)}")
    require(c.get("mlp.swiglu_chain", 0) == 0 and c.get("mlp.swiglu_fused", 0) > 0
            and c["mlp.swiglu_fused"] == c["blocks.eva02"],
            "EVA-02's detector ran a stock-chain MLP on the card")
    launches = read_counts()

    # The same batch through the plain versions (B1's included), then with
    # the rotation dropped, which the comparison must catch.
    with _Twins():
        before = read_counts()
        maps_t, scores_t = det.predict_multi(imgs, names)
        require(read_counts() == before, "EVA-02 twin run launched a kernel")
    rel = map_diff(maps, maps_t)
    log(f"# EVA-02 kernels vs plain versions, batch {EVA_B} map: rms diff / std {rel:.3e} "
        f"(tol {MAP_TOL:.0e}); scores max abs diff {float(np.abs(scores - scores_t).max()):.3e}")
    require(rel <= MAP_TOL, f"EVA-02 map differs from the plain versions' by {rel}")
    with _Twins(rope=rope_dropped):
        rel_f = map_diff(det.predict_multi(imgs, names)[0], maps_t)
    log(f"# planted fault, EVA-02 rotation dropped, batch {EVA_B} map: rms diff / std "
        f"{rel_f:.3e}")
    require(rel_f > MAP_TOL, "EVA-02 map comparison missed the dropped rotation")
    time_requests(det, imgs, card, f"EVA-02 {EVA_MODEL}")
    log_graphs(det, "EVA-02")
    del det, frozen, trainable
    torch.cuda.empty_cache()
    log(f"# EVA-02 phase: {time.perf_counter() - t_phase:.1f} s, launches "
        f"{ {k: v for k, v in launches.items() if v} }")
    return results, launches


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
    require(counts == counts_of(ln_mlp_residual=cfg.clip.text.layers),
            f"anchor build launches {counts}")

    classes = det.class_names()
    requests = [("predict b1", images(1), ["bottle"]),
                ("predict b8", images(B), ["screw"] * B),
                ("predict_multi b5", images(5), [classes[i % len(classes)] for i in range(5)])]
    # Each request is a graph replay (the first of a bucket warms up and
    # captures first): its launches are those its replays ran.
    for what, imgs, names in requests:
        if len(set(names)) == 1:
            (maps, scores), ran = graph_request(det, lambda: det.predict(imgs, names[0]))
        else:
            (maps, scores), ran = graph_request(det, lambda: det.predict_multi(imgs, names))
        got = (ran["packed_attention"], ran["ln_mlp_residual"])
        log(f"# {what}: maps {maps.shape} in [{maps.min():.4f}, {maps.max():.4f}], "
            f"scores {np.round(scores, 4).tolist()}, launches B1 {got[0]} B2 {got[1]} "
            "(graph replay)")
        check(maps, scores, len(imgs), what)
        require(ran == counts_of(packed_attention=layers, ln_mlp_residual=layers),
                f"{what}: launches {ran}, want {layers} each of B1 and B2")
    counts = read_counts()

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
           "imgs8": imgs8, "maps_bf16": maps_k, "maps_twins": maps_t, "check": check}
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
        require(got == counts_of(ln_mlp_residual=text_layers),
                f"{tier}: anchor build launches {got} (the text tower is never quantized)")
        (maps, scores), ran = graph_request(det, lambda: det.predict(imgs8, "screw"))
        log(f"# tier {tier}: quantized and anchors built in {time.perf_counter() - t0:.1f} s; "
            f"batch-8 maps in [{maps.min():.4f}, {maps.max():.4f}], launches {ran} "
            "(graph replay)")
        ctx["check"](maps, scores, B, f"tier {tier}")
        require(ran == counts_of(packed_attention=b1, ln_mlp_residual=b2,
                                 ln_mlp_residual_int8=b3), f"tier {tier}: launches {ran}")
        add_counts(total, read_counts())
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
        ctx.setdefault("det_tiers", {})[tier] = det
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


def phase_native(card):
    """The native transform pipeline (data/native.py) built from the port's
    C++ source with g++, against PIL at sizes that resize: the bicubic
    resize within one level; the mask resize exactly the nearest rule
    floor((i + 0.5) * src / dst), and exactly PIL's except where that
    coordinate is an exact tie, which PIL's accumulated float coordinate
    rounds down (the JAX package's native resize, which the port copies,
    does the same); the nearest warp exactly the numpy one of the PIL path;
    and a batch of resizes on 4 threads against 1 (a ctypes call releases
    the interpreter lock)."""
    import concurrent.futures

    import numpy as np
    from PIL import Image

    from aa_clip_iqm_tpu_torch.data import datasets, native

    t0 = time.perf_counter()
    require(native.available(), f"the native pipeline did not build:\n{native.BUILD_LOG}")
    log(f"# native: {native.LIB_PATH} loaded in {time.perf_counter() - t0:.1f} s (g++ "
        f"{' '.join(native.CXX_FLAGS)} when stale)")
    rng = np.random.default_rng(3)
    for (h, w), size in (((97, 123), 56), ((700, 900), IMG)):
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        out = native.resize_bicubic_rgb(img, size)
        pil = np.asarray(Image.fromarray(img).resize((size, size), Image.BICUBIC),
                         np.float32).transpose(2, 0, 1) / 255.0
        lsb = float(np.abs(out - pil).max()) * 255.0
        differ = float(np.mean(out != pil))
        mask = (rng.random((h, w)) > 0.5).astype(np.uint8) * 255
        m_native = native.resize_nearest_mask(mask, size)
        m_pil = (np.asarray(Image.fromarray(mask, "L").resize((size, size), Image.NEAREST))
                 != 0).astype(np.float32)
        i = np.arange(size)
        rule = (mask[((2 * i + 1) * h) // (2 * size)][:, ((2 * i + 1) * w) // (2 * size)]
                != 0).astype(np.float32)
        tie_rows = ((2 * i + 1) * h) % (2 * size) == 0
        tie_cols = ((2 * i + 1) * w) % (2 * size) == 0
        tie = tie_rows[:, None] | tie_cols[None, :]
        pil_off = m_native != m_pil
        stack = np.concatenate([out, m_native[None]])
        a = np.deg2rad(17.0)
        c = size / 2 - 0.5
        M = np.array([[np.cos(a), np.sin(a), (1 - np.cos(a)) * c - np.sin(a) * c],
                      [-np.sin(a), np.cos(a), np.sin(a) * c + (1 - np.cos(a)) * c]])
        warp_equal = np.array_equal(native.warp_affine_chw(stack, M),
                                    datasets._warp_nearest(stack, M))
        log(f"# native against PIL, {h}x{w} -> {size}: bicubic within {lsb:.2f} levels "
            f"({differ:.2%} of values differ; tol 1), masks "
            f"{'equal' if np.array_equal(m_native, rule) else 'DIFFER'} to the nearest rule "
            f"and to PIL's but at {int(pil_off.sum())} pixels ({pil_off.mean():.2%}), all on "
            f"the exact ties ({int(tie_rows.sum())} rows, {int(tie_cols.sum())} columns): "
            f"{'yes' if not (pil_off & ~tie).any() else 'NO'}; nearest warp "
            f"{'equal' if warp_equal else 'DIFFERS'} to the numpy one")
        require(lsb <= 1.01, f"native bicubic resize {lsb} levels from PIL's")
        require(np.array_equal(m_native, rule), "native mask resize breaks the nearest rule")
        require(not (pil_off & ~tie).any(), "native mask resize differs from PIL's off the ties")
        require(warp_equal, "native warp differs from the numpy warp")
    imgs = [rng.integers(0, 256, (900, 900, 3), dtype=np.uint8) for _ in range(32)]
    seconds = {}
    for workers in (1, 4):
        with concurrent.futures.ThreadPoolExecutor(workers) as pool:
            t0 = time.perf_counter()
            list(pool.map(lambda im: native.resize_bicubic_rgb(im, IMG), imgs))
            seconds[workers] = time.perf_counter() - t0
    log(f"# native: 32 bicubic resizes 900 -> {IMG} px in {seconds[1] * 1e3:.1f} ms on 1 "
        f"thread, {seconds[4] * 1e3:.1f} ms on 4 ({seconds[1] / seconds[4]:.2f}x; "
        f"{os.cpu_count()} cores on this host)")


def phase_sweep(card, ctx):
    """evaluate_dataset over an in-memory synthetic dataset, for the bf16 and
    the int8 tier, its predict calls replayed (one CUDA graph a bucket):
    what each replay launches, the metrics against the eager sweep's and
    device metrics against the host's; then the sweep over PNGs on disk
    that the data layer resizes, with the native transforms on and off, at
    1 and 4 decode threads."""
    import numpy as np
    import torch

    from aa_clip_iqm_tpu_torch.configs import EvalConfig
    from aa_clip_iqm_tpu_torch.evaluation import predict as ev
    from aa_clip_iqm_tpu_torch.ops.metrics import metrics_eval_raw
    from aa_clip_iqm_tpu_torch.train import graphs

    cfg = ctx["cfg"]
    layers = cfg.clip.vision.layers
    sizes = {"bottle": 24, "screw": 19}      # 19 = 8 + 8 + a tail of 3 (bucket 4)
    datasets = {c: MemoryDataset(c, n, IMG, seed=i) for i, (c, n) in enumerate(sizes.items())}
    n_images = sum(sizes.values())
    eval_cfg = EvalConfig(dataset="MVTec", img_size=IMG, batch_size=B)
    keys = ev.METRIC_KEYS
    total = dict.fromkeys(KERNELS, 0)
    for tier, det in (("none", ctx["det"]), ("int8", ctx["det_int8"])):
        cache = graphs.GraphCache()

        def sweep(graph_cache=cache):
            t0 = time.perf_counter()
            rows = ev.evaluate_dataset(det.frozen, det.trainable, cfg, eval_cfg, datasets,
                                       det.anchors, compute_dtype=torch.bfloat16,
                                       graphs=graph_cache)
            torch.cuda.synchronize()
            return rows, time.perf_counter() - t0

        reset_counts()
        rows, first_s = sweep()              # captures the buckets' graphs
        got = read_counts()
        with eager_programs():
            rows_eager, _ = sweep(None)      # the eager program's first run
        # Timed in turns: graphs, eager, eager, graphs.
        timed = {"graphs": [], "eager": []}
        for route in ("graphs", "eager", "eager", "graphs"):
            with eager_programs() if route == "eager" else contextlib.nullcontext():
                out, sec = sweep(cache if route == "graphs" else None)
            timed[route].append(sec)
            if route == "graphs":
                rows_again = out
        seconds, eager_s = (sum(timed[r]) / 2 for r in ("graphs", "eager"))
        mlp = "ln_mlp_residual_int8" if tier == "int8" else "ln_mlp_residual"
        per_forward = counts_of(packed_attention=layers, **{mlp: layers})
        buckets, captured, ran = {}, dict.fromkeys(KERNELS, 0), dict.fromkeys(KERNELS, 0)
        for cap in cache.captures:
            bucket = cap.inputs[0].shape[0]
            per = graph_launches(cap, f"sweep, tier {tier}, bucket {bucket}")
            require(per == per_forward, f"sweep tier {tier}, bucket {bucket}: a replay "
                    f"launched {per}, want {per_forward}")
            buckets[bucket] = cap.replays
            for name in KERNELS:
                captured[name] += 2 * per[name]
                ran[name] += cap.replays * per[name]
        log(f"# sweep, tier {tier}: {n_images} images, {n_images / seconds:.2f} images/s on "
            f"graphs ({n_images / first_s:.2f} with the captures), {n_images / eager_s:.2f} "
            f"eager, on {card} (predict and device metrics; two sweeps each, in turns); "
            f"replays by bucket {buckets} over three sweeps, launches in replays {ran}, "
            f"counters (warm-ups and captures) {got}")
        require(buckets == {8: 15, 4: 3}, f"sweep buckets {buckets}: tail bucket not used")
        require(got == captured, f"sweep tier {tier}: counters {got}, want {captured}")
        for line in ev.results_table(rows).splitlines():
            log(f"#   {line}")
        require([r["class name"] for r in rows] == list(sizes) + ["Average"], "sweep rows")
        worst = max(abs(r[k] - e[k]) / 100 for rs in (rows, rows_again)
                    for r, e in zip(rs, rows_eager) for k in keys)
        log(f"#   graphs against eager: metrics within {worst:.2e} (tol {METRIC_TOL:.0e})")
        require(worst <= METRIC_TOL + 1e-12, f"sweep tier {tier}: graph metrics differ from "
                f"eager by {worst}")
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
            for key, v in zip(keys, dev):
                require(abs(row[key] - round(float(v), 4) * 100) < 1e-9,
                        f"sweep {name}: row {key} {row[key]} is not the device metric {v}")
        add_counts(total, read_counts())
        del cache
    add_counts(total, sweep_disk(card, ctx))
    return total


def sweep_disk(card, ctx):
    """The sweep a user of cli.evaluate runs: anchors, then evaluate_dataset
    over PNGs on disk (2 classes x 24 at 600 px, resized to 518 by the data
    layer, uint8 to the device), on graphs, with the native transforms on
    and off, at AACLIP_DATA_WORKERS 1 and 4, after a warm-up sweep that
    captures."""
    import tempfile

    import torch

    from aa_clip_iqm_tpu_torch.configs import EvalConfig
    from aa_clip_iqm_tpu_torch.data import datasets as data
    from aa_clip_iqm_tpu_torch.data import synthetic
    from aa_clip_iqm_tpu_torch.evaluation.predict import evaluate_dataset
    from aa_clip_iqm_tpu_torch.prompts import compute_frozen_anchors
    from aa_clip_iqm_tpu_torch.train import graphs

    cfg, det = ctx["cfg"], ctx["det"]
    classes = ("widget", "gadget")
    saved = {k: os.environ.get(k) for k in ("AACLIP_NATIVE", "AACLIP_DATA_WORKERS")}
    reset_counts()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_sweep_") as root:
        synthetic.generate(root, n_normal=12, n_anomalous=12, size=IMG + 82,
                           class_names=classes, seed=3, dataset_name="Synth")
        meta_root = synthetic.register_synthetic(root, class_names=classes)
        sets = data.get_dataset("Synth", IMG, None, -1, "test", metadata_root=meta_root,
                                device_normalize=True)
        n_images = sum(len(d) for d in sets.values())
        eval_cfg = EvalConfig(dataset="Synth", img_size=IMG, batch_size=16,
                              compute_dtype="bfloat16")
        cache = graphs.GraphCache()
        rates, pixel_auc = {}, {}
        try:
            # A warm-up sweep that captures, then the four settings in turns
            # (native and PIL at one thread twice each).
            for i, (native, workers) in enumerate((("1", 1), ("1", 1), ("0", 1), ("0", 4),
                                                   ("1", 4), ("1", 1), ("0", 1))):
                os.environ["AACLIP_NATIVE"], os.environ["AACLIP_DATA_WORKERS"] = (
                    native, str(workers))
                t0 = time.perf_counter()
                anchors = compute_frozen_anchors(det.frozen, det.trainable, cfg, "Synth",
                                                 adapted=False, compute_dtype=torch.bfloat16)
                rows = evaluate_dataset(det.frozen, det.trainable, cfg, eval_cfg, sets, anchors,
                                        compute_dtype=torch.bfloat16, graphs=cache)
                backend = "native" if data._use_native() else "PIL"
                if i:
                    rates.setdefault((backend, workers), []).append(
                        n_images / (time.perf_counter() - t0))
                pixel_auc[(backend, workers)] = rows[-1]["pixel AUC"]
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
    require(("native", 1) in rates and ("PIL", 1) in rates, f"sweep backends {list(rates)}")
    require(sorted(c.replays for c in cache.captures) == [14, 14],
            f"disk sweep replays {[c.replays for c in cache.captures]}")
    log(f"# sweep over {n_images} PNGs at {IMG + 82} px resized to {IMG} (anchors, decode, "
        "transforms, predict on graphs, device metrics; after a warm-up sweep that "
        "captured, in turns): "
        + ", ".join(f"{b} transforms, {w} decode thread{'s' * (w > 1)}: "
                    f"{' and '.join(f'{r:.2f}' for r in rs)} images/s "
                    f"(Average pixel AUC {pixel_auc[(b, w)]:.2f})"
                    for (b, w), rs in rates.items()) + f" on {card}")
    return read_counts()


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


def named_leaves(tree, prefix=""):
    """(name, tensor) for every leaf of a nested dict / list, in tree order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from named_leaves(v, f"{prefix}{k}/")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from named_leaves(v, f"{prefix}{i}/")
    else:
        yield prefix[:-1], tree


@contextlib.contextmanager
def eager_programs():
    """Inside, the training and evaluation programs run eagerly
    (``train.graphs.enabled`` answers False): the route that replays are
    held to and timed against."""
    from aa_clip_iqm_tpu_torch.train import graphs

    enabled = graphs.enabled
    graphs.enabled = lambda device, mesh=None: False
    try:
        yield
    finally:
        graphs.enabled = enabled


def graph_launches(cap, what, restore=contextlib.nullcontext):
    """The kernel launches that one replay of capture ``cap``
    (``train.graphs``) runs, measured as replay_launches measures a
    detector's: a replay under the profiler must run the port's device
    kernels that the eager program on the graph's own buffers (``cap.run``)
    runs, each as many times, and the counters count the eager run's
    launches. ``restore()`` undoes what a replay and the eager run do to a
    training state. Measured again, up to three times in all, when the
    profiler loses records."""
    for attempt in range(3):
        with restore():
            replayed = port_kernels(cap.graph.replay)
        with restore():
            before = read_counts()
            eager = port_kernels(cap.run)
            launched = diff_counts(read_counts(), before)
        if replayed and replayed == eager:
            return launched
        log(f"# {what}, measurement {attempt + 1}: a replay ran the port's kernels "
            f"{sorted(replayed.values())} times, the eager program {sorted(eager.values())}")
    raise Failure(f"{what}: a replay ran the port's kernels {replayed}, the eager program "
                  f"{eager}")


def rel_err(a, b):
    """RMS of a - b over the RMS of b (0 where both are zero)."""
    a, b = a.detach().float(), b.detach().float()
    return float((a - b).square().mean().sqrt() / b.square().mean().sqrt().clamp_min(1e-30))


def hold_replays(what, replayed, eager, again, fault=None):
    """Graph replays against eager steps, each a list of tensors (losses,
    features, updated tensors, optimizer state): bit for bit wherever two
    eager runs (``eager``, ``again``) agree bit for bit, else within
    REPLAY_TOL of them. ``fault``: replays on stale inputs, which must fail
    the same gate. Returns whether the two eager runs agreed bit for bit."""
    import torch

    require(len(replayed) == len(eager) == len(again), f"{what}: tensor lists differ")
    again_equal = all(torch.equal(a, b) for a, b in zip(again, eager))
    again_rel = max(rel_err(a, b) for a, b in zip(again, eager))
    equal = all(torch.equal(a, b) for a, b in zip(replayed, eager))
    worst = max(rel_err(a, b) for a, b in zip(replayed, eager))
    if again_equal:
        held = "bit for bit (two eager runs agree bit for bit)"
        require(equal, f"{what}: replays differ from the eager steps by {worst:.3e}, where two "
                "eager runs agree bit for bit")
    else:
        held = (f"within {REPLAY_TOL:.0e}: worst rms diff / rms {worst:.3e} (two eager runs "
                f"differ by {again_rel:.3e})")
        require(worst <= REPLAY_TOL, f"{what}: replays differ from the eager steps by {worst}")
    msg = f"# {what}: {len(eager)} tensors, replays against eager steps held {held}"
    if fault is not None:
        caught = (not all(torch.equal(a, b) for a, b in zip(fault, eager))
                  and max(rel_err(a, b) for a, b in zip(fault, eager)) > REPLAY_TOL)
        msg += (f"; planted fault (replays on the previous batch's images): worst "
                f"{max(rel_err(a, b) for a, b in zip(fault, eager)):.3e}, "
                f"{'caught' if caught else 'passed (NOT caught)'}")
        require(caught, f"{what}: the gate missed replays on stale inputs")
    log(msg)
    return again_equal


def update_err(a, b, before):
    """Two optimizers' results ``a`` and ``b`` from the parameters
    ``before``: the largest |a - b| beyond two float32 roundings of the
    operands (2 eps max(|before|, |a|, |b|)), relative to the update
    b - before, per element (0 where within the roundings)."""
    import torch

    eps = torch.finfo(torch.float32).eps
    a, b, before = (t.detach().float() for t in (a, b, before))
    floor = 2 * eps * torch.maximum(before.abs(), torch.maximum(a.abs(), b.abs()))
    excess = ((a - b).abs() - floor).clamp_min(0.0)
    update = (b - before).abs()
    err = torch.where(excess == 0, torch.zeros_like(excess),
                      excess / update.clamp_min(torch.finfo(torch.float32).tiny))
    return float(err.max())


def optimizer_tensors(opt_state):
    """The optimizer's state tensors (moments, step counters), in order."""
    import torch

    return [v for st in opt_state.optimizer.state.values() for _, v in sorted(st.items())
            if isinstance(v, torch.Tensor)]


def stage2_batches(cfg, anchors, n=3, seed=21):
    """``n`` seeded stage-2 batches of B on the card: images, masks, labels,
    the anchors of alternating classes and weights."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    names = [list(anchors)[j % len(anchors)] for j in range(B)]
    out = []
    for _ in range(n):
        out.append((
            torch.from_numpy(rng.standard_normal((B, 3, IMG, IMG)).astype(np.float32)).to(DEVICE),
            torch.from_numpy((rng.random((B, 1, IMG, IMG)) > 0.9).astype(np.float32)).to(DEVICE),
            torch.from_numpy(rng.integers(0, 2, B)).to(DEVICE),
            torch.stack([anchors[c] for c in names]),
            torch.ones(B, device=DEVICE)))
    return out


def stage2_block(cfg, frozen, snap, batches, route, accum=1, n=3, stale=False, mesh=None):
    """``n`` stage-2 steps at batch B from the snapshot ``snap`` (the
    adapters and the optimizer's state): ``route`` "eager" (the capturable
    optimizer, run eagerly), "plain" (the optimizer that is not capturable,
    with float learning rates) or "graph" (replays of a GraphedStep;
    ``stale`` skips the copy-in after the first step, a planted fault).
    ``mesh``: the step's data-parallel mesh. Returns (losses + updated
    tensors + optimizer state as one list, the step, its optimizer, the
    parameters)."""
    import copy

    import torch

    from aa_clip_iqm_tpu_torch.configs import TrainConfig
    from aa_clip_iqm_tpu_torch.loader import init_trainable
    from aa_clip_iqm_tpu_torch.models.convert import tree_leaves
    from aa_clip_iqm_tpu_torch.train import graphs, optim, steps

    params = init_trainable(cfg, seed=111, device=DEVICE, dtype=torch.float32,
                            requires_grad=True)
    with torch.no_grad():
        for dst, src in zip(tree_leaves(params), snap["params"]):
            dst.copy_(src)
    opt = optim.stage2_optimizer(params, 5e-4, 3, graphable=route != "plain")
    opt.load_state_dict(copy.deepcopy(snap["opt"]))
    train_cfg = TrainConfig(img_size=IMG, compute_dtype="bfloat16", grad_accum_steps=accum)
    step = steps.make_stage2_step(cfg, train_cfg, compute_dtype=torch.bfloat16, mesh=mesh)
    if route == "graph":
        step = graphs.GraphedStep(step, graphs.GraphCache(), "stage2 step")
    drop = cfg.clip.vision.patch_dropout > 0
    losses = []
    for i in range(n):
        rng = torch.Generator(device=DEVICE).manual_seed(1000 + i) if drop else None
        if stale and i > 0:
            (g,) = step.graphs.values()
            for t, grad in zip(tree_leaves(params), g.grads):
                t.grad = grad
            g.graph.replay()
            opt.advance()
            losses.append(g.outputs.clone())
        else:
            losses.append(step(params, opt, frozen, *batches[i], rng)[2])
    torch.cuda.synchronize()
    return ([*losses, *(t.detach().clone() for t in tree_leaves(params)),
             *(t.clone() for t in optimizer_tensors(opt))], step, opt, params)


def stage1_block(cfg, frozen, snap, batches, prompts, route):
    """The stage-1 batches from the snapshot ``snap`` (the text adapter and
    its optimizer's state): the feature program and the step, eagerly with
    the capturable optimizer (``route`` "eager") or as graph replays
    ("graph"). Returns (features + losses + text adapter + optimizer state
    as one list, the feature program, the step, the optimizer, the text
    adapter)."""
    import copy

    import torch

    from aa_clip_iqm_tpu_torch.configs import TrainConfig
    from aa_clip_iqm_tpu_torch.loader import init_trainable
    from aa_clip_iqm_tpu_torch.models.convert import tree_leaves
    from aa_clip_iqm_tpu_torch.train import graphs, optim, steps

    text = init_trainable(cfg, seed=111, device=DEVICE, dtype=torch.float32,
                          requires_grad=True)["text_adapter"]
    with torch.no_grad():
        for dst, src in zip(tree_leaves(text), snap["params"]):
            dst.copy_(src)
    opt = optim.stage1_optimizer(text, 1e-5, graphable=True)
    opt.load_state_dict(copy.deepcopy(snap["opt"]))
    visual = steps.make_stage1_visual_fn(cfg, compute_dtype=torch.bfloat16)
    step = steps.make_stage1_step(cfg, TrainConfig(img_size=IMG, dataset="Synth"), *prompts,
                                  compute_dtype=torch.bfloat16)
    if route == "graph":
        cache = graphs.GraphCache()
        visual = graphs.GraphedFn(visual, cache, "stage1 features")
        step = graphs.GraphedStep(step, cache, "stage1 step")
    out = []
    for images, masks, class_idx, weights in batches:
        feats = visual(frozen, images)
        out.extend(f.clone() for f in feats)
        out.append(step(text, opt, frozen, feats, masks, class_idx, weights)[2])
    torch.cuda.synchronize()
    return ([*out, *(t.detach().clone() for t in tree_leaves(text)),
             *(t.clone() for t in optimizer_tensors(opt))], visual, step, opt, text)


def phase_train(card, cfg, frozen):
    """run_training on a synthetic two-class dataset written to a temporary
    directory at a size that the data layer resizes: ViT-L-14-336 at 518
    px, full depth, bf16 compute, float32 adapters; stage 1 for 2 steps,
    the anchors, stage 2 for 3 steps, every program a CUDA graph replay.
    Then the replays against eager steps, the launches a replay runs, the
    checkpoints and a resume, the gradients, and the rates of both routes."""
    import logging
    import tempfile
    from dataclasses import replace

    import numpy as np
    import torch

    from aa_clip_iqm_tpu_torch.cli import bench
    from aa_clip_iqm_tpu_torch.configs import TrainConfig
    from aa_clip_iqm_tpu_torch.data import datasets, synthetic
    from aa_clip_iqm_tpu_torch.loader import init_trainable
    from aa_clip_iqm_tpu_torch.models import clip
    from aa_clip_iqm_tpu_torch.models.convert import tree_leaves
    from aa_clip_iqm_tpu_torch.prompts import batched_prompt_tokens
    from aa_clip_iqm_tpu_torch.train import checkpoint as ckpt, driver, graphs, optim, steps

    classes = ("bottle", "screw")
    layers, text_layers = cfg.clip.vision.layers, cfg.clip.text.layers
    vv_blocks = layers - clip.surgery_vv_from(layers, cfg.surgery_until_layer)
    vis = layers + vv_blocks
    logger = logging.getLogger("chip_smoke.train")
    logger.addHandler(logging.NullHandler())
    logger.propagate = False
    trainable = init_trainable(cfg, seed=111, device=DEVICE, dtype=torch.float32,
                               requires_grad=True)
    names = [n for n, _ in named_leaves(trainable)]
    labels = list(tree_leaves(optim.stage2_param_labels(trainable)))
    start = [t.detach().clone() for t in tree_leaves(trainable)]

    def snapshot(params):
        return [t.detach().clone() for t in tree_leaves(params)]

    def grads_of(params):
        return [None if t.grad is None else t.grad.detach().clone()
                for t in tree_leaves(params)]

    # Every step and feature batch that run_training takes goes through
    # these spies: the programs (and their captures), the loss and time per
    # step, and for the first stage-2 step its inputs, the parameters before
    # it and the gradients after it, and a step checkpoint after it (the
    # point a resume starts from).
    record = {"stage1": [], "stage2": [], "first": None, "programs": {}}
    calls = (graphs.GraphedStep.__call__, graphs.GraphedFn.__call__)
    resume_root = tempfile.mkdtemp(prefix="chip_smoke_resume_")

    def spied_step(self, params, opt_state, *rest):
        stage = self.name.split()[0]
        first = stage == "stage2" and record["first"] is None
        before = snapshot(params) if first else None
        captures = len(self.cache.captures)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = calls[0](self, params, opt_state, *rest)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        record["programs"][self.name] = (self, params, opt_state)
        record[stage].append({"ms": ms, "loss": float(out[2]),
                              "captured": len(self.cache.captures) > captures})
        if first:
            record["first"] = {"before": before, "args": rest, "opt_state": opt_state,
                               "grads": grads_of(params)}
            ckpt.save_step(resume_root, "stage2", 0, 1, params, opt_state)
        return out

    def spied_fn(self, *args):
        record["programs"][self.name] = (self, None, None)
        return calls[1](self, *args)

    root = tempfile.mkdtemp(prefix="chip_smoke_train_")   # removed at the phase's end
    t0 = time.perf_counter()
    written = IMG + 82          # 600 px: the data layer resizes every image
    synthetic.generate(root, n_normal=6, n_anomalous=6, size=written, class_names=classes,
                       seed=11)
    meta_root = synthetic.register_synthetic(root, classes)
    train_cfg = TrainConfig(
        dataset="Synth", img_size=IMG, training_mode="full_shot", shot=-1,
        text_batch_size=16, image_batch_size=B, text_epoch=1, image_epoch=1,
        save_path=os.path.join(root, "ckpt"), compute_dtype="bfloat16", remat=False)
    log(f"# training: 24 synthetic images of {len(classes)} classes at {written} px "
        f"written in {time.perf_counter() - t0:.1f} s; transforms: "
        f"{'native' if datasets._use_native() else 'PIL'} (resized to {IMG} px)")
    require(datasets._use_native(), "training: the data layer is not on the native "
            "transforms")
    reset_counts()
    graphs.GraphedStep.__call__, graphs.GraphedFn.__call__ = spied_step, spied_fn
    try:
        t0 = time.perf_counter()
        out, anchors = driver.run_training(frozen, trainable, cfg, train_cfg, logger,
                                           metadata_root=meta_root)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    finally:
        graphs.GraphedStep.__call__, graphs.GraphedFn.__call__ = calls
    counts = read_counts()
    final = snapshot(trainable)
    require(out is trainable and list(anchors) == list(classes), "run_training outputs")
    rows = [json.loads(line) for line in open(os.path.join(train_cfg.save_path,
                                                           "scalars.jsonl"))]
    require([(r["stage"], r["step"]) for r in rows]
            == [("stage1", 0), ("stage1", 1), ("stage2", 0), ("stage2", 1), ("stage2", 2)],
            f"scalars.jsonl rows {rows}")
    restored = init_trainable(cfg, seed=5, device=DEVICE, dtype=torch.float32)
    _, adapted, epoch = ckpt.restore_adapters(train_cfg.save_path, restored)
    require(adapted and epoch == 1, "restore_adapters found no trained checkpoint")
    require(all(torch.equal(a, b) for a, b in zip(tree_leaves(restored),
                                                  tree_leaves(trainable))),
            "the epoch checkpoint does not hold the trained tensors")

    # A step checkpoint of the graphed run written and read back: tensors
    # and optimizer state bit for bit.
    first = record["first"]
    ckpt.save_step(train_cfg.save_path, "stage2", 0, 3, trainable, first["opt_state"])
    other = init_trainable(cfg, seed=5, device=DEVICE, dtype=torch.float32)
    opt2 = optim.stage2_optimizer(other, train_cfg.image_lr, 3)
    got = ckpt.load_step(train_cfg.save_path, "stage2", other, opt2)
    require(got is not None and (got["epoch"], got["step"]) == (0, 3), "load_step")
    same = all(torch.equal(a, b) for a, b in zip(tree_leaves(other), tree_leaves(trainable)))
    st_a = first["opt_state"].state_dict()["optimizer"]["state"]
    st_b = opt2.state_dict()["optimizer"]["state"]
    same_opt = st_a.keys() == st_b.keys() and all(
        torch.equal(torch.as_tensor(st_a[k][f]).cpu(), torch.as_tensor(st_b[k][f]).cpu())
        for k in st_a for f in st_a[k])
    log(f"# training: step checkpoint round trip of the graphed run: tensors equal {same}, "
        f"optimizer state equal {same_opt} ({len(st_a)} tensors with moments)")
    require(same and same_opt, "a reloaded step checkpoint differs from what was saved")
    del restored, other, opt2
    image_ds = datasets.get_dataset(train_cfg.dataset, IMG, train_cfg.training_mode,
                                    train_cfg.shot, "train", logger,
                                    metadata_root=meta_root, seed=train_cfg.seed)[1]

    s1, s2 = record["stage1"], record["stage2"]
    log(f"# training: run_training took {seconds:.1f} s on graphs; launches {counts} (warm-ups, "
        "captures and the anchors: a replay moves no counter)")
    for stage, recs in (("stage1", s1), ("stage2", s2)):
        for i, r in enumerate(recs):
            log(f"#   {stage} step {i}: loss {r['loss']:.5f}, {r['ms']:.1f} ms"
                f"{' (warm-up and capture included)' if r['captured'] else ' (replay)'}")
    require(len(s1) == 2 and len(s2) == 3, f"steps taken: {len(s1)} + {len(s2)}")
    require(all(np.isfinite(r["loss"]) for r in s1 + s2), "a training loss is not finite")

    # What each replay launches, measured (graph_launches), and the run's
    # counters: a warm-up and a capture of each graph, and the anchors.
    features, _, _ = record["programs"]["stage1 features"]
    s1_step, s1_params, s1_opt = record["programs"]["stage1 step"]
    s2_step, s2_params, s2_opt = record["programs"]["stage2 step"]
    want = {"stage1 features": counts_of(packed_attention=vis, ln_mlp_residual=vis),
            "stage1 step": counts_of(ln_mlp_residual=text_layers),
            "stage2 step": counts_of(packed_attention=layers, ln_mlp_residual=layers,
                                     packed_attention_bwd=layers - 1,
                                     ln_mlp_residual_dx=layers - 1)}
    restores = {"stage1 features": contextlib.nullcontext,
                "stage1 step": lambda: graphs.state_restored(s1_params, s1_opt),
                "stage2 step": lambda: graphs.state_restored(s2_params, s2_opt)}
    expected = counts_of(ln_mlp_residual=text_layers)
    for prog in (features, s1_step, s2_step):
        for cap in prog.graphs.values():
            what = f"training graph {prog.name}, batch {cap.inputs[0].shape[0]}"
            per = graph_launches(cap, what, restores[prog.name])
            log(f"# {what}: {cap.replays} replays, each {per}; captured in "
                f"{cap.capture_s:.2f} s, pool +{cap.pool_bytes / 1e9:.2f} GB")
            require(per == want[prog.name], f"{what}: a replay launched {per}, want "
                    f"{want[prog.name]}")
            for name in KERNELS:
                expected[name] += 2 * per[name]
    require(sorted(c.replays for c in features.graphs.values()) == [1, 1]
            and sorted(c.replays for c in s1_step.graphs.values()) == [1, 1]
            and [c.replays for c in s2_step.graphs.values()] == [3],
            "the replays are not the steps taken")
    require(all(int(v) == n for opt, n in ((s1_opt, 2), (s2_opt, 3))
                for st in opt.optimizer.state.values() for k, v in st.items() if k == "step"),
            "the optimizers' step counters are not the steps taken")
    require(counts == expected, f"run_training launches {counts}, want {expected}")
    log(f"# training: the graphs took exactly the steps of the run (2 stage-1, 3 stage-2 "
        f"replays; the optimizers' step counters 2 and 3); stage-2 pool "
        f"{s2_step.cache.memory() / 1e9:.2f} GB, stage 1 {s1_step.cache.memory() / 1e9:.2f} GB")

    # What moved: stage 1 trains the text adapter, stage 2 the image and IQM
    # groups; the rest of the "frozen" label group stays as it was made.
    moved = [not torch.equal(a, b) for a, b in zip(start, final)]
    for name, label, m in zip(names, labels, moved):
        want_move = label != "frozen" or name.startswith("text_adapter/")
        require(m == want_move, f"{name} ({label}): {'moved' if m else 'did not move'}")
    log(f"# training: {sum(moved)} of {len(moved)} tensors moved; the "
        f"{len(moved) - sum(moved)} that did not carry the 'frozen' label")
    require(all(not t.requires_grad and t.grad is None for t in tree_leaves(frozen)),
            "the frozen backbone got a gradient")
    s1_snap = {"params": snapshot(s1_params), "opt": copy.deepcopy(s1_opt.state_dict())}
    s2_snap = {"params": final, "opt": copy.deepcopy(s2_opt.state_dict())}
    del record["programs"], features, s1_step, s2_step, s1_params, s1_opt, s2_params, s2_opt
    torch.cuda.empty_cache()

    # The first stage-2 step once more from the same parameters, eagerly:
    # twice through the kernels (the replay's gradients against them), with
    # the backward kernels alone swapped for their plain versions (and for a
    # planted fault), and with every kernel swapped. That last route
    # checkpoints its blocks: autograd through the plain attention would
    # otherwise keep every block's (B, H, L, L) probabilities.
    _, images, masks, labels_t, anchor_stack, weights, rng = first["args"]

    def grads_through(route, remat, batch=B):
        params = init_trainable(cfg, seed=111, device=DEVICE, dtype=torch.float32)
        with torch.no_grad():
            for dst, src in zip(tree_leaves(params), first["before"]):
                dst.copy_(src)
        for t in tree_leaves(params):
            t.requires_grad_(True)
        step_cfg = TrainConfig(dataset="Synth", img_size=IMG, compute_dtype="bfloat16",
                               remat=remat)
        fn = steps.make_stage2_step(cfg, step_cfg, compute_dtype=torch.bfloat16).loss_fn
        with route:
            loss = fn(params, frozen, images[:batch], masks[:batch], labels_t[:batch],
                      anchor_stack[:batch], weights[:batch], rng)
            loss.backward()
        torch.cuda.synchronize()
        return float(loss.detach()), grads_of(params)

    rel = rel_err
    _, g_again = grads_through(contextlib.nullcontext(), remat=False)
    _, g_twice = grads_through(contextlib.nullcontext(), remat=False)
    require(all((a is None) == (b is None) for a, b in zip(first["grads"], g_again)),
            "the eager step gives gradients to other tensors than the replay")
    hold_replays("training, the first stage-2 step's gradients (run_training's replay)",
                 [g for g in first["grads"] if g is not None],
                 [g for g in g_again if g is not None], [g for g in g_twice if g is not None])
    del g_twice
    # (a) The same forward kernels with the backward kernels swapped for
    # their plain versions: only the adapters of blocks 0-5 lie upstream of a
    # backward kernel, every other tensor must come out the same.
    loss_b, g_bwd = grads_through(_PlainBackward(), remat=False)
    _, g_fault = grads_through(_PlainBackward(mlp_dx=dx_no_ln_means), remat=False)
    # (b) Every kernel, forward and backward, swapped for its plain version.
    loss_p, g_plain = grads_through(_Twins(), remat=True)
    upstream = "image_adapter/layer_adapters/"
    worst = {"bwd": 0.0, "fault": 0.0, "twins": 0.0, "rest": 0.0, "rest_twins": (0.0, "")}
    got_grad = 0
    for name, gk, gb, gf, gp in zip(names, g_again, g_bwd, g_fault, g_plain):
        require((gk is None) == (gb is None) == (gp is None),
                f"{name}: a gradient on one route only")
        if gk is None:
            continue
        got_grad += 1
        require(torch.isfinite(gk).all().item(), f"{name}: gradient not finite")
        rb, rf, rp = rel(gk, gb), rel(gf, gb), rel(gk, gp)
        if name.startswith(upstream):
            log(f"#   grad {name}: rms {gb.float().square().mean().sqrt().item():.3e}; kernels "
                f"vs plain backward {rb:.3e}, planted fault vs plain backward {rf:.3e}, "
                f"kernels vs all plain {rp:.3e}")
            worst["bwd"], worst["fault"] = max(worst["bwd"], rb), max(worst["fault"], rf)
            worst["twins"] = max(worst["twins"], rp)
            require(rb <= GRAD_BWD_TOL, f"{name}: the backward kernels' gradient differs "
                    f"from the plain backward's by {rb}")
            require(rp <= GRAD_TOL, f"{name}: kernel-route gradient differs from the plain "
                    f"route's by {rp}")
        else:
            worst["rest"] = max(worst["rest"], rb)
            worst["rest_twins"] = max(worst["rest_twins"], (rp, name))
            if rp > GRAD_TOL:
                log(f"#   grad {name} (downstream of the tower): rms "
                    f"{gp.float().square().mean().sqrt().item():.3e}, kernels vs all plain "
                    f"{rp:.3e}")
    g0 = g_again[names.index("image_adapter/layer_adapters/0/w")]
    require(g0 is not None and g0.abs().max().item() > 0,
            "no gradient reached block 0's adapter")
    log(f"# training, first stage-2 step, {got_grad} tensors with gradients. Adapters of blocks "
        f"0-5 (upstream of B4/B5), worst rms diff / rms: kernels vs plain backward "
        f"{worst['bwd']:.3e} (tol {GRAD_BWD_TOL:.0e}), planted fault (B5 without the LayerNorm "
        f"mean terms) {worst['fault']:.3e}, kernels vs all plain {worst['twins']:.3e} (tol "
        f"{GRAD_TOL:.0e}). Other tensors: kernels vs plain backward {worst['rest']:.3e} (the "
        f"same forward), vs all plain at most {worst['rest_twins'][0]:.3e} "
        f"({worst['rest_twins'][1]}; forward rounding only, not held). Loss {s2[0]['loss']:.5f}, "
        f"plain backward {loss_b:.5f}, all plain {loss_p:.5f}")
    require(worst["rest"] <= 1e-6, "a tensor downstream of the tower depends on the backward route")
    require(worst["fault"] > GRAD_BWD_TOL, "the gradient check missed the planted fault")

    # Checkpointed blocks: the same loss (and gradients) at batch 2.
    loss_a, g_a = grads_through(contextlib.nullcontext(), remat=False, batch=2)
    reset = read_counts()
    loss_r, g_b = grads_through(contextlib.nullcontext(), remat=True, batch=2)
    remat_counts = {n: read_counts()[n] - reset[n] for n in KERNELS}
    g_rel = max(rel(a, b) for a, b in zip(g_b, g_a) if a is not None)
    log(f"# training, remat at batch 2: loss {loss_r:.6f} against {loss_a:.6f} without, "
        f"gradients differ by at most {g_rel:.3e}; launches with remat {remat_counts}")
    require(abs(loss_r - loss_a) <= 1e-3 * abs(loss_a), "remat changes the loss")
    require(g_rel <= 1e-3, "remat changes the gradients")

    # The first stage-2 step with the fused attention half-block
    # (AACLIP_FUSED_ATTN=1): 24 of it forward, its backward the plain chain
    # (as in JAX), so no attention backward kernel; the MLP dx kernel as
    # before. Its gradients against the kernel route with the flag off.
    clip.FUSED_ATTN = True
    try:
        reset = read_counts()
        loss_fz, g_fz = grads_through(contextlib.nullcontext(), remat=False)
        fused_counts = diff_counts(read_counts(), reset)
    finally:
        clip.FUSED_ATTN = False
    fz_rel = max(rel(a, b) for name, a, b in zip(names, g_fz, g_again)
                 if name.startswith(upstream) and a is not None)
    log(f"# training, the first stage-2 step with the fused attention half: loss {loss_fz:.5f} "
        f"(flag off {s2[0]['loss']:.5f}), adapters of blocks 0-5 against the flag off: worst rms "
        f"diff / rms {fz_rel:.3e} (tol {GRAD_TOL:.0e}); launches {fused_counts}")
    require(np.isfinite(loss_fz), "the fused stage-2 loss is not finite")
    require(fused_counts == counts_of(ln_attn_residual=layers, ln_mlp_residual=layers,
                                      ln_mlp_residual_dx=layers - 1),
            f"fused stage-2 step launches {fused_counts}")
    require(fz_rel <= GRAD_TOL, f"fused stage-2 gradients differ by {fz_rel}")
    add_counts(counts, fused_counts)
    del g_again, g_bwd, g_plain, g_fault, g_a, g_b, g_fz, record, first
    torch.cuda.empty_cache()

    # Stage 2 from one snapshot (run_training's adapters and optimizer after
    # its 3 steps): 3 replays of a captured step against 3 eager steps of the
    # capturable optimizer (and 3 again, for the gate), at accum 1 and 2,
    # with patch dropout and on the fused route; the eager step against the
    # optimizer that is not capturable; a replay on stale inputs.
    batches = stage2_batches(cfg, anchors)
    cfg_drop = replace(cfg, clip=replace(cfg.clip, vision=replace(cfg.clip.vision,
                                                                  patch_dropout=0.25)))
    deterministic = {}
    for label, model, accum, fused in (("accum 1", cfg, 1, False), ("accum 2", cfg, 2, False),
                                       ("patch dropout 0.25", cfg_drop, 1, False),
                                       ("fused attention", cfg, 1, True)):
        clip.FUSED_ATTN = fused
        try:
            reset = read_counts()
            eager, _, _, _ = stage2_block(model, frozen, s2_snap, batches, "eager", accum)
            again, _, _, _ = stage2_block(model, frozen, s2_snap, batches, "eager", accum)
            replayed, gstep, gopt, gparams = stage2_block(model, frozen, s2_snap, batches,
                                                          "graph", accum)
            add_counts(counts, diff_counts(read_counts(), reset))
            (cap,) = gstep.graphs.values()
            per = graph_launches(cap, f"stage 2, {label}",
                                 lambda: graphs.state_restored(gparams, gopt))
            k = 2 if accum == 2 else 1
            attn = {"ln_attn_residual": k * layers} if fused else {
                "packed_attention": k * layers, "packed_attention_bwd": k * (layers - 1)}
            want_per = counts_of(ln_mlp_residual=k * layers, ln_mlp_residual_dx=k * (layers - 1),
                                 **attn)
            require(per == want_per, f"stage 2, {label}: a replay launched {per}, want "
                    f"{want_per}")
            fault = None
            if label == "accum 1":
                fault, _, _, _ = stage2_block(model, frozen, s2_snap, batches, "graph", accum,
                                              stale=True)
            deterministic[label] = hold_replays(
                f"training, stage 2 at batch {B}, {label}, 3 steps from one snapshot (each "
                f"replay {per})", replayed, eager, again, fault)
            log(f"#   stage 2, {label}: capture {cap.capture_s:.2f} s (warm-up included), "
                f"pool {gstep.cache.memory() / 1e9:.2f} GB")
            if label == "accum 1":
                # One eager step against the optimizer that is not capturable
                # (float learning rates, step counters on the host): the same
                # loss, the updated tensors within float32 rounding.
                plain, _, _, _ = stage2_block(model, frozen, s2_snap, batches, "plain", n=1)
                one, _, _, _ = stage2_block(model, frozen, s2_snap, batches, "eager", n=1)
                n_params = len(s2_snap["params"])
                pairs = list(zip(one[1:1 + n_params], plain[1:1 + n_params],
                                 s2_snap["params"]))
                err = max(update_err(a, b, s) for a, b, s in pairs)
                differ = sum(int((a != b).sum()) for a, b, _ in pairs)
                log(f"# training, stage 2, the capturable optimizer against the one that is "
                    f"not: loss {'equal' if torch.equal(one[0], plain[0]) else 'differs'} "
                    f"({float(one[0]):.6f} and {float(plain[0]):.6f}); {differ} of "
                    f"{sum(a.numel() for a, _, _ in pairs)} updated elements differ, by at "
                    f"most {err:.3e} of their update beyond two float32 roundings (tol "
                    f"{UPDATE_TOL:.0e})")
                require(torch.equal(one[0], plain[0]) or not deterministic.get("accum 1", True),
                        "the two optimizers' steps start from different losses")
                require(err <= UPDATE_TOL, f"the capturable optimizer's update differs by {err}")
                profile_call(lambda: gstep(gparams, gopt, frozen, *batches[0], None),
                             f"one stage-2 step at batch {B}, graph replay")
            del eager, again, replayed, gstep, gopt, gparams, cap, fault
        finally:
            clip.FUSED_ATTN = False
        torch.cuda.empty_cache()

    # A resume of the graphed run from its step checkpoint after stage-2
    # step 1: run_stage2 restores, captures anew and takes steps 1 and 2;
    # its adapters against the uninterrupted run's.
    resumed = init_trainable(cfg, seed=5, device=DEVICE, dtype=torch.float32, requires_grad=True)
    resume_cfg = replace(train_cfg, save_path=resume_root, checkpoint_every_steps=1)
    reset = read_counts()
    t0 = time.perf_counter()
    driver.run_stage2(frozen, resumed, cfg, resume_cfg, image_ds, anchors, logger)
    torch.cuda.synchronize()
    add_counts(counts, diff_counts(read_counts(), reset))
    shutil.rmtree(resume_root, ignore_errors=True)
    pairs = list(zip(tree_leaves(resumed), final))
    r_equal = all(torch.equal(a, b) for a, b in pairs)
    r_worst = max(rel(a, b) for a, b in pairs)
    log(f"# training, resume from the graphed run's step checkpoint at stage-2 step 1 (a new "
        f"capture, steps 1 and 2 in {time.perf_counter() - t0:.1f} s): adapters "
        f"{'equal bit for bit' if r_equal else f'within {r_worst:.3e}'} of the uninterrupted "
        "run's")
    if deterministic["accum 1"]:
        require(r_equal, f"the resumed run differs from the uninterrupted one by {r_worst}")
    else:
        require(r_worst <= REPLAY_TOL, f"the resumed run differs by {r_worst}")
    del resumed, image_ds

    # Stage 1 from one snapshot (run_training's text adapter and Adam state):
    # 3 feature batches and steps at batch 16 as replays against eager.
    prompt_classes, tokens, n_norm, n_abn = batched_prompt_tokens(train_cfg.dataset)
    s1_prompts = (torch.from_numpy(np.asarray(tokens, np.int64)).to(DEVICE),
                  len(prompt_classes), n_norm, n_abn)
    gen = np.random.default_rng(31)
    s1_batches = [(torch.from_numpy(gen.standard_normal((16, 3, IMG, IMG)).astype(np.float32))
                   .to(DEVICE),
                   torch.from_numpy((gen.random((16, 1, IMG, IMG)) > 0.9).astype(np.float32))
                   .to(DEVICE),
                   torch.from_numpy(gen.integers(0, len(prompt_classes), 16)).to(DEVICE),
                   torch.ones(16, device=DEVICE)) for _ in range(3)]
    reset = read_counts()
    eager, _, _, _, _ = stage1_block(cfg, frozen, s1_snap, s1_batches, s1_prompts, "eager")
    again, _, _, _, _ = stage1_block(cfg, frozen, s1_snap, s1_batches, s1_prompts, "eager")
    replayed, gvis, gstep, gopt, gtext = stage1_block(cfg, frozen, s1_snap, s1_batches,
                                                      s1_prompts, "graph")
    add_counts(counts, diff_counts(read_counts(), reset))
    hold_replays("training, stage 1 at batch 16, 3 feature batches and steps from one snapshot",
                 replayed, eager, again)
    profile_call(lambda: gstep(gtext, gopt, frozen, gvis(frozen, s1_batches[0][0]),
                               *s1_batches[0][1:]),
                 "one stage-1 batch of 16, graph replays (features and step)")
    del eager, again, replayed, gvis, gstep, gopt, gtext, s1_batches
    torch.cuda.empty_cache()

    # Rates of both stages on both routes (cli/bench.py's train and stage1
    # modes: a fixed device-resident batch, MVTec's prompt ensemble, CUDA
    # events around blocks of 3), and where an eager stage-2 step's time goes.
    for mode, batch in (("stage1", 16), ("train", B)):
        rates = {}
        for route in ("graphs", "eager"):
            with eager_programs() if route == "eager" else contextlib.nullcontext():
                samples, _ = bench._measure_train(mode, cfg, frozen, batch, IMG, None, iters=3,
                                                  repeats=2)
            rates[route] = float(np.median(samples))
            log(f"# training, {bench.TRAIN_METRICS[mode]}, {route}: {rates[route]:.2f} "
                f"images/s, {batch / rates[route] * 1e3:.1f} ms per step of {batch} on {card} "
                f"(blocks of 3 steps: {', '.join(f'{s:.2f}' for s in samples)})")
        log(f"# training, {mode}: graphs / eager {rates['graphs'] / rates['eager']:.3f}")
    step_cfg = TrainConfig(dataset="Synth", img_size=IMG, compute_dtype="bfloat16")
    step = steps.make_stage2_step(cfg, step_cfg, compute_dtype=torch.bfloat16)
    opt_state = optim.stage2_optimizer(trainable, step_cfg.image_lr, 100)
    args = (images, masks, labels_t, anchor_stack, weights, rng)
    step(trainable, opt_state, frozen, *args)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    profile_call(lambda: step(trainable, opt_state, frozen, *args),
                 f"one stage-2 step at batch {B}, eager")
    log(f"# training: peak memory of an eager stage-2 step at batch {B} "
        f"{torch.cuda.max_memory_allocated() / 1e9:.1f} GB (a graph's pool holds a step's "
        "activations for as long as the graph lives: the pool sizes above)")
    shutil.rmtree(root, ignore_errors=True)
    return counts


def phase_fused(card, ctx):
    """The fused attention half-block on its two no-grad paths
    (models.clip.FUSED_ATTN, as AACLIP_FUSED_ATTN=1 sets it at import): a
    batch-8 request at 518 px and one stage-1 feature batch of 16."""
    import numpy as np
    import torch

    from aa_clip_iqm_tpu_torch.models import clip
    from aa_clip_iqm_tpu_torch.train import steps

    cfg, frozen, det, imgs8 = ctx["cfg"], ctx["frozen"], ctx["det"], ctx["imgs8"]
    layers = cfg.clip.vision.layers
    vv_blocks = layers - clip.surgery_vv_from(layers, cfg.surgery_until_layer)
    total = dict.fromkeys(KERNELS, 0)
    clip.FUSED_ATTN = True
    try:
        reset_counts()
        (maps, scores), ran = graph_request(det, lambda: det.predict(imgs8, "screw"))
        log(f"# fused attention, batch-8 request: maps in [{maps.min():.4f}, {maps.max():.4f}], "
            f"launches {ran} (graph replay)")
        ctx["check"](maps, scores, B, "fused attention request")
        require(ran == counts_of(ln_attn_residual=layers, ln_mlp_residual=layers),
                f"fused attention request: launches {ran}")
        add_counts(total, read_counts())
        rel_twins = map_diff(maps, ctx["maps_twins"])
        rel_off = map_diff(maps, ctx["maps_bf16"])
        log(f"# fused attention vs the twins, batch 8 map: rms diff / std {rel_twins:.3e} "
            f"(tol {MAP_TOL:.0e}); vs the flag off (B1 chain) {rel_off:.3e} (tol {MAP_TOL:.0e})")
        require(rel_twins <= MAP_TOL, f"fused map differs from the twins' by {rel_twins}")
        require(rel_off <= MAP_TOL, f"fused map differs from the flag off by {rel_off}")
        # (The random backbone's biases are zero, so dropping one is no fault
        # here; the kernels phase plants that one on random biases.)
        with _Twins(block=block_scale_dropped):
            rel_f = map_diff(det.predict(imgs8, "screw")[0], ctx["maps_twins"])
        log(f"# planted fault, B8 without its 1/sqrt(hd) scale, batch 8 map: rms diff / std "
            f"{rel_f:.3e}")
        require(rel_f > MAP_TOL, "map comparison missed the planted fault in B8")
        time_requests(det, imgs8, card, "fused attention (AACLIP_FUSED_ATTN=1)")
        profile_request(det, imgs8)

        # One stage-1 batch of 16: the no-grad dual tower, the surgery blocks
        # included, all through the fused block.
        rng = np.random.default_rng(31)
        images = torch.from_numpy(rng.standard_normal((16, 3, IMG, IMG)).astype(np.float32)).cuda()
        features = steps.make_stage1_visual_fn(cfg, compute_dtype=torch.bfloat16)
        reset_counts()
        t0 = time.perf_counter()
        feats = features(frozen, images)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        got = read_counts()
        n_fused = 2 * layers - (layers - vv_blocks)
        log(f"# fused attention, stage-1 feature batch of 16: {len(feats)} levels in "
            f"{seconds * 1e3:.1f} ms (first call), launches {got}")
        require(got == counts_of(ln_attn_residual=n_fused, ln_mlp_residual=n_fused),
                f"fused stage-1 batch: launches {got}, want {n_fused} fused blocks")
        require(all(torch.isfinite(f).all().item() and f.shape == (16, TOKENS - 1, cfg.clip.embed_dim)
                    for f in feats), "fused stage-1 features")
        add_counts(total, got)
    finally:
        clip.FUSED_ATTN = False
    feats_off = features(frozen, images)
    rel = max(float((a.float() - b.float()).square().mean().sqrt()
                    / b.float().square().mean().sqrt()) for a, b in zip(feats, feats_off))
    log(f"# fused attention, stage-1 features vs the flag off: worst rms diff / rms {rel:.3e} "
        f"(not held)")
    return total


def phase_highres(card, ctx):
    """AnomalyDetector on ViT-L-14-336 at 1274 px: 8,282 tokens, past the
    packed kernel's 8,192, so attention goes through the unpacked flash
    kernel. The weights are the 518 px ones with the positional embedding
    resized bicubically to the 91 x 91 grid, as a loader does for a cache
    saved at another size."""
    import numpy as np
    import torch

    from aa_clip_iqm_tpu_torch.loader import build_model_config
    from aa_clip_iqm_tpu_torch.models.clip import resize_pos_embed_np
    from aa_clip_iqm_tpu_torch.serving import AnomalyDetector

    cfg = build_model_config("ViT-L-14-336", img_size=HR_IMG)
    layers, text_layers = cfg.clip.vision.layers, cfg.clip.text.layers
    vis = ctx["frozen"]["visual"]
    pos = vis["positional_embedding"]
    resized = resize_pos_embed_np(pos.float().cpu().numpy(), cfg.clip.vision.grid)
    require(resized.shape == (HR_TOKENS, WIDTH), f"resized positional embedding {resized.shape}")
    frozen = {**ctx["frozen"], "visual": {**vis, "positional_embedding":
                                          torch.from_numpy(resized).to(pos.device, pos.dtype)}}
    reset_counts()
    # The default ladder (1, 8, 16, 32) would pad a batch of 2 to 8: at this
    # size a caller passes a finer one.
    det = AnomalyDetector(frozen, ctx["trainable"], cfg, "MVTec", img_size=HR_IMG,
                          compute_dtype=torch.bfloat16, device="cuda",
                          batch_buckets=(1, 2, 4, 8))
    torch.cuda.synchronize()
    total = read_counts()
    require(total == counts_of(ln_mlp_residual=text_layers), f"1274 px anchors: launches {total}")
    rng = np.random.default_rng(17)
    for n in (1, 2):
        imgs = rng.integers(0, 256, (n, 3, HR_IMG, HR_IMG), dtype=np.uint8)
        (maps, scores), ran = graph_request(det, lambda: det.predict(imgs, "screw"))
        log(f"# 1274 px, batch {n}: maps {maps.shape} in [{maps.min():.4f}, {maps.max():.4f}], "
            f"scores {np.round(scores, 4).tolist()}, launches {ran} (graph replay)")
        require(maps.shape == (n, HR_IMG, HR_IMG) and scores.shape == (n,), "1274 px shapes")
        require(np.isfinite(maps).all() and np.isfinite(scores).all(), "1274 px: non-finite")
        require(ran == counts_of(flash_attention=layers, ln_mlp_residual=layers),
                f"1274 px batch {n}: launches {ran}")
    total = read_counts()
    with _Twins():
        before = read_counts()
        maps_t, _ = det.predict(imgs, "screw")
        require(before == read_counts(), "twin run launched a kernel")
    rel = map_diff(maps, maps_t)
    log(f"# 1274 px, kernels vs twins, batch 2 map: rms diff / std {rel:.3e} (tol {HR_MAP_TOL:.0e})")
    require(rel <= HR_MAP_TOL, f"1274 px map differs from the twins' by {rel}")
    with _Twins(flash=flash_scale_dropped):
        rel_f = map_diff(det.predict(imgs, "screw")[0], maps_t)
    log(f"# planted fault, B7 scale dropped, 1274 px batch 2 map: rms diff / std {rel_f:.3e}")
    require(rel_f > HR_MAP_TOL, "1274 px map comparison missed the planted fault")
    del maps_t
    time_requests(det, imgs, card, "1274 px", n=6)
    profile_request(det, imgs)
    ctx["det_hr"], ctx["imgs_hr"] = det, imgs
    return total


def phase_surgery_backward(ctx):
    """dual_vision_features at 518 px, batch 2, full depth, differentiated to a
    float32 image through a scalar loss on the surgery taps: B6 on the
    value-value blocks, B4 on the shared prefix. The input's and every tap's
    gradient against the same backward with B6 alone on its plain version."""
    import contextlib

    import torch

    from aa_clip_iqm_tpu_torch.models import clip

    cfg, vis = ctx["cfg"], ctx["frozen"]["visual"]
    layers = cfg.clip.vision.layers
    vv_from = clip.surgery_vv_from(layers, cfg.surgery_until_layer)
    n_vv = layers - vv_from
    gen = torch.Generator(device="cuda").manual_seed(21)
    base = torch.randn((2, 3, IMG, IMG), generator=gen, device="cuda")

    def backward(route):
        img = base.clone().requires_grad_(True)
        with route:
            before = read_counts()
            _, taps = clip.dual_vision_features(vis, cfg.clip.vision, img, cfg.adapter.levels,
                                                vv_from, act_name=cfg.clip.act,
                                                compute_dtype=torch.bfloat16)
            for t in taps:
                t.retain_grad()
            loss = sum(t.float().square().mean() for t in taps)
            loss.backward()
            torch.cuda.synchronize()
            got = diff_counts(read_counts(), before)
        return float(loss.detach()), [img.grad] + [t.grad for t in taps], got

    t0 = time.perf_counter()
    loss_k, grads_k, got = backward(contextlib.nullcontext())
    seconds = time.perf_counter() - t0
    log(f"# surgery backward, batch 2: loss {loss_k:.5f} in {seconds * 1e3:.1f} ms, "
        f"launches {got}")
    forward = vv_from + 2 * n_vv
    require(got == counts_of(packed_attention=forward, ln_mlp_residual=forward,
                             packed_attention_bwd=vv_from, packed_attention_vv_bwd=n_vv),
            f"surgery backward: launches {got}, want {n_vv} B6 and {vv_from} B4")
    require(all(torch.isfinite(g).all().item() for g in grads_k), "surgery gradient not finite")
    require(grads_k[0].abs().max().item() > 0, "no gradient reached the image")
    loss_p, grads_p, got_p = backward(_PlainVvBackward())
    require(got_p["packed_attention_vv_bwd"] == 0 and got_p["packed_attention_bwd"] == vv_from,
            f"B6 swapped for its plain version: launches {got_p}")
    _, grads_f, _ = backward(_PlainVvBackward(fault=vv_bwd_no_key_term))

    def rel(a, b):
        return float((a.float() - b.float()).square().mean().sqrt()
                     / b.float().square().mean().sqrt().clamp_min(1e-30))

    names = ["image"] + [f"tap {lv}" for lv in cfg.adapter.levels]
    rels = [rel(a, b) for a, b in zip(grads_k, grads_p)]
    faults = [rel(a, b) for a, b in zip(grads_f, grads_p)]
    for name, r, f in zip(names, rels, faults):
        log(f"#   grad {name}: kernels vs plain B6 {r:.3e}, planted fault vs plain B6 {f:.3e}")
    log(f"# surgery backward: loss {loss_k:.5f} (plain B6 {loss_p:.5f}); worst rms diff / rms "
        f"{max(rels):.3e} (tol {SURGERY_TOL:.0e}), planted fault (B6 without its key term) on "
        f"the image gradient {faults[0]:.3e}")
    require(max(rels) <= SURGERY_TOL, f"surgery gradients differ from the plain B6's by {max(rels)}")
    require(faults[0] > SURGERY_TOL, "the surgery gradient check missed the planted B6 fault")
    del grads_k, grads_p, grads_f
    torch.cuda.empty_cache()
    return got


def openai_state_dict(params, cfg, dtype=None):
    """The OpenAI CLIP state dict of a numpy params tree in the JAX layout
    (blocks stacked), in fp16 as OpenAI ships it (or ``dtype``), with its
    three metadata entries: the inverse of
    models/convert.torch_state_dict_to_params, which the package itself
    never needs. A ModifiedResNet tree (RN50) gives the RN layout."""
    import numpy as np
    import torch

    dtype = dtype or torch.float16

    def half(x, transpose=False):
        x = np.asarray(x, np.float32)
        return torch.from_numpy(np.ascontiguousarray(x.T if transpose else x)).to(dtype)

    sd = {}

    def ln(name, p, i=None):
        sd[f"{name}.weight"] = half(p["scale"] if i is None else p["scale"][i])
        sd[f"{name}.bias"] = half(p["bias"] if i is None else p["bias"][i])

    def blocks(prefix, b, n):
        for i in range(n):
            p = f"{prefix}.{i}"
            ln(f"{p}.ln_1", b["ln_1"], i)
            sd[f"{p}.attn.in_proj_weight"] = half(b["attn"]["qkv"]["w"][i], True)
            sd[f"{p}.attn.in_proj_bias"] = half(b["attn"]["qkv"]["b"][i])
            sd[f"{p}.attn.out_proj.weight"] = half(b["attn"]["out"]["w"][i], True)
            sd[f"{p}.attn.out_proj.bias"] = half(b["attn"]["out"]["b"][i])
            ln(f"{p}.ln_2", b["ln_2"], i)
            for name in ("c_fc", "c_proj"):
                sd[f"{p}.mlp.{name}.weight"] = half(b["mlp"][name]["w"][i], True)
                sd[f"{p}.mlp.{name}.bias"] = half(b["mlp"][name]["b"][i])

    def conv_bn(prefix, conv, bn, bn_prefix):
        sd[f"{prefix}.weight"] = half(np.transpose(np.asarray(conv["kernel"]), (3, 2, 0, 1)))
        for key, name in (("weight", "scale"), ("bias", "bias"), ("running_mean", "mean"),
                          ("running_var", "var")):
            sd[f"{bn_prefix}.{key}"] = half(bn[name])

    v, t = params["visual"], params["text"]
    if "layers" in v:               # ModifiedResNet
        for i in (1, 2, 3):
            conv_bn(f"visual.conv{i}", v[f"conv{i}"], v[f"bn{i}"], f"visual.bn{i}")
        for s, blocks_ in enumerate(v["layers"], start=1):
            for i, blk in enumerate(blocks_):
                pre = f"visual.layer{s}.{i}"
                for j in (1, 2, 3):
                    conv_bn(f"{pre}.conv{j}", blk[f"conv{j}"], blk[f"bn{j}"], f"{pre}.bn{j}")
                if "downsample" in blk:
                    conv_bn(f"{pre}.downsample.0", blk["downsample"]["conv"],
                            blk["downsample"]["bn"], f"{pre}.downsample.1")
        ap = v["attnpool"]
        sd["visual.attnpool.positional_embedding"] = half(ap["positional_embedding"])
        for name, key in (("q", "q_proj"), ("k", "k_proj"), ("v", "v_proj"),
                          ("c_proj", "c_proj")):
            sd[f"visual.attnpool.{key}.weight"] = half(ap[name]["w"], True)
            sd[f"visual.attnpool.{key}.bias"] = half(ap[name]["b"])
    else:
        p = cfg.clip.vision.patch_size
        conv = np.asarray(v["patch_embed"]["w"], np.float32).T
        sd["visual.conv1.weight"] = half(conv.reshape(conv.shape[0], 3, p, p))
        sd["visual.class_embedding"] = half(v["class_embedding"])
        sd["visual.positional_embedding"] = half(v["positional_embedding"])
        ln("visual.ln_pre", v["ln_pre"])
        blocks("visual.transformer.resblocks", v["blocks"], cfg.clip.vision.layers)
        ln("visual.ln_post", v["ln_post"])
        sd["visual.proj"] = half(v["proj"])
    sd["token_embedding.weight"] = half(t["token_embedding"])
    sd["positional_embedding"] = half(t["positional_embedding"])
    blocks("transformer.resblocks", t["blocks"], cfg.clip.text.layers)
    ln("ln_final", t["ln_final"])
    sd["text_projection"] = half(t["text_projection"])
    sd["logit_scale"] = half(params["logit_scale"])
    sd.update(input_resolution=torch.tensor(cfg.clip.vision.image_size),
              context_length=torch.tensor(cfg.clip.text.context_length),
              vocab_size=torch.tensor(cfg.clip.text.vocab_size))
    return sd


def reference_adapters(trainable):
    """The PyTorch reference's text_adapter and image_adapter state dicts
    (without --relu) of a trainable dict: torch Linear weights (out, in)."""
    ta, ia = trainable["text_adapter"], trainable["image_adapter"]
    n = len(ta["layers"])
    text = {f"{i}.fc.0.weight": ta["layers"][i]["w"].T.contiguous() for i in range(n)}
    text[f"{n}.fc.0.weight"] = ta["proj"]["w"].T.contiguous()
    image = {f"layer_adapters.{i}.fc.0.weight": a["w"].T.contiguous()
             for i, a in enumerate(ia["layer_adapters"])}
    image.update({f"seg_proj.{i}.fc.weight": s["w"].T.contiguous()
                  for i, s in enumerate(ia["seg_proj"])})
    image["det_proj.fc.weight"] = ia["det_proj"]["w"].T.contiguous()
    return text, image


def same_trees(a, b):
    """Whether two trees of tensors hold the same names, dtypes and values."""
    import torch

    la, lb = dict(named_leaves(a)), dict(named_leaves(b))
    return la.keys() == lb.keys() and all(
        la[k].dtype == lb[k].dtype and torch.equal(la[k], lb[k].to(la[k].device)) for k in la)


def http_window(base, payloads, clients=SERVE_CLIENTS, requests=SERVE_REQUESTS):
    """POST the /v1/predict payloads from ``clients`` threads at once,
    ``requests`` each. Returns (wall seconds, latencies, replies)."""
    import json
    import urllib.request
    from concurrent.futures import ThreadPoolExecutor

    def client(k):
        out = []
        for i in range(k * requests, (k + 1) * requests):
            query, body, ctype = payloads[i]
            req = urllib.request.Request(f"{base}/v1/predict?{query}", data=body,
                                         headers={"Content-Type": ctype})
            t = time.perf_counter()
            with urllib.request.urlopen(req, timeout=SERVE_TIMEOUT) as r:
                out.append((i, time.perf_counter() - t, r.status, json.loads(r.read())))
        return out

    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=clients) as ex:
        done = [x for got in ex.map(client, range(clients), timeout=4 * SERVE_TIMEOUT)
                for x in got]
    wall = time.perf_counter() - t0
    done.sort(key=lambda x: x[0])
    return wall, [x[1] for x in done], [(x[2], x[3]) for x in done]


def phase_serve(card):
    """Serving from checkpoints at full ViT-L-14-336 width and depth: an
    OpenAI-layout fp16 .pt at its native 336 px grid, converted, cached and
    reloaded by AnomalyDetector.from_checkpoint at 518 px with adapters saved
    by the trainer's writer (and in the reference's .pth layout, imported);
    predict_paths; the HTTP server over the micro-batching service under 32
    concurrent clients; cli.single_image on both its routes."""
    import base64
    import io
    import json
    import tempfile
    import urllib.request

    import numpy as np
    import torch
    from PIL import Image
    from torch.profiler import ProfilerActivity, profile

    from aa_clip_iqm_tpu_torch import loader
    from aa_clip_iqm_tpu_torch.cli import single_image
    from aa_clip_iqm_tpu_torch.cli.serve import make_server, serve_forever_in_thread
    from aa_clip_iqm_tpu_torch.data.datasets import (
        _load_image,
        _load_image_u8,
        _use_native,
        normalize_clip,
    )
    from aa_clip_iqm_tpu_torch.evaluation.scoring import similarity_map_test
    from aa_clip_iqm_tpu_torch.models import adapters, clip
    from aa_clip_iqm_tpu_torch.models.convert import (
        import_reference_checkpoints,
        init_adapter_params_np,
        init_clip_params_np,
        params_from_jax,
        tree_map,
    )
    from aa_clip_iqm_tpu_torch.prompts import compute_class_anchor
    from aa_clip_iqm_tpu_torch.serving import AnomalyDetector, MicroBatchingService
    from aa_clip_iqm_tpu_torch.train import checkpoint as ckpt
    from aa_clip_iqm_tpu_torch.train.steps import make_stage1_visual_fn

    reset_counts()
    cfg = loader.build_model_config(SERVE_MODEL, img_size=IMG)
    native = loader.build_model_config(SERVE_MODEL, img_size=NATIVE_IMG)
    layers, text_layers = cfg.clip.vision.layers, cfg.clip.text.layers
    rng = np.random.default_rng(17)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_serve_") as root:
        # 1. The main path's seeded weights at the native grid, saved as
        # OpenAI's fp16 .pt; what the loader must give back: the same
        # weights rounded fp16 -> fp32 -> bf16, the positional embedding
        # resized from 24 x 24 to 37 x 37 patches.
        params = init_clip_params_np(native, seed=0)
        rows = params["visual"]["positional_embedding"].shape[0]
        require(rows == native.clip.vision.grid ** 2 + 1 != cfg.clip.vision.grid ** 2 + 1,
                f"the native grid's positional embedding has {rows} rows")
        pt = os.path.join(root, "ViT-L-14-336px.pt")
        t0 = time.perf_counter()
        torch.save(openai_state_dict(params, native), pt)
        log(f"# serve: OpenAI-layout fp16 .pt of {os.path.getsize(pt) / 1e9:.2f} GB written "
            f"in {time.perf_counter() - t0:.1f} s")
        rounded = tree_map(lambda x: np.asarray(x, np.float32).astype(np.float16)
                           .astype(np.float32), params)
        del params
        rounded["visual"]["positional_embedding"] = clip.resize_pos_embed_np(
            rounded["visual"]["positional_embedding"], cfg.clip.vision.grid)
        want, _ = params_from_jax(rounded, None, cfg, device=DEVICE, dtype=torch.bfloat16)
        del rounded

        # 2. Seeded adapters, saved by the trainer's writer and in the
        # reference's .pth layout; the import gives them back.
        _, seeded = params_from_jax(None, init_adapter_params_np(cfg, seed=5), cfg,
                                    device="cpu", dtype=torch.float32)
        # As a bf16 detector holds them: matrices in bf16, the rest float32.
        _, seeded_bf16 = params_from_jax(None, init_adapter_params_np(cfg, seed=5), cfg,
                                         device=DEVICE, dtype=torch.bfloat16)
        ck = os.path.join(root, "ckpt")
        ckpt.save_stage1(ck, 1, seeded["text_adapter"], None)
        ckpt.save_stage2(ck, 2, seeded, None)
        ref = os.path.join(root, "reference")
        os.makedirs(ref)
        text_sd, image_sd = reference_adapters(seeded)
        torch.save({"text_adapter": text_sd}, os.path.join(ref, "text_adapter.pth"))
        torch.save({"image_adapter": image_sd}, os.path.join(ref, "image_adapter_3.pth"))
        init = loader.init_trainable(cfg, device="cpu", dtype=torch.float32)
        imported = import_reference_checkpoints(ref, init)
        for key in init:
            source = seeded if key in ("text_adapter", "image_adapter") else init
            require(same_trees(imported[key], source[key]),
                    f"import_reference_checkpoints: {key} is not what was saved")

        # 3. Two loads: the first converts the .pt and writes <stem>.518.npz;
        # the second must read that cache (the converter fails meanwhile).
        cache = os.path.join(root, f"ViT-L-14-336px.{IMG}.npz")
        seconds, dets = [], []
        convert = loader.load_openai_checkpoint
        for attempt in range(2):
            if attempt:
                loader.load_openai_checkpoint = lambda *a, **k: require(
                    False, "the second load converted the .pt instead of reading its cache")
            try:
                t0 = time.perf_counter()
                dets.append(AnomalyDetector.from_checkpoint(
                    ck, "MVTec", img_size=IMG, backbone=pt, model_name=SERVE_MODEL,
                    compute_dtype=torch.bfloat16, device=DEVICE))
                torch.cuda.synchronize()
                seconds.append(time.perf_counter() - t0)
            finally:
                loader.load_openai_checkpoint = convert
            require(os.path.isfile(cache), f"no cache {cache} after a load")
        det, again = dets
        log(f"# serve: from_checkpoint at {IMG} px: {seconds[0]:.1f} s converting the .pt and "
            f"writing the cache ({os.path.getsize(cache) / 1e9:.2f} GB), {seconds[1]:.1f} s "
            f"from the cache, anchors of {len(det.class_names())} classes included, on {card}")
        require(same_trees(det.frozen, again.frozen), "the cached load differs from the converted one")
        require(same_trees(det.frozen, want),
                "the loaded backbone is not the seeded weights rounded fp16 -> fp32 -> bf16")
        require(same_trees(det.trainable, seeded_bf16),
                "the restored adapters are not the saved ones")
        require(all(torch.equal(det.anchors[c], again.anchors[c]) for c in det.class_names()),
                "the two loads' anchors differ")
        del again, dets, want, seeded_bf16
        torch.cuda.empty_cache()
        log(f"# serve: both loads hold the seeded backbone rounded fp16 -> fp32 -> bf16 (the "
            f"positional embedding resized from {rows} to {cfg.clip.vision.grid ** 2 + 1} rows) "
            "and the saved adapters, bit for bit; the reference .pth import gives back the "
            "seeded adapters bit for bit")

        # 4. predict_paths on 8 PNGs of assorted sizes, against predict on
        # their decoded uint8 arrays: the same call at the same bucket.
        paths = []
        for i in range(B):
            side = (IMG, 600, 448, 700)[i % 4]
            paths.append(os.path.join(root, f"img{i}.png"))
            Image.fromarray(rng.integers(0, 256, (side, side, 3), dtype=np.uint8)).save(paths[-1])
        maps_p, scores_p = det.predict_paths(paths, "bottle")
        maps_u, scores_u = det.predict(np.stack([_load_image_u8(p, IMG) for p in paths]),
                                       "bottle")
        require(maps_p.shape == (B, IMG, IMG) and np.isfinite(maps_p).all(),
                f"predict_paths: maps {maps_p.shape}, finite {np.isfinite(maps_p).all()}")
        require(np.array_equal(maps_p, maps_u) and np.array_equal(scores_p, scores_u),
                "predict_paths differs from predict on the same decoded images")
        log(f"# serve: predict_paths of {B} PNGs equals predict on their uint8 arrays bit for "
            f"bit (decoded with the {'native' if _use_native() else 'PIL'} transforms)")

        # 5. HTTP: 32 clients x 2 /v1/predict over 3 classes, half .npy and
        # half JSON with a base64 PNG (of another size: the server resizes),
        # then one /v1/predict_batch of 8; every map against predict_multi
        # on the same preprocessed images.
        n = SERVE_CLIENTS * SERVE_REQUESTS
        names = [SERVE_CLASSES[i % len(SERVE_CLASSES)] for i in range(n + B)]
        payloads, images, batch_entries = [], [], []
        for i in range(n + B):
            u8 = rng.integers(0, 256, (3, IMG, IMG), dtype=np.uint8)
            buf = io.BytesIO()
            if i % 2 == 0:
                image = normalize_clip(u8.astype(np.float32) / 255.0).astype(np.float32)
                np.save(buf, image)
                entry = {"npy_b64": base64.b64encode(buf.getvalue()).decode()}
                body, ctype = buf.getvalue(), "application/octet-stream"
            else:
                side = (600, 448)[i % 4 // 2]
                Image.fromarray(np.ascontiguousarray(u8.transpose(1, 2, 0))).resize(
                    (side, side)).save(buf, format="PNG")
                image = normalize_clip(_load_image(io.BytesIO(buf.getvalue()), IMG))
                entry = {"image_b64": base64.b64encode(buf.getvalue()).decode()}
                body = json.dumps({"class_name": names[i], **entry}).encode()
                ctype = "application/json"
            images.append(np.asarray(image, np.float32))
            if i < n:
                payloads.append((f"class_name={names[i]}&map=npy", body, ctype))
            else:
                batch_entries.append({"class_name": names[i], **entry})
        ref_maps, ref_scores = det.predict_multi(np.stack(images), names)

        def check(replies, offset, what):
            worst = score_diff = 0.0
            for j, (status, body) in enumerate(replies):
                require(status == 200, f"{what}: HTTP {status}")
                amap = np.load(io.BytesIO(base64.b64decode(body["map"]["b64"])),
                               allow_pickle=False)
                require(amap.shape == (IMG, IMG) and np.isfinite(amap).all(),
                        f"{what}: map {amap.shape}")
                worst = max(worst, map_diff(amap, ref_maps[offset + j]))
                score_diff = max(score_diff, abs(body["score"] - float(ref_scores[offset + j])))
            require(worst <= MAP_TOL, f"{what}: a map differs from predict_multi's by {worst}")
            return worst, score_diff

        # Every bucket the window may take, captured before it (float32: what
        # the service stacks), as the JAX server's --warmup compiles first.
        for bucket in det._buckets:
            det.predict(np.zeros((bucket, 3, IMG, IMG), np.float32), "bottle")
        log_graphs(det, "serve detector before the HTTP window")
        svc = MicroBatchingService(det, max_batch=32, max_latency_ms=5)
        server = make_server(svc, IMG, {"dataset": "MVTec", "classes": det.class_names()},
                             host="127.0.0.1", port=0, request_timeout=SERVE_TIMEOUT)
        thread = serve_forever_in_thread(server)
        try:
            base = "http://%s:%d" % server.server_address
            (wall, lat, replies), ran = graph_request(det, lambda: http_window(base, payloads))
            b1, b2 = ran["packed_attention"], ran["ln_mlp_residual"]
            worst, score_diff = check(replies, 0, "HTTP /v1/predict")
            require(b1 == b2 and b1 % layers == 0 and b1 > 0,
                    f"HTTP window: {b1} B1 and {b2} B2 launches, want equal multiples of {layers}")
            batches = max(b1 // layers, 1)
            p50, p99 = (float(np.percentile(lat, q)) * 1e3 for q in (50, 99))
            log(f"# serve: HTTP, {SERVE_CLIENTS} clients x {SERVE_REQUESTS} requests at {IMG} px: "
                f"{n / wall:.2f} requests/s, p50 {p50:.1f} ms, p99 {p99:.1f} ms, {batches} device "
                f"batches ({b1} B1 launches in graph replays / {layers}), mean size "
                f"{n / batches:.2f}, on {card}")
            log(f"# serve: HTTP maps against predict_multi: worst rms diff / std {worst:.3e} "
                f"(tol {MAP_TOL:.0e}), largest score difference {score_diff:.3e}")
            # The same window with the detector's eager program, for a paired
            # reading of what the graphs change end to end.
            with _Eager():
                wall_e, lat_e, replies_e = http_window(base, payloads)
            check(replies_e, 0, "HTTP /v1/predict, eager")
            log(f"# serve: the same window on the eager program: {n / wall_e:.2f} requests/s, "
                f"p50 {np.percentile(lat_e, 50) * 1e3:.1f} ms, p99 "
                f"{np.percentile(lat_e, 99) * 1e3:.1f} ms, on {card}")
            req = urllib.request.Request(f"{base}/v1/predict_batch?map=npy",
                                         data=json.dumps({"requests": batch_entries}).encode(),
                                         headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=SERVE_TIMEOUT) as r:
                results = json.loads(r.read())["results"]
            require(len(results) == B, f"predict_batch: {len(results)} results")
            worst_b, diff_b = check([(200, res) for res in results], n, "HTTP /v1/predict_batch")
            log(f"# serve: /v1/predict_batch of {B}: worst rms diff / std {worst_b:.3e}, "
                f"largest score difference {diff_b:.3e}")
            # The same traffic again under the profiler, for the device's
            # idle share of the window.
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                wall_p, _, replies_p = http_window(base, payloads)
                torch.cuda.synchronize()
            check(replies_p, 0, "HTTP /v1/predict under the profiler")
            busy = sum(e.self_device_time_total for e in prof.key_averages()
                       if e.device_type == torch.autograd.DeviceType.CUDA) / 1e6
            require(busy > 0, "the profiler saw no device time in the HTTP window")
            log(f"# serve: the same window under the profiler: wall {wall_p:.2f} s, device busy "
                f"{busy:.2f} s, idle share {1 - busy / wall_p:.3f}, on {card}")
        finally:
            server.shutdown()
            server.server_close()
            svc.close()
            thread.join(timeout=SERVE_TIMEOUT)

        # 6. cli.single_image in this process, zero-shot and from the
        # checkpoint, against the same computation done directly.
        path = paths[1]
        image = torch.from_numpy(np.asarray(normalize_clip(_load_image(path, IMG))[None],
                                            np.float32)).to(DEVICE)
        vv_from = clip.surgery_vv_from(layers, cfg.surgery_until_layer)
        with torch.inference_mode():
            anchor = compute_class_anchor(
                lambda tok: adapters.encode_text_frozen(det.frozen, cfg, tok,
                                                        compute_dtype=torch.bfloat16),
                "MVTec", "bottle", device=DEVICE)
            feats = make_stage1_visual_fn(cfg, compute_dtype=torch.bfloat16)(det.frozen, image)
            direct_zs = sum(similarity_map_test(f, anchor[None], IMG, "Industrial")
                            for f in feats)[0].float().cpu().numpy()
        direct_ck = det.predict(image.cpu().numpy(), "bottle")[0][0]
        for route, extra, direct, want_b1 in (
                ("zero-shot", [], direct_zs, vv_from + 2 * (layers - vv_from)),
                ("checkpoint", ["--save_path", ck], direct_ck, layers)):
            out = os.path.join(root, f"single_{route}.png")
            before = read_counts()
            t0 = time.perf_counter()
            amap, score = single_image.main(
                ["--model_name", SERVE_MODEL, "--img_size", str(IMG), "--image_path", path,
                 "--class_name", "bottle", "--dataset", "MVTec", "--backbone", pt,
                 "--device", DEVICE, "--out", out] + extra)
            seconds = time.perf_counter() - t0
            got = diff_counts(read_counts(), before)
            saved = np.load(os.path.splitext(out)[0] + ".npy")
            rel = map_diff(saved, direct)
            log(f"# serve: cli.single_image {route}: score {score:.4f}, map against the direct "
                f"computation rms diff / std {rel:.3e} (tol {MAP_TOL:.0e}), {seconds:.1f} s, "
                f"launches B1 {got['packed_attention']} B2 {got['ln_mlp_residual']}, on {card}")
            require(saved.shape == (IMG, IMG) and np.isfinite(saved).all()
                    and np.array_equal(saved, amap), f"single_image {route}: saved map")
            require(rel <= MAP_TOL, f"single_image {route}: map differs by {rel}")
            require(got == counts_of(packed_attention=want_b1,
                                     ln_mlp_residual=want_b1 + 2 * text_layers),
                    f"single_image {route}: launches {got}")
    counts = read_counts()
    del det
    torch.cuda.empty_cache()
    return counts


class _NoCopy:
    """Stands in for a graph's input buffer so that a request's copy-in is
    skipped: the replay then reads the previous request's images."""

    def copy_(self, src):
        return self


def request(det, imgs, names):
    """One request: predict for a single class, predict_multi for several."""
    if len(set(names)) == 1:
        return det.predict(imgs, names[0])
    return det.predict_multi(imgs, names)


def graph_vs_eager(det, imgs, names, what, tol):
    """A request as a graph replay against the same request through the
    detector's eager program (``det._predict`` on the same padded input).
    Returns the replay's maps and launches."""
    import numpy as np

    (maps_g, scores_g), ran = graph_request(det, lambda: request(det, imgs, names))
    with _Eager():
        maps_e, scores_e = request(det, imgs, names)
    rel = map_diff(maps_g, maps_e)
    same = np.array_equal(maps_g, maps_e) and np.array_equal(scores_g, scores_e)
    log(f"# deploy, {what}: graph replay vs eager, map rms diff / std {rel:.3e} (tol "
        f"{tol:.0e}), bit for bit {same}; launches per replay "
        f"{ {k: v for k, v in ran.items() if v} }")
    require(np.isfinite(maps_g).all() and maps_g.shape == (len(imgs),) + imgs.shape[-2:],
            f"deploy, {what}: maps {maps_g.shape}")
    require(rel <= tol, f"deploy, {what}: the graph's map differs from eager by {rel}")
    return maps_g, ran


def exported_child(artifact, inputs, out):
    """Run in a fresh python3: load an exported artifact through
    ExportedPredictor, predict the saved inputs (a mixed-class batch, and
    its first image alone), save the outputs and print the aaclip:: kernel
    launches they took as one JSON line."""
    import numpy as np

    sys.path.insert(0, ROOT)
    from aa_clip_iqm_tpu_torch.serving import ExportedPredictor

    data = np.load(inputs)
    images, names = data["images"], [str(c) for c in data["names"]]
    t0 = time.perf_counter()
    pred = ExportedPredictor(artifact)
    load_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    pred._program(len(images))
    program_s = time.perf_counter() - t0
    before = read_counts()
    t0 = time.perf_counter()
    maps, scores = pred.predict_multi(images, names)
    first_s = time.perf_counter() - t0
    maps1, scores1 = pred.predict(images[:1], names[0])
    after = read_counts()
    lat = []
    for _ in range(5):
        t0 = time.perf_counter()
        pred.predict_multi(images, names)
        lat.append(time.perf_counter() - t0)
    # One call under the profiler: the device time of each kernel group.
    import torch
    from torch.profiler import ProfilerActivity, profile

    from aa_clip_iqm_tpu_torch.tools.trace_summary import kernel_group

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pred.predict_multi(images, names)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    groups = {}
    for evt in prof.key_averages():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            group = kernel_group(evt.key)
            groups[group] = groups.get(group, 0.0) + evt.self_device_time_total / 1e3
    np.savez(out, maps=maps, scores=scores, maps1=maps1, scores1=scores1)
    print(json.dumps({"launches": {k: after[k] - before[k] for k in after},
                      "load_s": load_s, "program_s": program_s, "first_s": first_s,
                      "p50_s": float(np.median(lat)), "wall_ms": wall_ms,
                      "groups_ms": groups}), flush=True)
    return 0


def phase_deploy(card, ctx):
    """Deploying the port: per-bucket CUDA graphs against the eager program
    (518 px at batch 1, 8 and a mixed-class 5, the fused attention half at
    batch 8, 1274 px at batch 2, each int8 tier at batch 8), with a planted
    fault (a replay whose copy-in is skipped); graph and eager timed and
    profiled at batch 1 and 8; the bf16 program exported at buckets (1, 8)
    and the int8 tier's at (8), each artifact loaded in a fresh python3
    through ExportedPredictor and held to the detector (a planted fault: two
    classes' anchors swapped); a short HTTP window of cli.serve --exported."""
    import tempfile
    import urllib.request

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from aa_clip_iqm_tpu_torch.cli import serve as serve_cli
    from aa_clip_iqm_tpu_torch.data.datasets import normalize_clip
    from aa_clip_iqm_tpu_torch.models import clip
    from aa_clip_iqm_tpu_torch.serving import (AnomalyDetector, MicroBatchingService,
                                               export_predictor)

    t_phase = time.perf_counter()
    cfg = ctx["cfg"]
    layers = cfg.clip.vision.layers
    rng = np.random.default_rng(41)

    def u8(n):
        return rng.integers(0, 256, (n, 3, IMG, IMG), dtype=np.uint8)

    reset_counts()
    det = AnomalyDetector(ctx["frozen"], ctx["trainable"], cfg, "MVTec", img_size=IMG,
                          compute_dtype=torch.bfloat16, device="cuda")
    classes = det.class_names()
    imgs8 = u8(B)

    # 1. Graph replays against the eager program.
    per_replay = {}
    graph_vs_eager(det, u8(1), ["bottle"], "518 px batch 1", MAP_TOL)
    _, per_replay["bf16"] = graph_vs_eager(det, imgs8, ["screw"] * B, "518 px batch 8",
                                           MAP_TOL)
    graph_vs_eager(det, u8(5), [classes[i % 3] for i in range(5)],
                   "518 px mixed-class batch 5 (bucket 8)", MAP_TOL)
    clip.FUSED_ATTN = True
    try:
        _, per_replay["fused"] = graph_vs_eager(det, imgs8, ["screw"] * B,
                                                "518 px batch 8, AACLIP_FUSED_ATTN=1", MAP_TOL)
    finally:
        clip.FUSED_ATTN = False
    _, per_replay["1274px"] = graph_vs_eager(ctx["det_hr"], ctx["imgs_hr"], ["screw"] * 2,
                                             "1274 px batch 2", MAP_TOL)
    for tier, tdet in ctx["det_tiers"].items():
        _, per_replay[tier] = graph_vs_eager(tdet, imgs8, ["screw"] * B,
                                             f"tier {tier} batch 8", INT8_MAP_TOL)
    want = {"bf16": counts_of(packed_attention=layers, ln_mlp_residual=layers),
            "fused": counts_of(ln_attn_residual=layers, ln_mlp_residual=layers),
            "1274px": counts_of(flash_attention=layers, ln_mlp_residual=layers),
            "int8": counts_of(packed_attention=layers, ln_mlp_residual_int8=layers),
            "int8_attn": counts_of(packed_attention=layers, ln_mlp_residual=layers),
            "int8_mlp": counts_of(packed_attention=layers, ln_mlp_residual_int8=layers)}
    for key, got in per_replay.items():
        require(got == want[key], f"deploy, {key}: launches per replay {got}, want {want[key]}")

    # The planted fault: the batch-8 graph replayed on the previous
    # request's images.
    graph = det._graphs[(B, torch.uint8, False)]
    other = u8(B)
    det.predict(imgs8, "screw")
    real, graph.images = graph.images, _NoCopy()
    try:
        stale, _ = det.predict(other, "screw")
    finally:
        graph.images = real
    with _Eager():
        fresh, _ = det.predict(other, "screw")
    rel_f = map_diff(stale, fresh)
    log(f"# planted fault, a replay with its copy-in skipped (the previous request's images), "
        f"batch 8 map: rms diff / std {rel_f:.3e}")
    require(rel_f > MAP_TOL, "the graph comparison missed a replay on stale inputs")

    # Graph against eager: images/s, p50 and the idle share at batch 1 and 8.
    for n in (1, B):
        imgs = u8(n)
        time_requests(det, imgs, card, f"deploy, graph replay")
        profile_request(det, imgs)
        with _Eager():
            time_requests(det, imgs, card, f"deploy, eager")
            profile_request(det, imgs)
    for what, d in (("518 px bf16", det), ("1274 px", ctx["det_hr"]),
                    *((f"tier {t}", d) for t, d in ctx["det_tiers"].items())):
        log_graphs(d, what)
    log(f"# graphs: device memory reserved now {torch.cuda.memory_reserved() / 1e9:.2f} GB, "
        f"allocated {torch.cuda.memory_allocated() / 1e9:.2f} GB")
    counts = read_counts()

    # 2. Export, and a fresh process per artifact.
    with tempfile.TemporaryDirectory(prefix="chip_smoke_deploy_") as root:
        dirs = {"bf16": os.path.join(root, "bf16"), "int8": os.path.join(root, "int8")}
        for key, d, buckets in (("bf16", det, (1, B)), ("int8", ctx["det_tiers"]["int8"], (B,))):
            t0 = time.perf_counter()
            seconds = export_predictor(d, dirs[key], batch_sizes=buckets)
            size = sum(os.path.getsize(os.path.join(dirs[key], f))
                       for f in os.listdir(dirs[key]))
            log(f"# export, {key}: buckets {list(buckets)} in {time.perf_counter() - t0:.1f} s ("
                + ", ".join(f"b{b} {t:.1f} s" for b, t in seconds.items())
                + f", weights included), {size / 1e9:.2f} GB of artifacts")
        # The planted fault: the bf16 artifact with two classes' anchors
        # swapped.
        dirs["swapped"] = os.path.join(root, "swapped")
        os.makedirs(dirs["swapped"])
        for f in os.listdir(dirs["bf16"]):
            if f != "anchors.npz":
                os.symlink(os.path.join(dirs["bf16"], f), os.path.join(dirs["swapped"], f))
        anchors = dict(np.load(os.path.join(dirs["bf16"], "anchors.npz")))
        anchors["screw"], anchors["bottle"] = anchors["bottle"], anchors["screw"]
        np.savez(os.path.join(dirs["swapped"], "anchors.npz"), **anchors)

        names = [("screw", "bottle", "carpet")[i % 3] for i in range(B)]
        images = normalize_clip(u8(B).astype(np.float32) / 255.0).astype(np.float32)
        inputs = os.path.join(root, "inputs.npz")
        np.savez(inputs, images=images, names=np.array(names))
        ref = {"bf16": det.predict_multi(images, names),
               "int8": ctx["det_tiers"]["int8"].predict_multi(images, names)}
        ref1 = {"bf16": det.predict(images[:1], names[0]),
                "int8": ctx["det_tiers"]["int8"].predict(images[:1], names[0])}
        # One child at a time, so that each one's times are its own.
        for key, d in dirs.items():
            out = os.path.join(root, f"out_{key}.npz")
            proc = subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--exported-child", d, inputs, out],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=ROOT)
            try:
                stdout, stderr = proc.communicate(timeout=SERVE_TIMEOUT)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.communicate()
                raise Failure(f"the exported {key} child did not finish in {SERVE_TIMEOUT} s")
            require(proc.returncode == 0, f"the exported {key} child failed:\n{stderr[-3000:]}")
            report = json.loads(stdout.strip().splitlines()[-1])
            got = np.load(out)
            base = "bf16" if key == "swapped" else key
            tol = INT8_MAP_TOL if key == "int8" else MAP_TOL
            rel = map_diff(got["maps"], ref[base][0])
            rel1 = map_diff(got["maps1"], ref1[base][0])
            score_diff = float(np.abs(got["scores"] - ref[base][1]).max())
            log(f"# export, {key} artifact in a fresh python3: manifest, anchors and weights "
                f"loaded in {report['load_s']:.1f} s, the batch-8 program in "
                f"{report['program_s']:.1f} s, its first call {report['first_s']:.2f} s, then "
                f"p50 {report['p50_s'] * 1e3:.1f} ms ({B / report['p50_s']:.2f} images/s, "
                f"eager, no graph); vs the detector, batch-8 "
                f"mixed-class map rms diff / std {rel:.3e}, batch-1 {rel1:.3e} (tol {tol:.0e}), "
                f"largest score difference {score_diff:.3e}; aaclip:: launches "
                f"{ {k: v for k, v in report['launches'].items() if v} }")
            groups, busy = report["groups_ms"], sum(report["groups_ms"].values())
            log(f"# export, {key} artifact, one batch-8 call under the profiler: wall "
                f"{report['wall_ms']:.1f} ms, device busy {busy:.1f} ms, idle share "
                f"{1 - busy / report['wall_ms']:.3f}; per launch "
                + ", ".join(f"{g.split()[0]} {ms / layers:.3f} ms" for g, ms in sorted(groups.items())
                            if g.startswith("B"))
                + "; by group " + ", ".join(f"{g} {ms:.2f} ms" for g, ms in sorted(
                    groups.items(), key=lambda kv: -kv[1])))
            b3 = key == "int8"
            require(report["launches"] == counts_of(
                packed_attention=2 * layers, ln_mlp_residual=0 if b3 else 2 * layers,
                ln_mlp_residual_int8=2 * layers if b3 else 0),
                f"exported {key}: the CUDA kernels were not all launched")
            if key == "swapped":
                require(rel > tol, "the export comparison missed the swapped anchors")
            else:
                require(rel <= tol and rel1 <= tol, f"exported {key}: maps differ by {rel}, {rel1}")

        # 3. cli.serve --exported: 8 clients x 2 requests, every map against
        # the detector's predict_multi on the same images.
        args = serve_cli.build_parser().parse_args(["--exported", dirs["bf16"]])
        exported, meta, img_size = serve_cli.load_model(args)
        require(meta["source"] == "exported" and meta["dataset"] == "MVTec" and img_size == IMG,
                f"cli.serve --exported: {meta}")
        clients, requests = 8, 2
        n = clients * requests
        imgs = normalize_clip(u8(n).astype(np.float32) / 255.0).astype(np.float32)
        names = [("bottle", "screw", "carpet")[i % 3] for i in range(n)]
        payloads = []
        for i in range(n):
            buf = io.BytesIO()
            np.save(buf, imgs[i])
            payloads.append((f"class_name={names[i]}&map=npy", buf.getvalue(),
                             "application/octet-stream"))
        ref_maps, _ = det.predict_multi(imgs, names)
        svc = MicroBatchingService(exported, max_batch=args.max_batch,
                                   max_latency_ms=args.max_latency_ms)
        server = serve_cli.make_server(svc, img_size, meta, host="127.0.0.1", port=0,
                                       request_timeout=SERVE_TIMEOUT)
        thread = serve_cli.serve_forever_in_thread(server)
        try:
            base = "http://%s:%d" % server.server_address
            with urllib.request.urlopen(f"{base}/v1/health", timeout=SERVE_TIMEOUT) as r:
                health = json.loads(r.read())
            require(health["source"] == "exported", f"/v1/health: {health}")
            # Every bucket's program loaded and called once before the
            # window, as the JAX server's --warmup compiles first.
            t0 = time.perf_counter()
            for bucket in meta["batch_sizes"]:
                exported.predict(imgs[:bucket], names[0])
            log(f"# deploy: cli.serve --exported, the buckets' programs {meta['batch_sizes']} "
                f"loaded and called once in {time.perf_counter() - t0:.1f} s")
            results = []
            for profiled in (False, True):
                if profiled:
                    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                        wall, lat, replies = http_window(base, payloads, clients, requests)
                        torch.cuda.synchronize()
                else:
                    wall, lat, replies = http_window(base, payloads, clients, requests)
                worst = 0.0
                for j, (status, body) in enumerate(replies):
                    require(status == 200, f"cli.serve --exported: HTTP {status}")
                    amap = np.load(io.BytesIO(base64.b64decode(body["map"]["b64"])),
                                   allow_pickle=False)
                    worst = max(worst, map_diff(amap, ref_maps[j]))
                require(worst <= MAP_TOL, f"cli.serve --exported: a map differs by {worst}")
                results.append((wall, lat, worst))
            busy = sum(e.self_device_time_total for e in prof.key_averages()
                       if e.device_type == torch.autograd.DeviceType.CUDA) / 1e6
            require(busy > 0, "the profiler saw no device time in the exported HTTP window")
            wall, lat, worst = results[0]
            p50, p99 = (float(np.percentile(lat, q)) * 1e3 for q in (50, 99))
            log(f"# deploy: cli.serve --exported, {clients} clients x {requests} requests at "
                f"{IMG} px: {n / wall:.2f} requests/s, p50 {p50:.1f} ms, p99 {p99:.1f} ms; "
                f"maps against predict_multi worst rms diff / std {worst:.3e} (tol {MAP_TOL:.0e}); "
                f"under the profiler wall {results[1][0]:.2f} s, device busy {busy:.2f} s, idle "
                f"share {1 - busy / results[1][0]:.3f}, on {card}")
        finally:
            server.shutdown()
            server.server_close()
            svc.close()
            thread.join(timeout=SERVE_TIMEOUT)
        del exported
    del det
    ctx.pop("det_hr")
    ctx.pop("det_tiers")
    ctx.pop("det_int8")
    torch.cuda.empty_cache()
    log(f"# deploy phase: {time.perf_counter() - t_phase:.1f} s")
    return counts


def phase_tools(card, ctx):
    """The measuring and inspecting entry points on the main path's ViT-L
    weights: the bench's latency mode at batch 1 and 8 on the detector's
    graphs (24 B1 + 24 B2 a replay), its eval mode (one timed sweep), the
    batch x route grid at batch 8 (the stock PyTorch route against the
    kernels: its map within MAP_TOL, no kernel counter moved), a profile of
    an inference block read by the port's trace_summary --device (and an
    empty directory, which must fail it), a train block at --accum 2, and
    NaN checks on a stage-2 step (a NaN pixel must raise
    FloatingPointError, the clean batch must pass, and a detector under the
    checks runs eagerly)."""
    import tempfile

    import numpy as np
    import torch

    from aa_clip_iqm_tpu_torch.cli import bench
    from aa_clip_iqm_tpu_torch.configs import TrainConfig
    from aa_clip_iqm_tpu_torch.data.datasets import _use_native
    from aa_clip_iqm_tpu_torch.evaluation.predict import make_predict_fn
    from aa_clip_iqm_tpu_torch.loader import init_trainable
    from aa_clip_iqm_tpu_torch.models import clip as clip_mod
    from aa_clip_iqm_tpu_torch.serving import AnomalyDetector
    from aa_clip_iqm_tpu_torch.tools import trace_summary
    from aa_clip_iqm_tpu_torch.train import optim, steps
    from aa_clip_iqm_tpu_torch.utils import profiling

    t_phase = time.perf_counter()
    cfg, frozen, trainable = ctx["cfg"], ctx["frozen"], ctx["trainable"]
    layers = cfg.clip.vision.layers
    per_forward = counts_of(packed_attention=layers, ln_mlp_residual=layers)
    total = counts_of()
    rng = np.random.default_rng(11)

    # Latency: the bench's measure_latency on a detector of buckets 1 and 8.
    reset_counts()
    det = AnomalyDetector(frozen, trainable, cfg, "MVTec", img_size=IMG, adapted_text=False,
                          batch_buckets=(1, B), compute_dtype=torch.bfloat16, device=DEVICE)
    for b in (1, B):
        images = [rng.standard_normal((b, 3, IMG, IMG)).astype(np.float32) for _ in range(4)]
        lat, ran = graph_request(det, lambda: bench.measure_latency(det, images, "screw"))
        per = replay_launches(det, (b, torch.float32, clip_mod.FUSED_ATTN))
        require(per == per_forward, f"latency b{b}: a replay launched {per}, want {per_forward}")
        replays = ran["packed_attention"] // layers
        require(replays == bench.LATENCY_CALLS + 1, f"latency b{b}: {replays} replays")
        p50, p95 = float(np.percentile(lat, 50)), float(np.percentile(lat, 95))
        require(np.isfinite(lat).all() and p50 > 0, f"latency b{b}: {lat}")
        log(f"# tools, bench latency b{b}: p50 {p50:.2f} ms, p95 {p95:.2f} ms, min "
            f"{min(lat):.2f}, max {max(lat):.2f} ({len(lat)} float32 requests, each a graph "
            f"replay of 24 B1 + 24 B2 with the host copies) on {card}")
    # NaN checks on: the same detector runs its eager program, no replay.
    before = {k: g.replays for k, g in det._graphs.items()}
    profiling.enable_nan_checks(True)
    try:
        maps, _ = det.predict(images[0][:1], "screw")
    finally:
        profiling.enable_nan_checks(False)
    require({k: g.replays for k, g in det._graphs.items()} == before,
            "a detector under NaN checks replayed a graph")
    require(np.isfinite(maps).all(), "a detector under NaN checks: non-finite map")
    add_counts(total, read_counts())
    del det

    # Eval: the bench's sweep (anchors + evaluate_dataset over PNGs on disk).
    reset_counts()
    samples, rows, n = bench.eval_sweeps(frozen, trainable, cfg, IMG, 16, 1)
    got = read_counts()
    add_counts(total, got)
    vals = [r[k] / 100 for r in rows for k in ("pixel AUC", "pixel AP", "image AUC",
                                                "image AP")]
    require(np.isfinite(vals).all() and min(vals) >= 0 and max(vals) <= 1,
            f"eval sweep metrics {rows}")
    log(f"# tools, bench eval: {n} images a sweep, {samples[0]:.2f} images/s end to end "
        f"(anchors, PNG decode with the {'native' if _use_native() else 'PIL'} transforms, "
        f"predict on graphs, device metrics), Average pixel AUC "
        f"{rows[-1]['pixel AUC']:.2f}, launches {got} on {card}")

    # The batch x route grid at batch 8: the stock PyTorch route moves no
    # kernel counter, and its map lies within MAP_TOL of the kernels'.
    imgs = torch.from_numpy(rng.integers(0, 256, (B, 3, IMG, IMG),
                                         dtype=np.uint8)).to(DEVICE)
    anchors = torch.from_numpy(rng.standard_normal((B, cfg.clip.embed_dim, 2))
                               .astype(np.float32)).to(DEVICE)
    anchors = anchors / anchors.norm(dim=1, keepdim=True)
    speed, maps = {}, {}
    for use_pallas in (False, True):
        predict = make_predict_fn(cfg, IMG, "Industrial", compute_dtype=torch.bfloat16,
                                  use_pallas=use_pallas)
        reset_counts()
        samples = bench._measure(predict, frozen, trainable, B, IMG, cfg.clip.embed_dim,
                                 iters=5, repeats=3)
        maps[use_pallas] = predict(frozen, trainable, imgs, anchors)[0].cpu().numpy()
        got = read_counts()
        calls = 1 + 5 * 3 + 1
        want = counts_of() if not use_pallas else counts_of(
            packed_attention=layers * calls, ln_mlp_residual=layers * calls)
        require(got == want, f"grid, use_pallas={use_pallas}: launches {got}, want {want}")
        add_counts(total, got)
        speed[use_pallas] = bench._median_spread(samples)
    rel = map_diff(maps[False], maps[True])
    log(f"# tools, bench grid at batch {B}: kernels {speed[True][0]:.2f} images/s (spread "
        f"{speed[True][1]:.1f}%), library route (SDPA + cuBLAS, no kernel launched) "
        f"{speed[False][0]:.2f} (spread {speed[False][1]:.1f}%), ratio "
        f"{speed[True][0] / speed[False][0]:.3f}; library map against the kernels' rms "
        f"diff / std {rel:.3e} (tol {MAP_TOL:.0e}) on {card}")
    require(rel <= MAP_TOL, f"the library route's map differs from the kernels' by {rel}")

    # Profile: --profile_dir around an inference block, read back by the
    # port's trace summary; a directory without a trace must fail it.
    predict = make_predict_fn(cfg, IMG, "Industrial", compute_dtype=torch.bfloat16)
    with tempfile.TemporaryDirectory() as prof_dir:
        empty = os.path.join(prof_dir, "empty")
        os.makedirs(empty)
        try:
            trace_summary.main([empty, "--device"])
            failed = False
        except SystemExit as exc:
            failed = exc.code not in (None, 0)
        require(failed, "trace_summary --device passed a directory without a trace")
        for attempt in range(3):
            run_dir = os.path.join(prof_dir, f"run{attempt}")
            bench._measure(predict, frozen, trainable, B, IMG, cfg.clip.embed_dim,
                           iters=2, repeats=1, profile_dir=run_dir)
            groups = trace_summary.device_summary(
                trace_summary.load_events(trace_summary.find_trace(run_dir)))
            # Each device kernel of the group (B2: its LayerNorm pass and
            # two GEMMs) once a block a call.
            got = {g: sorted({n for n, _ in groups.get(g, {"kernels": {}})["kernels"].values()})
                   for g in ("B1 packed_attention", "B2 ln_mlp_residual")}
            if got == dict.fromkeys(got, [2 * layers]):
                break
            log(f"# tools, profile measurement {attempt + 1}: the groups' kernels ran {got} "
                "times")
        require(got == dict.fromkeys(got, [2 * layers]),
                f"profile: the groups' kernels ran {got} times, want {2 * layers} each")
        require(trace_summary.main([run_dir, "--device", "--top", "4"]) == 0,
                "trace_summary --device failed")
        busy = sum(g["ms"] for g in groups.values())
        log(f"# tools, profile of 2 batch-{B} predict calls (trace_summary --device): busy "
            f"{busy / 2:.2f} ms a call; " + "; ".join(
                f"{name} {g['ms'] / 2:.2f} ms a call ({g['launches']} kernel events, "
                f"{len(g['kernels'])} kernels)"
                for name, g in sorted(groups.items(), key=lambda kv: -kv[1]["ms"])))

    # A train block at --accum 2: finite losses.
    reset_counts()
    samples, losses = bench._measure_train("train", cfg, frozen, B, IMG, None, iters=2,
                                           repeats=1, accum=2)
    got = read_counts()
    add_counts(total, got)
    losses = [float(v) for v in losses]
    require(np.isfinite(losses).all(), f"accum 2: losses {losses}")
    log(f"# tools, bench train --accum 2 at batch {B}: {samples[0]:.2f} images/s, losses "
        f"{np.round(losses, 4).tolist()}, launches {got} on {card}")

    # NaN checks: one NaN pixel must raise FloatingPointError in a stage-2
    # step; the same step on the clean batch must pass.
    tr = init_trainable(cfg, seed=5, device=DEVICE, dtype=torch.float32, requires_grad=True)
    train_cfg = TrainConfig(img_size=IMG, compute_dtype="bfloat16")
    step = steps.make_stage2_step(cfg, train_cfg, compute_dtype=torch.bfloat16)
    opt = optim.stage2_optimizer(tr, train_cfg.image_lr, 10)
    images = torch.from_numpy(rng.standard_normal((2, 3, IMG, IMG))
                              .astype(np.float32)).to(DEVICE)
    masks = (torch.rand(2, 1, IMG, IMG, device=DEVICE) > 0.9).float()
    labels = torch.tensor([0, 1], device=DEVICE)
    weights = torch.ones(2, device=DEVICE)
    anchors2 = anchors[:2].contiguous()
    planted = images.clone()
    planted[1, 0, IMG // 2, IMG // 3] = float("nan")
    reset_counts()
    step(tr, opt, frozen, images, masks, labels, anchors2, weights)   # without checks
    raised = None
    t0 = time.perf_counter()
    profiling.enable_nan_checks(True)
    try:
        loss = step(tr, opt, frozen, images, masks, labels, anchors2, weights)[-1]
        clean_s = time.perf_counter() - t0
        try:
            step(tr, opt, frozen, planted, masks, labels, anchors2, weights)
        except FloatingPointError as exc:
            raised = str(exc)
    finally:
        profiling.enable_nan_checks(False)
    add_counts(total, read_counts())
    require(torch.isfinite(loss).item(), f"NaN checks: the clean step's loss {loss}")
    require(raised is not None, "NaN checks: a NaN pixel did not raise FloatingPointError")
    log(f"# tools, NaN checks: the clean stage-2 step (batch 2) passed in {clean_s:.1f} s "
        f"under the checks; the planted NaN raised: {raised}")
    del tr, opt
    torch.cuda.empty_cache()
    log(f"# tools phase: {time.perf_counter() - t_phase:.1f} s, launches {total}")
    return total


def phase_repo_tools(card):
    """The port's counterparts of the repository's root tools, on the card:
    int8_outlier_study --size flagship with its defaults (factors 1, 20,
    100; 8 images; the six tiers), every row landed (none failed or
    skipped), B3 counted; parity_run --random_backbone on a synthetic
    dataset at 518 px on ViT-L in bf16 (the default anchor table, which has
    no row for it: exit 0), against a table shifted past the budget (exit
    1) and with --quantize_backbone int8 (exit 0), its reports written; the
    three probes at their shapes (probe_mlp_int8_sweep: every B9 variant
    lands; probe_mlp_int8; probe_attn_fused), each chain timed as a CUDA
    graph, each probe's error within its limit (SWEEP_TOL, PROBE_MLP_TOL,
    PROBE_ATTN_TOL), and one layer of each chain of the last two held to its
    plain version at the probe's shape (B9 is held at the sweep's in the
    kernels phase)."""
    import contextlib
    import tempfile

    import numpy as np
    import torch

    from aa_clip_iqm_tpu_torch.data.synthetic import generate, register_synthetic
    from aa_clip_iqm_tpu_torch.ops import attn_block as ab
    from aa_clip_iqm_tpu_torch.ops import fused_mlp
    from aa_clip_iqm_tpu_torch.ops import packed_attention as pa
    from aa_clip_iqm_tpu_torch.ops.layers import gelu, layer_norm, linear
    from aa_clip_iqm_tpu_torch.tools import (
        int8_outlier_study,
        parity_run,
        probe_attn_fused,
        probe_mlp_int8,
        probe_mlp_int8_sweep,
    )

    t_phase = time.perf_counter()
    total = counts_of()

    def window(what):
        """Counts set to 0 before the tool and read after it."""
        @contextlib.contextmanager
        def run():
            reset_counts()
            t0 = time.perf_counter()
            yield
            torch.cuda.synchronize()
            got = read_counts()
            add_counts(total, got)
            log(f"# repo tools, {what}: {time.perf_counter() - t0:.1f} s, launches "
                f"{ {k: v for k, v in got.items() if v} }")
        return run()

    with window("int8_outlier_study --size flagship"):
        rows = int8_outlier_study.run_study(size="flagship", device=DEVICE,
                                            out=lambda line: log(f"#   {line}"))
        got = read_counts()
    bad = [r for r in rows if "error" in r]
    require(not bad, f"int8_outlier_study: rows that did not land: {bad}")
    require(len(rows) == 18, f"int8_outlier_study: {len(rows)} rows, want 3 factors x 6 tiers")
    require(all(np.isfinite(r["rho"]) and np.isfinite(r["dauroc_pts"]) for r in rows),
            "int8_outlier_study: a row is not finite")
    require(got["ln_mlp_residual_int8"] > 0, "int8_outlier_study launched no B3")

    with tempfile.TemporaryDirectory() as root:
        generate(root, n_normal=4, n_anomalous=4, size=IMG, seed=7, class_names=("widget",))
        meta = register_synthetic(root)
        base = ["--model_name", "ViT-L-14-336", "--img_size", str(IMG), "--random_backbone",
                "--datasets", "Synth", "--metadata_root", meta, "--image_batch_size", str(B),
                "--compute_dtype", "bfloat16", "--device", DEVICE]

        def report(out):
            for name in ("report.json", "report.md", "Synth.txt", "Synth.json"):
                require(os.path.isfile(os.path.join(out, name)), f"parity_run wrote no {name}")
            with open(os.path.join(out, "report.json")) as f:
                return json.load(f)

        out1 = os.path.join(root, "rep1")
        with window("parity_run --random_backbone (the default anchor table)"):
            rc = parity_run.main(base + ["--out", out1])
        summary = report(out1)
        avg = summary["datasets"]["Synth"]["average"]
        require(rc == 0 and summary["datasets"]["Synth"]["pass"] is None,
                f"parity_run with no row for the dataset: exit {rc}")
        require(all(np.isfinite(v) for v in avg.values()), f"parity_run: averages {avg}")
        table = os.path.join(root, "shifted.json")
        with open(table, "w") as f:
            json.dump({"Synth": dict(avg, **{"pixel AUC": avg["pixel AUC"] + 5.0})}, f)
        out2 = os.path.join(root, "rep2")
        with window("parity_run against a table shifted 5 points"):
            rc2 = parity_run.main(base + ["--out", out2, "--anchor_table", table])
        require(rc2 == 1 and report(out2)["failed"] == ["Synth"],
                f"parity_run out of budget: exit {rc2}")
        out3 = os.path.join(root, "rep3")
        with window("parity_run --quantize_backbone int8"):
            rc3 = parity_run.main(base + ["--out", out3, "--quantize_backbone", "int8"])
            got = read_counts()
        summary3 = report(out3)
        require(rc3 == 0 and "quantized backbone (int8)" in summary3["weights"]
                and got["ln_mlp_residual_int8"] > 0,
                f"parity_run int8: exit {rc3}, launches {got}")
        log(f"# repo tools, parity_run at {IMG} px on {card}: bf16 averages {avg}, outlier "
            f"ratios {summary['int8_outlier_ratios']}; shifted table exit {rc2}; int8 averages "
            f"{summary3['datasets']['Synth']['average']}")

    with window("probe_mlp_int8_sweep"):
        sweep = probe_mlp_int8_sweep.run(device=DEVICE, out=lambda line: log(f"#   {line}"))
        got = read_counts()
    require(set(sweep) == set(probe_mlp_int8_sweep.VARIANTS) and got["ln_mlp_residual_int8_probe"]
            >= len(sweep) * probe_mlp_int8_sweep.LAYERS, f"probe sweep: {sorted(sweep)}, {got}")
    for key, r in sweep.items():
        require(r["where"] == "cuda graph" and r["ms"] > 0 and r["vs_fp"] <= SWEEP_TOL
                and np.isfinite(r["vs_base"]), f"probe sweep {key}: {r}")
    log(f"# repo tools, probe_mlp_int8_sweep on {card}: " + "; ".join(
        f"ep_bf16={int(e)} ch={c} {r['ms']:.2f} ms/chain ({r['tops']:.1f} TOP/s), vs fp "
        f"{r['vs_fp']:.2e} (tol {SWEEP_TOL}), vs base {r['vs_base']:.2e}"
        for (e, c), r in sweep.items()))

    with window("probe_mlp_int8"):
        res = probe_mlp_int8.run(device=DEVICE, out=lambda line: log(f"#   {line}"))
    require(res["rel_err"] <= PROBE_MLP_TOL and all(c["ms"] > 0 for c in res["chains"].values()),
            f"probe_mlp_int8: {res} (tol {PROBE_MLP_TOL})")
    # One layer of each of its chains held to its plain version at its shape.
    ln, mlp, qmlp, x = probe_mlp_int8.make_case(probe_mlp_int8.ROWS, DEVICE)
    m = len(x)
    hold(f"probe_mlp_int8's B2 layer M={m}", fused_mlp.ln_mlp_residual(ln, mlp, x, gelu),
         fused_mlp.ln_mlp_residual_reference(ln, mlp, x, gelu), x)
    hold(f"probe_mlp_int8's B3 layer M={m}", fused_mlp.ln_mlp_residual_int8(ln, qmlp, x, gelu),
         fused_mlp.ln_mlp_residual_int8_reference(ln, qmlp, x, gelu), x)
    del ln, mlp, qmlp, x
    with window("probe_attn_fused"):
        res = probe_attn_fused.run(device=DEVICE, out=lambda line: log(f"#   {line}"))
        got = read_counts()
    require(all(r["rel_err"] <= PROBE_ATTN_TOL and r["fused_ms"] > 0 for r in res.values())
            and got["ln_attn_residual"] > 0 and got["packed_attention"] > 0,
            f"probe_attn_fused: {res}, {got} (tol {PROBE_ATTN_TOL})")
    # One layer of each chain held to its plain version at the larger batch:
    # B8, and B1 on the chain's packed projection, vv off and on.
    heads, valid = probe_attn_fused.HEADS, probe_attn_fused.VALID
    rng = np.random.default_rng(0)
    ln, attn = probe_attn_fused.make_params(rng, DEVICE)
    x = torch.from_numpy(rng.standard_normal((16, probe_attn_fused.TOKENS, probe_attn_fused.D))
                         .astype(np.float32) * 0.5).to(device=DEVICE, dtype=torch.bfloat16)
    qkv = linear(attn["qkv"], layer_norm(ln, x))
    scale = (probe_attn_fused.D // heads) ** -0.5
    for vv in (False, True):
        what = f"probe_attn_fused's layer B=16 L={x.shape[1]} valid_len={valid} vv={vv}"
        hold(f"{what}: B8", ab.ln_attn_residual(ln, attn, x, heads, vv, valid),
             ab.ln_attn_residual_reference(ln, attn, x, heads, vv, valid), x)
        hold(f"{what}: B1", pa.flash_mha_packed(qkv, heads, scale, vv=vv, valid_len=valid),
             pa.flash_mha_packed_reference(qkv, heads, scale, vv=vv, valid_len=valid))
    del ln, attn, x, qkv
    torch.cuda.empty_cache()
    log(f"# repo tools phase: {time.perf_counter() - t_phase:.1f} s, launches {total}")
    return total


# ----------------------------------------------------------------------
# Parallel: the port's data- and tensor-parallel paths on the one card
# ----------------------------------------------------------------------

PARALLEL_TIMEOUT = 420                   # each child process, seconds
PARALLEL_LOSS_TOL = 1e-4                 # DP loss against one process, relative
# DP gradients: rms(diff) / rms(one process's). Against one process's step
# over the same two halves as two microbatches (the same bf16 roundings);
# against one process's whole-batch step GRAD_BWD_TOL holds, since each
# half's bf16 weight gradients then round on their own (2-3e-3 rehearsed on
# the CPU).
PARALLEL_GRAD_TOL = 1e-3
PARALLEL_TABLE_TOL = 1e-6                # DP evaluation table against one process's
PARALLEL_CLASSES = ("bottle", "screw")
PARALLEL_MODEL = "ViT-L-14-336"
PARALLEL_CLI = ()                        # more cli.train arguments (a CPU rehearsal's)


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _wait_all(procs, logs, what, timeout=PARALLEL_TIMEOUT):
    """Wait for every process of ``procs`` (killed at the deadline), then
    require each to have exited 0; on a failure print the end of its log."""
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            try:
                p.wait(max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, path in zip(procs, logs):
        if p.returncode != 0:
            with open(path) as f:
                tail = f.read()[-3000:]
            log(f"# {what}: a process exited {p.returncode}; the end of its output:\n{tail}")
        require(p.returncode == 0, f"{what}: a process exited {p.returncode}")


def parallel_world1(root):
    """(a) cli.train --data_parallel under torchrun at world size 1 (NCCL,
    the steps on CUDA graphs with the gradient all-reduce captured) against
    the same command without torchrun: the losses and the saved adapters bit
    for bit."""
    import torch

    from aa_clip_iqm_tpu_torch.data.synthetic import generate
    from aa_clip_iqm_tpu_torch.loader import build_model_config, init_trainable
    from aa_clip_iqm_tpu_torch.models.convert import tree_leaves
    from aa_clip_iqm_tpu_torch.train.checkpoint import restore_adapters

    t0 = time.perf_counter()
    data, meta = os.path.join(root, "data"), os.path.join(root, "metadata")
    generate(os.path.join(root, "staging"), n_normal=8, n_anomalous=8, size=IMG,
             class_names=("bottle",), seed=13, dataset_name="MVTec-AD")
    os.makedirs(data)
    shutil.move(os.path.join(root, "staging", "MVTec-AD"), os.path.join(data, "MVTec-AD"))
    os.makedirs(os.path.join(meta, "MVTec"))
    shutil.move(os.path.join(root, "staging", "metadata", "MVTec-AD", "full-shot.jsonl"),
                os.path.join(meta, "MVTec", "full-shot.jsonl"))
    args = ["--data_parallel", "--random_backbone", "--dataset", "MVTec", "--img_size",
            str(IMG), "--training_mode", "full_shot", "--text_epoch", "0", "--image_epoch",
            "1", "--image_batch_size", str(B), "--metadata_root", meta, "--seed", "7",
            *PARALLEL_CLI]
    env = {**os.environ, "AACLIP_DATA_ROOT": data, "PYTHONPATH": ROOT}
    env.pop("AACLIP_MULTIHOST", None)
    runs = {"torchrun": [sys.executable, "-m", "torch.distributed.run", "--standalone",
                         "--nproc_per_node", "1", "-m", "aa_clip_iqm_tpu_torch.cli.train"],
            "one process": [sys.executable, "-m", "aa_clip_iqm_tpu_torch.cli.train"]}
    procs, logs = [], []
    for name, cmd in runs.items():
        path = os.path.join(root, f"{name.replace(' ', '_')}.log")
        logs.append(path)
        with open(path, "w") as f:
            procs.append(subprocess.Popen(
                [*cmd, *args, "--save_path", os.path.join(root, name.replace(" ", "_"))],
                cwd=ROOT, env=env, stdout=f, stderr=subprocess.STDOUT))
    _wait_all(procs, logs, "parallel (a)")
    wall = time.perf_counter() - t0
    a, b = (os.path.join(root, n.replace(" ", "_")) for n in runs)
    with open(os.path.join(a, "train.log")) as f:
        mesh_line = [ln for ln in f if "data-parallel over" in ln]
    require(mesh_line and "over 1 ranks (nccl)" in mesh_line[0],
            f"parallel (a): the torchrun run did not train on an NCCL mesh: {mesh_line}")

    def losses(path):
        with open(os.path.join(path, "scalars.jsonl")) as f:
            return [json.loads(ln)["loss"] for ln in f]

    la, lb = losses(a), losses(b)
    cfg = build_model_config(PARALLEL_MODEL, img_size=IMG)
    ta, _, _ = restore_adapters(a, init_trainable(cfg, device="cpu", dtype=torch.float32))
    tb, _, _ = restore_adapters(b, init_trainable(cfg, device="cpu", dtype=torch.float32))
    equal = all(torch.equal(x, y) for x, y in zip(tree_leaves(ta), tree_leaves(tb)))
    log(f"# parallel (a): cli.train --data_parallel under torchrun (world size 1, NCCL, stage "
        f"2 on CUDA graphs with the all-reduce captured) and without it, {len(la)} steps at "
        f"batch {B} each, both in {wall:.1f} s: losses {la} and {lb}, "
        f"{'equal' if la == lb else 'DIFFER'}; saved adapters "
        f"{'equal bit for bit' if equal else 'DIFFER'}")
    require(len(la) == 2 and la == lb, f"parallel (a): losses {la} and {lb}")
    require(equal, "parallel (a): the saved adapters differ")


def parallel_nccl_graphs():
    """(a) in this process: a process group of world size 1 on NCCL, and 3
    stage-2 steps at batch B on its mesh from one snapshot, eager and as
    replays of a captured step (the gradient all-reduce in the graph):
    bit for bit where two eager runs agree, as the training phase holds its
    replays; step ms on both."""
    import torch
    import torch.distributed as dist

    from aa_clip_iqm_tpu_torch.loader import build_model_config, init_trainable, random_backbone
    from aa_clip_iqm_tpu_torch.models.convert import tree_leaves
    from aa_clip_iqm_tpu_torch.parallel.mesh import make_mesh
    from aa_clip_iqm_tpu_torch.parallel.multihost import maybe_initialize
    from aa_clip_iqm_tpu_torch.train import optim

    require(maybe_initialize(f"127.0.0.1:{_free_port()}", 1, 0, backend="nccl"),
            "parallel: the NCCL process group did not initialize")
    try:
        cfg = build_model_config(PARALLEL_MODEL, img_size=IMG)
        frozen = random_backbone(cfg, seed=0, device=DEVICE, dtype=torch.bfloat16)
        mesh = make_mesh()
        require(mesh.graphable and mesh.data_group is not None,
                f"parallel: the world-size-1 mesh {mesh} has no NCCL group")
        params = init_trainable(cfg, seed=111, device=DEVICE, dtype=torch.float32,
                                requires_grad=True)
        snap = {"params": [t.detach().clone() for t in tree_leaves(params)],
                "opt": optim.stage2_optimizer(params, 5e-4, 3, graphable=True).state_dict()}
        g = torch.Generator().manual_seed(31)
        anchors = {c: torch.nn.functional.normalize(
            torch.randn(cfg.clip.embed_dim, 2, generator=g), dim=0).to(DEVICE)
            for c in PARALLEL_CLASSES}
        batches = stage2_batches(cfg, anchors)
        eager, estep, eopt, eparams = stage2_block(cfg, frozen, snap, batches, "eager",
                                                   mesh=mesh)
        again, _, _, _ = stage2_block(cfg, frozen, snap, batches, "eager", mesh=mesh)
        replayed, gstep, gopt, gparams = stage2_block(cfg, frozen, snap, batches, "graph",
                                                      mesh=mesh)
        hold_replays(f"parallel (a): stage 2 at batch {B} on a world-size-1 NCCL mesh, 3 "
                     f"steps from one snapshot (the gradient all-reduce captured)",
                     replayed, eager, again)

        def step_ms(step, params, opt, n=5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for i in range(n):
                step(params, opt, frozen, *batches[i % len(batches)], None)
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) / n * 1e3

        log(f"# parallel (a): world-size-1 NCCL stage-2 step at batch {B}: "
            f"{step_ms(gstep, gparams, gopt):.1f} ms a graph replay, "
            f"{step_ms(estep, eparams, eopt):.1f} ms eager (host clock, 5 steps each)")
        del frozen, eager, again, replayed, gstep, estep
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()


def parallel_gloo(root):
    """(b) and (c): two gloo processes on the one card (NCCL refuses two
    ranks on one GPU), each running parallel_child; the parent holds their
    results to rank 0's single-process references. Returns the kernel
    launches the children's parallel paths counted."""
    import numpy as np

    from aa_clip_iqm_tpu_torch.loader import build_model_config

    t0 = time.perf_counter()
    port = _free_port()
    procs, logs = [], []
    for rank in range(2):
        env = {**os.environ, "PYTHONPATH": ROOT, "MASTER_ADDR": "127.0.0.1",
               "MASTER_PORT": str(port), "RANK": str(rank), "WORLD_SIZE": "2",
               "LOCAL_RANK": "0"}
        env.pop("AACLIP_MULTIHOST", None)
        path = os.path.join(root, f"child{rank}.log")
        logs.append(path)
        with open(path, "w") as f:
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--parallel-child", str(rank),
                 root], cwd=ROOT, env=env, stdout=f, stderr=subprocess.STDOUT))
    _wait_all(procs, logs, "parallel (b, c)")
    wall = time.perf_counter() - t0
    counts = counts_of()
    for path in logs:
        with open(path) as f:
            lines = f.read().splitlines()
        for ln in lines:
            if ln.startswith("# "):
                log(ln)
        got = [json.loads(ln.split(" ", 1)[1]) for ln in lines if ln.startswith("COUNTS ")]
        require(len(got) == 1, f"parallel: a child printed {len(got)} counter lines")
        add_counts(counts, got[0])
    res = [np.load(os.path.join(root, f"rank{r}.npz")) for r in range(2)]
    ref = np.load(os.path.join(root, "reference.npz"))
    layers = build_model_config(PARALLEL_MODEL, img_size=IMG).clip.vision.layers

    def rel(a, b):
        a, b = a.astype(np.float64), b.astype(np.float64)
        return float(np.sqrt(((a - b) ** 2).mean()) / max(np.sqrt((b ** 2).mean()), 1e-30))

    for case in ("full", "padded"):
        for r in range(2):
            lerr = abs(float(res[r][f"{case} loss"]) - float(ref[f"{case} loss"])) / abs(
                float(ref[f"{case} loss"]))
            gerr = rel(res[r][f"{case} grads"], ref[f"{case} grads"])
            gone = rel(res[r][f"{case} grads"], ref[f"{case} grads, one batch"])
            log(f"# parallel (b): stage-2 step, DP over 2 gloo ranks, global batch {B} "
                f"({case}: {int(ref[f'{case} valid'])} valid rows), rank {r}: loss "
                f"{float(res[r][f'{case} loss']):.6f} against one process's "
                f"{float(ref[f'{case} loss']):.6f} (rel {lerr:.2e}, tol {PARALLEL_LOSS_TOL:.0e}); "
                f"gradients rel {gerr:.2e} of one process's over the ranks' halves as two "
                f"microbatches (tol {PARALLEL_GRAD_TOL:.0e}), {gone:.2e} of one process's "
                f"over the whole batch at once (tol {GRAD_BWD_TOL:.0e}: each half's bf16 "
                "weight gradients round on their own)")
            require(lerr <= PARALLEL_LOSS_TOL, f"parallel (b): {case} loss off by {lerr}")
            require(gerr <= PARALLEL_GRAD_TOL, f"parallel (b): {case} gradients off by {gerr}")
            require(gone <= GRAD_BWD_TOL, f"parallel (b): {case} gradients off by {gone}")
    fault = min(rel(res[0]["mean of means grads"], ref[k])
                for k in ("padded grads", "padded grads, one batch"))
    log(f"# planted fault, parallel (b): DDP's mean of the ranks' mean-loss gradients on the "
        f"padded batch (4 and 3 valid rows): rel {fault:.2e}: "
        f"{'caught' if fault > PARALLEL_GRAD_TOL else 'passed (NOT caught)'}")
    require(fault > PARALLEL_GRAD_TOL, "parallel (b): the gate missed the mean of means")
    for r in range(2):
        terr = float(np.abs(res[r]["table"] - ref["table"]).max())
        log(f"# parallel (b): evaluate_dataset over {len(PARALLEL_CLASSES)} in-memory classes "
            f"at batch {B}, DP over 2 gloo ranks, rank {r}: table within {terr:.2e} of one "
            f"process's (tol {PARALLEL_TABLE_TOL:.0e})")
        require(terr <= PARALLEL_TABLE_TOL, f"parallel (b): the DP table is off by {terr}")
    for r in range(2):
        err = map_diff(res[r]["tp map"], ref["map"])
        bad = map_diff(res[r]["tp map, out all-reduce dropped"], ref["map"])
        log(f"# parallel (c): predict at batch {B}, TP n_model=2 over 2 gloo ranks (B1 at "
            f"{HEADS // 2} heads), rank {r}: map {err:.2e} of one process's (gate {MAP_TOL:.0e}); "
            f"planted fault (the out-projection's all-reduce dropped): {bad:.2e}, "
            f"{'caught' if bad > MAP_TOL else 'passed (NOT caught)'}")
        require(err <= MAP_TOL, f"parallel (c): the TP map is off by {err}")
        require(bad > MAP_TOL, "parallel (c): the gate missed the dropped all-reduce")
        launched = dict(zip(KERNELS, (int(n) for n in res[r]["tp step launches"])))
        want = counts_of(packed_attention=layers, packed_attention_bwd=layers - 1)
        lerr = abs(float(res[r]["tp padded loss"]) - float(ref["padded loss"])) / abs(
            float(ref["padded loss"]))
        gerr = rel(res[r]["tp padded grads"], ref["padded grads, one batch"])
        log(f"# parallel (c): stage-2 step at batch {B} ({int(ref['padded valid'])} valid "
            f"rows) through the TP backbone, rank {r}: loss rel {lerr:.2e}, gradients rel "
            f"{gerr:.2e} of one process's (tol {GRAD_TOL:.0e}, the cuBLAS MLP chain against "
            f"B2 and B5); launched {launched}")
        require(launched == want, f"parallel (c): the TP step launched {launched}, want {want}")
        require(lerr <= GRAD_TOL and gerr <= GRAD_TOL,
                f"parallel (c): the TP step is off by {lerr} (loss) and {gerr} (gradients)")
    log(f"# parallel (b, c): 2 gloo processes in {wall:.1f} s, their parallel paths "
        f"launched {counts}")
    return counts


def parallel_child(rank, root):
    """One of the two gloo ranks of the parallel phase (on the one card):
    (b) the DP stage-2 step at global batch 8, full and padded, the planted
    mean of means, a DP evaluate_dataset; (c) TP predict with the backbone
    split over 2 ranks, and the same with the attention out-projection's
    all-reduce dropped. Rank 0 then computes the single-process references.
    Prints its timings, and its kernel counters (the parallel paths only) on
    a line 'COUNTS {json}'."""
    sys.path.insert(0, ROOT)
    from dataclasses import replace

    import numpy as np
    import torch
    import torch.distributed as dist

    from aa_clip_iqm_tpu_torch.configs import EvalConfig, TrainConfig
    from aa_clip_iqm_tpu_torch.evaluation.predict import METRIC_KEYS, evaluate_dataset
    from aa_clip_iqm_tpu_torch.evaluation.predict import make_predict_fn
    from aa_clip_iqm_tpu_torch.loader import build_model_config, init_trainable, random_backbone
    from aa_clip_iqm_tpu_torch.models import clip
    from aa_clip_iqm_tpu_torch.models.convert import tree_leaves
    from aa_clip_iqm_tpu_torch.parallel.collectives import all_reduce_sum_
    from aa_clip_iqm_tpu_torch.parallel.mesh import make_mesh, shard_backbone
    from aa_clip_iqm_tpu_torch.parallel.multihost import maybe_initialize, process_local_rows
    from aa_clip_iqm_tpu_torch.prompts import compute_frozen_anchors
    from aa_clip_iqm_tpu_torch.train import optim, steps

    rank = int(rank)
    maybe_initialize(f"127.0.0.1:{os.environ['MASTER_PORT']}", 2, rank, backend="gloo")
    try:
        t0 = time.perf_counter()
        cfg = build_model_config(PARALLEL_MODEL, img_size=IMG)
        frozen = random_backbone(cfg, seed=0, device=DEVICE, dtype=torch.bfloat16)
        serve = init_trainable(cfg, seed=111, device=DEVICE, dtype=torch.bfloat16)
        rng = np.random.default_rng(29)
        anchors = rng.standard_normal((B, cfg.clip.embed_dim, 2)).astype(np.float32)
        anchors /= np.linalg.norm(anchors, axis=1, keepdims=True)
        batch = [torch.from_numpy(a).to(DEVICE) for a in (
            rng.standard_normal((B, 3, IMG, IMG)).astype(np.float32),
            (rng.random((B, 1, IMG, IMG)) > 0.9).astype(np.float32),
            rng.integers(0, 2, B), anchors)]
        u8 = torch.from_numpy(rng.integers(0, 256, (B, 3, IMG, IMG), dtype=np.uint8)).to(DEVICE)
        train_cfg = TrainConfig(img_size=IMG, compute_dtype="bfloat16")
        valid = {"full": B, "padded": B - 1}
        out, ref = {}, {}

        def stage2(mesh, rows, case, accum=1, backbone=None):
            trainable = init_trainable(cfg, seed=111, device=DEVICE, dtype=torch.float32,
                                       requires_grad=True)
            opt = optim.stage2_optimizer(trainable, train_cfg.image_lr, 10, graphable=False)
            step = steps.make_stage2_step(cfg, replace(train_cfg, grad_accum_steps=accum),
                                          compute_dtype=torch.bfloat16, mesh=mesh)
            weights = (torch.arange(B, device=DEVICE) < valid[case]).float()
            lo, hi = rows
            _, _, loss = step(trainable, opt, frozen if backbone is None else backbone,
                              *[t[lo:hi] for t in batch], weights[lo:hi])
            grads = torch.cat([t.grad.reshape(-1) for t in tree_leaves(trainable)
                               if t.grad is not None])
            return loss.item(), grads.float().cpu().numpy()

        def table(rows):
            return np.asarray([[r[k] for k in METRIC_KEYS] for r in rows], np.float64)

        sets = {c: MemoryDataset(c, 12, IMG, seed=40 + i)
                for i, c in enumerate(PARALLEL_CLASSES)}
        class_anchors = compute_frozen_anchors(frozen, serve, cfg, "MVTec", adapted=False,
                                               compute_dtype=torch.bfloat16)
        ecfg = EvalConfig(dataset="MVTec", img_size=IMG, batch_size=B)
        torch.cuda.synchronize()
        print(f"# parallel child {rank}: ViT-L weights and anchors in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)

        # (b) data parallelism
        reset_counts()
        t0 = time.perf_counter()
        mesh = make_mesh()
        rows = process_local_rows(mesh, B)
        t_step = []
        for case in valid:
            out[f"{case} loss"], out[f"{case} grads"] = stage2(mesh, rows, case)
            torch.cuda.synchronize()
            t_step.append((time.perf_counter() - t0) * 1e3)
            t0 = time.perf_counter()
        t0 = time.perf_counter()
        table_dp = evaluate_dataset(frozen, serve, cfg, ecfg, sets, class_anchors,
                                    compute_dtype=torch.bfloat16, mesh=mesh)
        t_eval = time.perf_counter() - t0
        out["table"] = table(table_dp)

        # (c) tensor parallelism
        tp = make_mesh(n_data=1, n_model=2)
        shard = shard_backbone(tp, frozen, cfg.clip)
        predict_tp = make_predict_fn(cfg, IMG, "Industrial", compute_dtype=torch.bfloat16,
                                     mesh=tp)
        anchors_t = batch[3]
        t0 = time.perf_counter()
        maps, _ = predict_tp(shard, serve, u8, anchors_t)
        torch.cuda.synchronize()
        t_tp = time.perf_counter() - t0
        out["tp map"] = maps.cpu().numpy()
        before = read_counts()
        t0 = time.perf_counter()
        out["tp padded loss"], out["tp padded grads"] = stage2(tp, (0, B), "padded",
                                                               backbone=shard)
        torch.cuda.synchronize()
        t_tp_step = time.perf_counter() - t0
        counts = read_counts()
        out["tp step launches"] = np.asarray([counts[k] - before[k] for k in KERNELS])
        flat = torch.zeros(out["full grads"].size + 2, device=DEVICE)
        all_reduce_sum_([flat], dist.group.WORLD)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            all_reduce_sum_([flat], dist.group.WORLD)
        torch.cuda.synchronize()
        t_reduce = (time.perf_counter() - t0) / 5

        # The planted faults, outside the counted paths: DDP's mean of the
        # ranks' mean losses, and TP without the out-projection's sum.
        _, local = stage2(None, rows, "padded")
        g = torch.from_numpy(local)
        dist.all_reduce(g)
        out["mean of means grads"] = (g / 2).numpy()
        keep = clip._row_parallel
        width = cfg.clip.vision.width

        def no_attn_sum(params, x, group):
            return keep(params, x, None if params["w"].shape[0] == width // 2 else group)

        clip._row_parallel = no_attn_sum
        try:
            maps, _ = predict_tp(shard, serve, u8, anchors_t)
        finally:
            clip._row_parallel = keep
        out["tp map, out all-reduce dropped"] = maps.cpu().numpy()
        np.savez(os.path.join(root, f"rank{rank}.npz"), **out)
        print(f"# parallel child {rank}: stage-2 step at {B // 2} rows (eager, the gradients' "
              f"gloo all-reduce included; the two processes share the card) {t_step[0]:.0f} "
              f"ms the first, {t_step[1]:.0f} ms the second (fresh adapters and optimizer "
              f"each), the gradients' gloo all-reduce alone {t_reduce * 1e3:.1f} ms "
              f"({flat.numel() * 4 / 1e6:.1f} MB), DP sweep {t_eval:.1f} s, TP predict "
              f"{t_tp * 1e3:.0f} ms (48 gloo all-reduces of "
              f"{B * TOKENS * WIDTH * 4 / 1e6:.0f} MB), TP stage-2 step at {B} rows "
              f"{t_tp_step * 1e3:.0f} ms (its first)", flush=True)
        del shard, predict_tp
        torch.cuda.empty_cache()
        dist.barrier()

        # Rank 0: the single-process references, while rank 1 waits.
        if rank == 0:
            for case in valid:
                ref[f"{case} loss"], ref[f"{case} grads"] = stage2(None, (0, B), case, accum=2)
                _, ref[f"{case} grads, one batch"] = stage2(None, (0, B), case)
                ref[f"{case} valid"] = valid[case]
            ref["table"] = table(evaluate_dataset(frozen, serve, cfg, ecfg, sets,
                                                  class_anchors,
                                                  compute_dtype=torch.bfloat16))
            maps, _ = make_predict_fn(cfg, IMG, "Industrial", compute_dtype=torch.bfloat16)(
                frozen, serve, u8, anchors_t)
            ref["map"] = maps.cpu().numpy()
            np.savez(os.path.join(root, "reference.npz"), **ref)
        dist.barrier()
        print("COUNTS " + json.dumps(counts), flush=True)
    finally:
        dist.destroy_process_group()
    return 0


def phase_parallel(card):
    """The port's multi-GPU paths on the one card (module docstring, phase
    16). Returns the launches of the children's parallel paths."""
    import tempfile

    root = tempfile.mkdtemp(prefix="chip_smoke_parallel_")
    t0 = time.perf_counter()
    try:
        parallel_nccl_graphs()
        parallel_world1(root)
        counts = parallel_gloo(root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log(f"# parallel: {time.perf_counter() - t0:.1f} s")
    return counts


def profile_call(fn, what):
    """Device time by kernel group for one call of ``fn`` (torch.profiler):
    where the time goes, and the device's idle share of the call."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from aa_clip_iqm_tpu_torch.tools.trace_summary import kernel_group

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    groups, kernels = {}, []
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        ms = evt.self_device_time_total / 1e3
        group = kernel_group(evt.key)
        groups[group] = groups.get(group, 0.0) + ms
        kernels.append((ms, evt.count, evt.key[:90]))
    busy = sum(groups.values())
    require(busy > 0, f"profile, {what}: the profiler saw no device time")
    idle = 1.0 - busy / wall_ms
    log(f"# profile, {what}: wall {wall_ms:.1f} ms under the "
        f"profiler, device busy {busy:.1f} ms, idle share {idle:.3f}")
    for group, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        log(f"#   {group}: {ms:.2f} ms ({ms / busy:.1%} of device time)")
    for ms, count, name in sorted(kernels, reverse=True)[:8]:
        log(f"#   {ms:8.2f} ms x{count:<4d} {name}")


def profile_request(det, imgs):
    profile_call(lambda: det.predict(imgs, "screw"), f"one batch-{len(imgs)} request")


def main():
    t_start = time.perf_counter()
    try:
        card = phase_device()
        sys.path.insert(0, ROOT)
        import aa_clip_iqm_tpu_torch  # noqa: F401  (fails outside a checkout)

        phase_build()
        phase_native(card)
        kernels = phase_kernels()
        eva_kernels, eva_launches = phase_eva02(card)
        kernels.update(eva_kernels)
        launches, ctx = phase_main_path(card)
        add_counts(launches, eva_launches)
        add_counts(launches, phase_int8_tiers(card, ctx))
        add_counts(launches, phase_sweep(card, ctx))
        add_counts(launches, phase_fused(card, ctx))
        add_counts(launches, phase_highres(card, ctx))
        add_counts(launches, phase_surgery_backward(ctx))
        add_counts(launches, phase_deploy(card, ctx))
        add_counts(launches, phase_tools(card, ctx))
        add_counts(launches, phase_models(card))
        add_counts(launches, phase_repo_tools(card))
        cfg, frozen = ctx["cfg"], ctx["frozen"]
        del ctx
        phase_metrics_scale(card)
        add_counts(launches, phase_train(card, cfg, frozen))
        del frozen
        add_counts(launches, phase_serve(card))
        add_counts(launches, phase_parallel(card))
        for name in KERNELS:
            require(launches[name] > 0, f"the driven paths never launched {name}")
    except (Failure, ImportError, RuntimeError, subprocess.CalledProcessError) as exc:
        if not isinstance(exc, Failure):
            traceback.print_exc()
        log(f"# FAILED: {type(exc).__name__}: {exc}")
        return 1
    for name, entry in kernels.items():
        entry["launches"] = launches[name]
    import torch

    log(f"# stage profiles measured again after lost records: {len(STAGE_RETRIES)} "
        f"{STAGE_RETRIES}")
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
    if sys.argv[1:2] == ["--exported-child"]:
        sys.exit(exported_child(*sys.argv[2:5]))
    if sys.argv[1:2] == ["--parallel-child"]:
        sys.exit(parallel_child(*sys.argv[2:4]))
    sys.exit(main())
