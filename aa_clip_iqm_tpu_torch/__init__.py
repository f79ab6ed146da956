"""aa_clip_iqm_tpu_torch — PyTorch/CUDA port of aa_clip_iqm_tpu for NVIDIA Hopper.

The JAX package ``aa_clip_iqm_tpu`` is the reference; this package keeps its
module names so each counterpart is easy to find, and imports nothing of it
(nor JAX). What is ported so far: the serving path with its int8 tiers, its
checkpoint loaders and its HTTP front end, the per-class evaluation sweep
and the two-stage adapter training:

  - :mod:`.configs`, :mod:`.data.registry`, :mod:`.tokenizer` — own copies of
    the model configs, prompt tables, dataset metadata and BPE vocabulary;
  - :mod:`.ops` — layers, attention, the blur/upsample operators, the int8
    tier (``quant``), the rank metrics (``metrics``) and the three
    hand-written Hopper kernels (``csrc/packed_attention.cu``,
    ``csrc/ln_mlp_residual.cu``, ``csrc/ln_mlp_residual_int8.cu``) with
    their plain PyTorch twins;
  - :mod:`.models` — the CLIP towers, IQM head, adapters, the weight bridge,
    the OpenAI ``.pt`` and reference ``.pth`` loaders and the ``.npz``
    weight cache;
  - :mod:`.data` — the test datasets and the synthetic generator;
  - :mod:`.evaluation`, :mod:`.prompts`, :mod:`.loader`, :mod:`.serving` —
    scoring, anchors, ``make_predict_fn``, ``evaluate_dataset`` and
    ``AnomalyDetector``;
  - :mod:`.cli` — ``evaluate`` (the sweep), ``train``, ``serve`` (HTTP),
    ``single_image`` and ``bench``;
  - :mod:`.parallel` — data and tensor parallelism over several processes
    on ``torch.distributed`` (``--data_parallel`` under ``torchrun``).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``. On a
CPU tensor each kernel wrapper runs its plain twin; on a CUDA tensor it
launches the kernel or raises.
"""

__version__ = "0.1.0"
