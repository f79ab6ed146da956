"""Carry weights into the port's parameter dicts.

Two parts:
  - :func:`params_from_jax` turns parameter pytrees in the JAX package's
    layout (nested dicts/lists of numpy arrays, weights ``(in, out)``, block
    leaves stacked on a leading layer axis; ``aa_clip_iqm_tpu/models/clip.py``
    and ``adapters.py`` document it) into this package's dicts of tensors,
    with stacked layer axes split into per-layer lists.
  - :func:`init_clip_params_np` / :func:`init_adapter_params_np` build seeded
    random weights at full width with numpy ``default_rng`` and the shapes of
    the JAX initializers (``init_clip_params``, ``init_adapter_params``). They
    do not reproduce JAX's random numbers; tests that compare the two
    packages initialize with JAX and bridge with :func:`params_from_jax`.

Matmul weights (every ``w`` with 2+ dims, ``proj`` and ``text_projection``)
are stored in the compute dtype; everything else (biases, LayerNorm
parameters, embeddings) stays float32, as the JAX functions cast it at use.
A quantized JAX pytree (``w_q`` int8, ``scale`` float32 ``(layers, 1, out)``,
``b``) passes through with the same integers and per-layer ``(1, out)``
scales.

:func:`save_params_npz` / :func:`load_params_npz` are the flat ``.npz``
weight cache of the JAX package (same key scheme, so either package reads
the other's file).
"""
from __future__ import annotations

import io
import math
import os

import numpy as np
import torch

from ..configs import ModelConfig

# Pytree keys whose leaves are stacked on a leading layer axis in the JAX
# layout, by parent path.
_STACKED = {("visual", "blocks"), ("text", "blocks"),
            ("image_adapter", "layer_adapters"), ("text_adapter", "layers")}
_MATRIX_KEYS = {"proj", "text_projection"}


def _unstack(tree):
    """Stacked pytree (leaves with a leading layer axis) -> list per layer."""
    def first_leaf(t):
        return first_leaf(next(iter(t.values()))) if isinstance(t, dict) else t

    def take(t, i):
        return {k: take(v, i) for k, v in t.items()} if isinstance(t, dict) else t[i]

    return [take(tree, i) for i in range(np.shape(first_leaf(tree))[0])]


def _convert(tree, device, dtype, key=None):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            if (key, k) in _STACKED:
                layers = v if isinstance(v, (list, tuple)) else _unstack(v)
                out[k] = [_convert(layer, device, dtype, k) for layer in layers]
            else:
                out[k] = _convert(v, device, dtype, k)
        return out
    if isinstance(tree, (list, tuple)):
        return [_convert(v, device, dtype, key) for v in tree]
    if key == "w_q":
        # An int8-quantized weight (ops.quant) stays the same integers.
        return torch.tensor(np.asarray(tree, dtype=np.int8), device=device)
    arr = np.asarray(tree, dtype=np.float32)
    is_matrix = (key == "w" and arr.ndim >= 2) or key in _MATRIX_KEYS
    return torch.tensor(arr, device=device,
                        dtype=dtype if is_matrix else torch.float32)


def params_from_jax(frozen_np, trainable_np, cfg: ModelConfig, device="cuda",
                    dtype=torch.bfloat16):
    """(frozen, trainable) pytrees of numpy arrays in the JAX layout ->
    (frozen, trainable) dicts of tensors on ``device``. Either may be None.
    ``cfg`` is checked against the visual tower's depth."""
    frozen = trainable = None
    if frozen_np is not None:
        blocks = frozen_np["visual"]["blocks"]
        depth = (len(blocks) if isinstance(blocks, (list, tuple))
                 else np.shape(blocks["ln_1"]["scale"])[0])
        if depth != cfg.clip.vision.layers:
            raise ValueError(f"visual tower has {depth} blocks, config says "
                             f"{cfg.clip.vision.layers}")
        frozen = _convert({"visual": frozen_np["visual"],
                           "text": frozen_np["text"]}, device, dtype)
    if trainable_np is not None:
        trainable = _convert(trainable_np, device, dtype)
    return frozen, trainable


# --------------------------------------------------------------------------
# Flat npz round trip (the converted backbone's weight cache)
# --------------------------------------------------------------------------

def _flatten(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flatten(v, f"{prefix}{k}/")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flatten(v, f"{prefix}{i}/")
    else:
        arr = tree.detach().float().cpu().numpy() if isinstance(tree, torch.Tensor) else tree
        yield prefix[:-1], np.asarray(arr)


def save_params_npz(params, path: str):
    """Write a parameter pytree (numpy arrays or tensors; dicts and lists)
    as one flat ``.npz`` with ``/``-joined keys."""
    buf = io.BytesIO()
    np.savez(buf, **dict(_flatten(params)))
    with open(path, "wb") as f:
        f.write(buf.getvalue())


def load_params_npz(path: str):
    """Read a :func:`save_params_npz` file back into nested dicts (and
    lists, where all keys of a level are digits) of numpy arrays."""
    with np.load(path) as data:
        flat = {k: data[k] for k in data.files}
    root: dict = {}
    for key, val in flat.items():
        parts = key.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val

    def listify(node):
        if isinstance(node, dict):
            keys = list(node.keys())
            if keys and all(k.isdigit() for k in keys):
                return [listify(node[str(i)]) for i in range(len(keys))]
            return {k: listify(v) for k, v in node.items()}
        return node

    return listify(root)


def find_backbone(model_name: str = "ViT-L-14-336",
                  search_dirs=(".", "weights", os.path.expanduser("~"))):
    """Locate a usable backbone checkpoint (.npz cache preferred, else .pt)."""
    names = [f"{model_name}.npz", f"{model_name}px.npz",
             f"{model_name}px.pt", f"{model_name}.pt"]
    for d in search_dirs:
        for n in names:
            p = os.path.join(d, n)
            if os.path.isfile(p):
                return p
    return None


# --------------------------------------------------------------------------
# Seeded random initialization (numpy), JAX initializer shapes
# --------------------------------------------------------------------------

def _normal(rng, shape, std):
    return rng.standard_normal(shape, dtype=np.float32) * np.float32(std)


def _ln(n, dim):
    lead = (n,) if n else ()
    return {"scale": np.ones(lead + (dim,), np.float32),
            "bias": np.zeros(lead + (dim,), np.float32)}


def _blocks(rng, n, width, hidden):
    """n stacked pre-norm blocks, as models/clip.py:_init_block."""
    def lin(d_in, d_out):
        return {"w": _normal(rng, (n, d_in, d_out), d_in ** -0.5),
                "b": np.zeros((n, d_out), np.float32)}

    return {"ln_1": _ln(n, width),
            "attn": {"qkv": lin(width, 3 * width), "out": lin(width, width)},
            "ln_2": _ln(n, width),
            "mlp": {"c_fc": lin(width, hidden), "c_proj": lin(hidden, width)}}


def init_clip_params_np(cfg: ModelConfig, seed: int = 0):
    """Random frozen CLIP params (JAX layout, numpy float32)."""
    rng = np.random.default_rng(seed)
    v, t = cfg.clip.vision, cfg.clip.text
    scale = v.width ** -0.5
    visual = {
        "patch_embed": {"w": _normal(rng, (3 * v.patch_size ** 2, v.width), scale)},
        "class_embedding": _normal(rng, (v.width,), scale),
        "positional_embedding": _normal(rng, (v.num_patches + 1, v.width), scale),
        "ln_pre": _ln(0, v.width),
        "blocks": _blocks(rng, v.layers, v.width, int(v.width * v.mlp_ratio)),
        "ln_post": _ln(0, v.width),
        "proj": _normal(rng, (v.width, v.output_dim), scale),
    }
    text = {
        "token_embedding": _normal(rng, (t.vocab_size, t.width), 0.02),
        "positional_embedding": _normal(rng, (t.context_length, t.width), 0.01),
        "blocks": _blocks(rng, t.layers, t.width, 4 * t.width),
        "ln_final": _ln(0, t.width),
        "text_projection": _normal(rng, (t.width, t.output_dim), t.width ** -0.5),
    }
    return {"visual": visual, "text": text,
            "logit_scale": np.float32(math.log(1 / 0.07))}


def _xavier(rng, d_in, d_out, bias=True, n=0):
    a = math.sqrt(6.0 / (d_in + d_out))
    lead = (n,) if n else ()
    p = {"w": rng.uniform(-a, a, lead + (d_in, d_out)).astype(np.float32)}
    if bias:
        bound = 1.0 / math.sqrt(d_in)
        p["b"] = rng.uniform(-bound, bound, lead + (d_out,)).astype(np.float32)
    return p


def _iqm_np(rng, cfg):
    h = cfg.hidden_size

    def attention(kv_dim):
        return {"q": _xavier(rng, h, h), "k": _xavier(rng, kv_dim, h),
                "v": _xavier(rng, kv_dim, h), "out_dense": _xavier(rng, h, h),
                "out_ln": _ln(0, h)}

    layers = []
    for i in range(cfg.num_hidden_layers):
        layer = {"self": attention(h)}
        if i % cfg.cross_attention_frequency == 0:
            layer["cross"] = attention(cfg.encoder_hidden_size)
            layer["text_cross"] = attention(cfg.text_encoder_hidden_size)
        layer["ffn_q"] = {"intermediate": _xavier(rng, h, cfg.intermediate_size),
                          "output": _xavier(rng, cfg.intermediate_size, h),
                          "ln": _ln(0, h)}
        layers.append(layer)
    return {"layernorm": _ln(0, h), "layers": layers}


def init_adapter_params_np(cfg: ModelConfig, seed: int = 111):
    """Random trainable params (JAX layout, numpy float32; xavier-uniform
    weights and torch-default uniform biases, as init_adapter_params)."""
    from .iqm import sinusoidal_positions

    rng = np.random.default_rng(seed)
    a = cfg.adapter
    vw, tw = cfg.clip.vision.width, cfg.clip.text.width
    out_dim, hidden = cfg.clip.embed_dim, cfg.iqm.hidden_size
    n_levels = len(a.levels)
    return {
        "image_adapter": {
            "layer_adapters": _xavier(rng, vw, vw, bias=False, n=a.image_adapt_until),
            "seg_proj": [_xavier(rng, vw, out_dim, bias=False) for _ in range(n_levels)],
            "det_proj": _xavier(rng, vw, out_dim, bias=False),
        },
        "text_adapter": {
            "layers": _xavier(rng, tw, tw, bias=False, n=a.text_adapt_until),
            "proj": _xavier(rng, tw, tw, bias=False),
        },
        "iqm": _iqm_np(rng, cfg.iqm),
        "class_query_mlp": {"fc1": _xavier(rng, vw, hidden),
                            "fc2": _xavier(rng, hidden, hidden)},
        "query_adapters": [_xavier(rng, vw, hidden, bias=False)
                           for _ in range(n_levels)],
        "pos_embedding": sinusoidal_positions(2, hidden).numpy(),
        "visual_feature_proj": _xavier(rng, hidden, hidden),
        "text_feature_proj": _xavier(rng, cfg.iqm.text_encoder_hidden_size,
                                     cfg.iqm.text_encoder_hidden_size),
        "query_proj": _xavier(rng, hidden, out_dim),
        "iqm_layer_norm": _ln(0, hidden),
    }
