"""Carry weights into the port's parameter dicts.

  - :func:`params_from_jax` turns parameter pytrees in the JAX package's
    layout (nested dicts/lists of numpy arrays, weights ``(in, out)``, block
    leaves stacked on a leading layer axis; ``aa_clip_iqm_tpu/models/clip.py``
    and ``adapters.py`` document it) into this package's dicts of tensors,
    with stacked layer axes split into per-layer lists.
  - :func:`params_to_jax` is the inverse for a trainable dict: numpy arrays
    in the JAX layout, layers stacked again, so that tests can compare
    updated parameters.
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

:func:`load_openai_checkpoint` reads an OpenAI ``.pt`` and
:func:`torch_state_dict_to_params` maps its state dict into the JAX layout
(numpy, blocks stacked, the positional embedding resized to the config's
grid), ready for :func:`params_from_jax` or the ``.npz`` cache. The
``import_reference_*`` functions load the PyTorch reference's adapter
checkpoints into a trainable dict.
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
    out_dtype = dtype if is_matrix else torch.float32
    if torch.device(device).type == "meta":    # shapes only, no copy
        return torch.empty(arr.shape, dtype=out_dtype, device=device)
    return torch.tensor(arr, device=device, dtype=out_dtype)


def params_from_jax(frozen_np, trainable_np, cfg: ModelConfig, device="cuda",
                    dtype=torch.bfloat16):
    """(frozen, trainable) pytrees of numpy arrays in the JAX layout ->
    (frozen, trainable) dicts of tensors on ``device``. Either may be None.
    ``cfg`` is checked against the visual tower's depth. ``dtype`` is that of
    the matrices: bf16 for a frozen backbone and for serving; training wants
    its trainable dict in ``torch.float32`` (master weights)."""
    frozen = trainable = None
    if frozen_np is not None:
        visual = frozen_np["visual"]
        if "layers" in visual:      # ModifiedResNet: blocks per stage
            depth = tuple(len(stage) for stage in visual["layers"])
        else:
            blocks = visual["blocks"]
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


def tree_leaves(tree):
    """Every tensor of a nested dict / list of tensors, in a fixed order."""
    if isinstance(tree, dict):
        for k in tree:
            yield from tree_leaves(tree[k])
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from tree_leaves(v)
    else:
        yield tree


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts / lists of one shape."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
    return fn(tree, *rest)


def params_to_jax(trainable):
    """A trainable dict of tensors -> numpy float32 pytree in the JAX layout:
    the per-layer lists that :func:`params_from_jax` split are stacked on a
    leading layer axis again. The arrays are copies: later in-place updates
    of the tensors do not reach them."""
    def to_np(tree, key=None):
        if isinstance(tree, dict):
            out = {}
            for k, v in tree.items():
                if (key, k) in _STACKED:
                    layers = [to_np(layer, k) for layer in v]
                    out[k] = tree_map(lambda *xs: np.stack(xs), layers[0], *layers[1:])
                else:
                    out[k] = to_np(v, k)
            return out
        if isinstance(tree, (list, tuple)):
            return [to_np(v, key) for v in tree]
        return np.array(tree.detach().float().cpu().numpy())   # a copy

    return to_np(trainable)


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


# --------------------------------------------------------------------------
# OpenAI CLIP checkpoint -> numpy pytree in the JAX layout
# --------------------------------------------------------------------------
#
# Weight layout (torch -> here): an nn.Linear weight (out, in) becomes w
# (in, out), transposed; MultiheadAttention's in_proj_weight (3d, d) becomes
# qkv.w (d, 3d), the q/k/v order kept by the transpose; conv1's weight
# (width, 3, p, p) becomes patch_embed.w (3*p*p, width), whose flattened
# (c, ph, pw) order is patchify's token layout.

def _t(x):
    return np.ascontiguousarray(np.asarray(x, dtype=np.float32).T)


def _f32(x):
    return np.asarray(x, np.float32)


def _ln(sd, prefix):
    return {"scale": _f32(sd[prefix + ".weight"]),
            "bias": _f32(sd[prefix + ".bias"])}


def _block(sd, prefix):
    return {
        "ln_1": _ln(sd, prefix + ".ln_1"),
        "attn": {
            "qkv": {"w": _t(sd[prefix + ".attn.in_proj_weight"]),
                    "b": _f32(sd[prefix + ".attn.in_proj_bias"])},
            "out": {"w": _t(sd[prefix + ".attn.out_proj.weight"]),
                    "b": _f32(sd[prefix + ".attn.out_proj.bias"])},
        },
        "ln_2": _ln(sd, prefix + ".ln_2"),
        "mlp": {
            "c_fc": {"w": _t(sd[prefix + ".mlp.c_fc.weight"]),
                     "b": _f32(sd[prefix + ".mlp.c_fc.bias"])},
            "c_proj": {"w": _t(sd[prefix + ".mlp.c_proj.weight"]),
                       "b": _f32(sd[prefix + ".mlp.c_proj.bias"])},
        },
    }


def _stack_np(blocks):
    """A list of per-layer block trees -> one tree whose leaves carry a
    leading layer axis (the JAX layout)."""
    return tree_map(lambda *xs: np.stack(xs, axis=0), blocks[0], *blocks[1:])


def _text_tree(sd, cfg):
    return {
        "token_embedding": _f32(sd["token_embedding.weight"]),
        "positional_embedding": _f32(sd["positional_embedding"]),
        "blocks": _stack_np([_block(sd, f"transformer.resblocks.{i}")
                             for i in range(cfg.text.layers)]),
        "ln_final": _ln(sd, "ln_final"),
        "text_projection": _f32(sd["text_projection"]),
    }


def _conv_t(w):
    """A torch conv kernel (out, in, kh, kw) -> HWIO."""
    return np.ascontiguousarray(_f32(w).transpose(2, 3, 1, 0))


def _bn_t(sd, prefix):
    return {"scale": _f32(sd[prefix + ".weight"]), "bias": _f32(sd[prefix + ".bias"]),
            "mean": _f32(sd[prefix + ".running_mean"]),
            "var": _f32(sd[prefix + ".running_var"])}


def _lin_t(sd, prefix):
    p = {"w": _t(sd[prefix + ".weight"])}
    if prefix + ".bias" in sd:
        p["b"] = _f32(sd[prefix + ".bias"])
    return p


def resnet_state_dict_to_params(sd, cfg):
    """An OpenAI RN CLIP state dict (numpy-valued) -> the numpy pytree of the
    JAX layout: the stem ``visual.conv{1-3}`` / ``bn{1-3}``, the stages
    ``visual.layer{1-4}.{i}`` with their ``downsample.{0,1}``, the attention
    pool ``visual.attnpool.{q,k,v,c}_proj`` with its positional embedding
    resized bicubically to ``cfg.vision``'s grid, and the text tower."""
    from .clip import resize_pos_embed_np

    v = cfg.vision
    visual = {}
    for i in (1, 2, 3):
        visual[f"conv{i}"] = {"kernel": _conv_t(sd[f"visual.conv{i}.weight"])}
        visual[f"bn{i}"] = _bn_t(sd, f"visual.bn{i}")
    stages = []
    for s, n_blocks in enumerate(v.layers, start=1):
        blocks = []
        for bi in range(n_blocks):
            pre = f"visual.layer{s}.{bi}"
            blk = {}
            for j in (1, 2, 3):
                blk[f"conv{j}"] = {"kernel": _conv_t(sd[f"{pre}.conv{j}.weight"])}
                blk[f"bn{j}"] = _bn_t(sd, f"{pre}.bn{j}")
            if pre + ".downsample.0.weight" in sd:
                blk["downsample"] = {"conv": {"kernel": _conv_t(sd[pre + ".downsample.0.weight"])},
                                     "bn": _bn_t(sd, pre + ".downsample.1")}
            blocks.append(blk)
        stages.append(blocks)
    visual["layers"] = stages
    visual["attnpool"] = {
        "positional_embedding": resize_pos_embed_np(
            _f32(sd["visual.attnpool.positional_embedding"]), v.grid, True),
        **{n: _lin_t(sd, f"visual.attnpool.{n}_proj") for n in ("q", "k", "v")},
        "c_proj": _lin_t(sd, "visual.attnpool.c_proj"),
    }
    return {"visual": visual, "text": _text_tree(sd, cfg),
            "logit_scale": _f32(sd.get("logit_scale", np.log(1 / 0.07)))}


def torch_state_dict_to_params(sd, cfg):
    """An OpenAI CLIP state dict (numpy-valued) -> the numpy pytree of the
    JAX layout, blocks stacked, with the visual positional embedding
    resized bicubically to ``cfg.vision``'s grid. ``cfg`` is a
    ``CLIPConfig``; an RN config (``ResNetVisionConfig``) goes to
    :func:`resnet_state_dict_to_params`. :func:`params_from_jax` carries the
    result onto a device."""
    from ..configs import ResNetVisionConfig
    from .clip import resize_pos_embed_np

    if not all(isinstance(v, np.ndarray) for v in sd.values()):
        sd = {k: np.asarray(v) for k, v in sd.items()}
    if isinstance(cfg.vision, ResNetVisionConfig):
        return resnet_state_dict_to_params(sd, cfg)
    conv_w = _f32(sd["visual.conv1.weight"])
    visual = {
        "patch_embed": {"w": np.ascontiguousarray(
            conv_w.reshape(conv_w.shape[0], -1).T)},
        "class_embedding": _f32(sd["visual.class_embedding"]),
        "positional_embedding": resize_pos_embed_np(
            _f32(sd["visual.positional_embedding"]), cfg.vision.grid, True),
        "ln_pre": _ln(sd, "visual.ln_pre"),
        "blocks": _stack_np([_block(sd, f"visual.transformer.resblocks.{i}")
                             for i in range(cfg.vision.layers)]),
        "ln_post": _ln(sd, "visual.ln_post"),
        "proj": _f32(sd["visual.proj"]),
    }
    return {"visual": visual, "text": _text_tree(sd, cfg),
            "logit_scale": _f32(sd.get("logit_scale", np.log(1 / 0.07)))}


def _np(v):
    """A tensor (any float dtype) or array -> float32 numpy."""
    return v.float().numpy() if isinstance(v, torch.Tensor) else _f32(v)


def load_openai_checkpoint(path: str, cfg):
    """Load an OpenAI ``.pt`` checkpoint (a TorchScript archive, a
    ``{"state_dict": ...}`` dict or a plain state dict) on the CPU and
    convert it with :func:`torch_state_dict_to_params`. fp16 tensors are
    cast to float32 first; the metadata entries ``input_resolution``,
    ``context_length`` and ``vocab_size`` are dropped."""
    # A TorchScript archive is no plain tensor file: weights_only=False.
    obj = torch.load(path, map_location="cpu", weights_only=False)
    if hasattr(obj, "state_dict"):
        sd = obj.state_dict()
    elif isinstance(obj, dict) and "state_dict" in obj:
        sd = obj["state_dict"]
    else:
        sd = obj
    del obj
    sd = {k: _np(sd[k]) for k in list(sd)}
    for key in ("input_resolution", "context_length", "vocab_size"):
        sd.pop(key, None)
    return torch_state_dict_to_params(sd, cfg)


# --------------------------------------------------------------------------
# Adapter checkpoints of the PyTorch reference (text_adapter.pth,
# image_adapter_{N}.pth) -> the trainable dict
# --------------------------------------------------------------------------

def _clone(trainable):
    return tree_map(lambda t: t.detach().clone(), trainable)


def _put(slot, key, weight):
    """Replace ``slot[key]`` by the transposed torch Linear ``weight``, in
    the dtype and on the device of the tensor it replaces."""
    old = slot[key]
    slot[key] = torch.tensor(_t(_np(weight)), dtype=old.dtype, device=old.device)


def import_reference_text_adapter(sd, trainable):
    """A reference ``text_adapter`` state dict (an nn.ModuleList of
    SimpleAdapters, then a SimpleProj: keys ``{i}.fc.0.weight``) -> an
    updated copy of ``trainable``."""
    out = _clone(trainable)
    ta = out["text_adapter"]
    n = len(ta["layers"])
    for i in range(n):
        _put(ta["layers"][i], "w", sd[f"{i}.fc.0.weight"])
    _put(ta["proj"], "w", sd[f"{n}.fc.0.weight"])
    return out


def import_reference_image_adapter(sd, trainable, relu: bool = False):
    """A reference ``image_adapter`` state dict (the ModuleDict
    {layer_adapters, seg_proj, det_proj}) -> an updated copy of
    ``trainable``. A SimpleProj's Linear is ``fc.0`` with the LeakyReLU of
    ``--relu`` and ``fc`` without it."""
    out = _clone(trainable)
    ia = out["image_adapter"]
    for i, layer in enumerate(ia["layer_adapters"]):
        _put(layer, "w", sd[f"layer_adapters.{i}.fc.0.weight"])
    proj_key = "fc.0.weight" if relu else "fc.weight"
    for i, seg in enumerate(ia["seg_proj"]):
        _put(seg, "w", sd[f"seg_proj.{i}.{proj_key}"])
    _put(ia["det_proj"], "w", sd[f"det_proj.{proj_key}"])
    return out


def import_reference_checkpoints(save_path: str, trainable, relu: bool = False):
    """The reference's ``text_adapter.pth`` and its newest
    ``image_adapter_{N}.pth`` (by N) from a directory -> an updated copy of
    ``trainable``. The IQM family keeps its initialization: the reference
    never saves it."""
    import glob
    import re

    text = os.path.join(save_path, "text_adapter.pth")
    if os.path.isfile(text):
        ckpt = torch.load(text, map_location="cpu", weights_only=False)
        trainable = import_reference_text_adapter(ckpt["text_adapter"], trainable)
    images = glob.glob(os.path.join(save_path, "image_adapter_*.pth"))
    numbered = [(int(m.group(1)), p) for p in images
                if (m := re.search(r"_(\d+)\.pth$", p))]
    if numbered:
        ckpt = torch.load(max(numbered)[1], map_location="cpu", weights_only=False)
        trainable = import_reference_image_adapter(ckpt["image_adapter"],
                                                   trainable, relu=relu)
    return trainable


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

class _ShapesOnly:
    """Stands in for a numpy Generator where only the shapes count (weights
    on the meta device): each draw is a zero-stride array of zeros, so a
    ViT-L tree costs no memory."""

    def standard_normal(self, shape, dtype=np.float64):
        return np.broadcast_to(np.zeros((), dtype), shape)

    def uniform(self, low, high, size):
        return np.broadcast_to(np.zeros((), np.float32), size)


def _rng(seed: int, shapes_only: bool):
    return _ShapesOnly() if shapes_only else np.random.default_rng(seed)


def _normal(rng, shape, std):
    x = rng.standard_normal(shape, dtype=np.float32)
    return x if isinstance(rng, _ShapesOnly) else x * np.float32(std)


def _ln_init(n, dim):
    lead = (n,) if n else ()
    return {"scale": np.ones(lead + (dim,), np.float32),
            "bias": np.zeros(lead + (dim,), np.float32)}


def _blocks(rng, n, width, hidden):
    """n stacked pre-norm blocks, as models/clip.py:_init_block."""
    def lin(d_in, d_out):
        return {"w": _normal(rng, (n, d_in, d_out), d_in ** -0.5),
                "b": np.zeros((n, d_out), np.float32)}

    return {"ln_1": _ln_init(n, width),
            "attn": {"qkv": lin(width, 3 * width), "out": lin(width, width)},
            "ln_2": _ln_init(n, width),
            "mlp": {"c_fc": lin(width, hidden), "c_proj": lin(hidden, width)}}


def _eva_blocks(rng, n, width, hidden, postnorm):
    """n stacked EVA blocks (``models/clip.py``'s layouts): q and v biases,
    no k bias, a biased out-projection; EVA-02's attention sub-LN and SwiGLU
    MLP ([W1 | W2] packed, its sub-LN, W3), or the post-norm block's GELU
    MLP (``c_fc``, ``c_proj``)."""
    def lin(d_in, d_out, bias=True):
        p = {"w": _normal(rng, (n, d_in, d_out), d_in ** -0.5)}
        if bias:
            p["b"] = np.zeros((n, d_out), np.float32)
        return p

    attn = {"qkv": lin(width, 3 * width, bias=False),
            "q": {"b": np.zeros((n, width), np.float32)},
            "v": {"b": np.zeros((n, width), np.float32)}}
    if postnorm:
        attn["out"] = lin(width, width)
        mlp = {"c_fc": lin(width, hidden), "c_proj": lin(hidden, width)}
    else:
        attn.update(ln=_ln_init(n, width), out=lin(width, width))
        mlp = {"w12": lin(width, 2 * hidden), "ln": _ln_init(n, hidden),
               "w3": lin(hidden, width)}
    return {"ln_1": _ln_init(n, width), "attn": attn, "ln_2": _ln_init(n, width), "mlp": mlp}


def init_clip_params_np(cfg: ModelConfig, seed: int = 0, shapes_only: bool = False):
    """Random frozen CLIP params (JAX layout, numpy float32). With
    ``shapes_only`` every matrix is a zero-stride array of zeros (for
    :func:`params_from_jax` onto the meta device). An EVA or SigLIP vision
    tower takes its own layout, and so does a text tower with a biased head
    (``models/clip.py``)."""
    from ..configs import Eva02VisionConfig, ResNetVisionConfig, SiglipVisionConfig

    rng = _rng(seed, shapes_only)
    v, t = cfg.clip.vision, cfg.clip.text
    scale = v.width ** -0.5
    if isinstance(v, ResNetVisionConfig):
        visual = _resnet_np(rng, v)
    elif isinstance(v, SiglipVisionConfig):
        visual = _siglip_np(rng, v)
    elif isinstance(v, Eva02VisionConfig):
        visual = {
            "patch_embed": {"w": _normal(rng, (3 * v.patch_size ** 2, v.width), scale),
                            "b": np.zeros(v.width, np.float32)},
            "class_embedding": _normal(rng, (v.width,), scale),
            "positional_embedding": _normal(rng, (v.num_patches + 1, v.width), scale),
            "blocks": _eva_blocks(rng, v.layers, v.width, v.mlp_hidden, v.postnorm),
            "ln_post": _ln_init(0, v.width),
            "head": {"w": _normal(rng, (v.width, v.output_dim), scale),
                     "b": np.zeros(v.output_dim, np.float32)},
        }
    else:
        visual = {
            "patch_embed": {"w": _normal(rng, (3 * v.patch_size ** 2, v.width), scale)},
            "class_embedding": _normal(rng, (v.width,), scale),
            "positional_embedding": _normal(rng, (v.num_patches + 1, v.width), scale),
            "ln_pre": _ln_init(0, v.width),
            "blocks": _blocks(rng, v.layers, v.width, int(v.width * v.mlp_ratio)),
            "ln_post": _ln_init(0, v.width),
            "proj": _normal(rng, (v.width, v.output_dim), scale),
        }
    text = {
        "token_embedding": _normal(rng, (t.vocab_size, t.width), 0.02),
        "positional_embedding": _normal(rng, (t.context_length, t.width), 0.01),
        "blocks": _blocks(rng, t.layers, t.width, t.mlp_hidden),
        "ln_final": _ln_init(0, t.width),
    }
    proj = _normal(rng, (t.width, t.output_dim), t.width ** -0.5)
    if t.head_bias:
        text["head"] = {"w": proj, "b": np.zeros(t.output_dim, np.float32)}
    else:
        text["text_projection"] = proj
    return {"visual": visual, "text": text,
            "logit_scale": np.float32(math.log(1 / 0.07))}


def _siglip_np(rng, v):
    """A SigLIP vision tower (``models/clip.py``'s layout): a patch
    embedding with a bias, positional rows for the patches only, CLIP's
    blocks of hidden ``v.mlp_hidden``, ln_post, and the attention-pool head
    (its probe with timm's std width^-0.5, a packed in-projection and an
    out-projection with biases, its LayerNorm and MLP)."""
    scale = v.width ** -0.5

    def lin(d_in, d_out):
        return {"w": _normal(rng, (d_in, d_out), d_in ** -0.5),
                "b": np.zeros(d_out, np.float32)}

    return {
        "patch_embed": {"w": _normal(rng, (3 * v.patch_size ** 2, v.width), scale),
                        "b": np.zeros(v.width, np.float32)},
        "positional_embedding": _normal(rng, (v.num_patches, v.width), scale),
        "blocks": _blocks(rng, v.layers, v.width, v.mlp_hidden),
        "ln_post": _ln_init(0, v.width),
        "map": {"probe": {"w": _normal(rng, (1, v.width), scale)},
                "attn": {"qkv": lin(v.width, 3 * v.width), "out": lin(v.width, v.width)},
                "ln": _ln_init(0, v.width),
                "mlp": {"c_fc": lin(v.width, v.mlp_hidden), "c_proj": lin(v.mlp_hidden, v.width)}},
    }


def _resnet_np(rng, cfg):
    """A ModifiedResNet tower with the shapes of ``init_resnet_params``:
    conv kernels HWIO with std (fan_in)^-0.5, BatchNorm at identity
    statistics."""
    width, emb = cfg.width, cfg.final_channels

    def conv(cin, cout, k):
        return {"kernel": _normal(rng, (k, k, cin, cout), (cin * k * k) ** -0.5)}

    def bn(c):
        return {"scale": np.ones(c, np.float32), "bias": np.zeros(c, np.float32),
                "mean": np.zeros(c, np.float32), "var": np.ones(c, np.float32)}

    def lin(d_in, d_out):
        return {"w": _normal(rng, (d_in, d_out), 0.02), "b": np.zeros(d_out, np.float32)}

    p = {"conv1": conv(3, width // 2, 3), "bn1": bn(width // 2),
         "conv2": conv(width // 2, width // 2, 3), "bn2": bn(width // 2),
         "conv3": conv(width // 2, width, 3), "bn3": bn(width)}
    stages, cin = [], width
    for stage_idx, n_blocks in enumerate(cfg.layers):
        planes = width * 2 ** stage_idx
        blocks = []
        for block_idx in range(n_blocks):
            blk = {"conv1": conv(cin, planes, 1), "bn1": bn(planes),
                   "conv2": conv(planes, planes, 3), "bn2": bn(planes),
                   "conv3": conv(planes, planes * 4, 1), "bn3": bn(planes * 4)}
            if block_idx == 0 and (cin != planes * 4 or stage_idx > 0):
                blk["downsample"] = {"conv": conv(cin, planes * 4, 1), "bn": bn(planes * 4)}
            blocks.append(blk)
            cin = planes * 4
        stages.append(blocks)
    p["layers"] = stages
    p["attnpool"] = {"positional_embedding": _normal(rng, (cfg.grid ** 2 + 1, emb), emb ** -0.5),
                     "q": lin(emb, emb), "k": lin(emb, emb), "v": lin(emb, emb),
                     "c_proj": lin(emb, cfg.output_dim)}
    return p


def _xavier(rng, d_in, d_out, bias=True, n=0):
    a = math.sqrt(6.0 / (d_in + d_out))
    lead = (n,) if n else ()
    p = {"w": rng.uniform(-a, a, lead + (d_in, d_out)).astype(np.float32, copy=False)}
    if bias:
        bound = 1.0 / math.sqrt(d_in)
        p["b"] = rng.uniform(-bound, bound, lead + (d_out,)).astype(np.float32, copy=False)
    return p


def _iqm_np(rng, cfg):
    h = cfg.hidden_size

    def attention(kv_dim):
        return {"q": _xavier(rng, h, h), "k": _xavier(rng, kv_dim, h),
                "v": _xavier(rng, kv_dim, h), "out_dense": _xavier(rng, h, h),
                "out_ln": _ln_init(0, h)}

    layers = []
    for i in range(cfg.num_hidden_layers):
        layer = {"self": attention(h)}
        if i % cfg.cross_attention_frequency == 0:
            layer["cross"] = attention(cfg.encoder_hidden_size)
            layer["text_cross"] = attention(cfg.text_encoder_hidden_size)
        layer["ffn_q"] = {"intermediate": _xavier(rng, h, cfg.intermediate_size),
                          "output": _xavier(rng, cfg.intermediate_size, h),
                          "ln": _ln_init(0, h)}
        layers.append(layer)
    return {"layernorm": _ln_init(0, h), "layers": layers}


def init_adapter_params_np(cfg: ModelConfig, seed: int = 111, shapes_only: bool = False):
    """Random trainable params (JAX layout, numpy float32; xavier-uniform
    weights and torch-default uniform biases, as init_adapter_params);
    ``shapes_only`` as in :func:`init_clip_params_np`."""
    from ..configs import ResNetVisionConfig
    from .iqm import sinusoidal_positions

    if isinstance(cfg.clip.vision, ResNetVisionConfig):
        # AdaptedCLIP taps ViT blocks: an RN backbone serves encode_image and
        # the text tower only, as in the JAX package.
        raise ValueError(
            "AdaptedCLIP requires a ViT vision tower; ModifiedResNet "
            "configs support encode_image/encode_text only")
    rng = _rng(seed, shapes_only)
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
            # To the anchors' width, embed_dim. For the JAX registry's ViT
            # towers that is the text width, the JAX package's layout; RN50,
            # where the two differ, has no trainable layout (raised above).
            "proj": _xavier(rng, tw, out_dim, bias=False),
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
        "iqm_layer_norm": _ln_init(0, hidden),
    }
