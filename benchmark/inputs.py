"""Weights and inputs, made on the device from the run's seed.

The weights take the program's parameter-dict layout and dtypes (matrices
in the compute dtype, the rest float32), read from the program's own tree of
shapes on the meta device, and are drawn in one ``randn`` call of a
``torch.Generator`` on the device, then scaled leaf by leaf as the
configuration file's ``assumed`` says. The vision tower's positional
embedding is made at the checkpoint's native grid (336 px); the program's
set-up resizes it. The same tensors go to the program and to the
reference.

Images are smooth random fields with a little noise (bicubic upsampling of
an 8 x 8 random grid), so that a PNG of one compresses as a photograph of a
part does; half of a training pool carries a darkened elliptical defect and
its mask.
"""
from __future__ import annotations

import json
import os

import torch
import torch.nn.functional as F

HERE = os.path.dirname(os.path.abspath(__file__))

LN_KEYS = ("ln_1", "ln_2", "ln_pre", "ln_post", "ln_final", "layernorm", "out_ln", "ln",
           "iqm_layer_norm")


def load_json(kind: str, name: str) -> dict:
    """``benchmark/<kind>/<name>.json``."""
    with open(os.path.join(HERE, kind, f"{name}.json")) as f:
        return json.load(f)


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (2 ** 63))
    return g


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tree


def _rebuild(tree, made, path=()):
    if isinstance(tree, dict):
        return {k: _rebuild(v, made, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_rebuild(v, made, path + (i,)) for i, v in enumerate(tree)]
    return made[path]


def _rule(path, shape):
    """(mean, std) of a leaf, by its key (the configuration's ``assumed``)."""
    key = path[-1]
    parent = next((p for p in reversed(path[:-1]) if isinstance(p, str)), "")
    top = path[0]
    if parent in LN_KEYS and key in ("scale", "bias"):
        return (1.0 if key == "scale" else 0.0), 0.02
    if key == "b":
        return 0.0, 0.02
    if key in ("w", "proj", "text_projection"):
        return 0.0, shape[0] ** -0.5
    if key in ("class_embedding",) or (top == "visual" and key == "positional_embedding"):
        return 0.0, shape[-1] ** -0.5
    if key == "token_embedding":
        return 0.0, 0.02
    if key == "positional_embedding":
        return 0.0, 0.01
    if key == "pos_embedding":
        return 0.0, 0.5
    raise KeyError(f"no rule for the leaf {'/'.join(map(str, path))}")


def fill(shapes, seed: int, device):
    """A tree like ``shapes`` (tensors on the meta device) with its leaves
    drawn on ``device`` from ``seed``, each in its dtype."""
    leaves = list(_leaves(shapes))
    total = sum(t.numel() for _, t in leaves)
    flat = torch.randn(total, generator=generator(seed, device), device=device)
    made, at = {}, 0
    for path, t in leaves:
        mean, std = _rule(path, t.shape)
        x = flat[at:at + t.numel()].view(t.shape)
        made[path] = (x * std + mean).to(t.dtype)
        at += t.numel()
    del flat
    return _rebuild(shapes, made)


def images_u8(gen, n: int, size: int, device) -> torch.Tensor:
    """(n, 3, size, size) uint8 smooth random images."""
    low = torch.rand((n, 3, 8, 8), generator=gen, device=device) * 255.0
    img = F.interpolate(low, size=(size, size), mode="bicubic", align_corners=False)
    img = img + torch.randn(img.shape, generator=gen, device=device) * 6.0
    return img.clamp(0, 255).round().to(torch.uint8)


def blob_masks(gen, n: int, size: int, device) -> torch.Tensor:
    """(n, 1, size, size) float32 masks, an ellipse on every other image
    (odd rows), none on the rest."""
    yy, xx = torch.meshgrid(torch.arange(size, device=device, dtype=torch.float32),
                            torch.arange(size, device=device, dtype=torch.float32),
                            indexing="ij")
    u = torch.rand((n, 4), generator=gen, device=device)
    cx, cy = 0.2 * size + 0.6 * size * u[:, 0], 0.2 * size + 0.6 * size * u[:, 1]
    rx, ry = size * (0.03 + 0.1 * u[:, 2]), size * (0.03 + 0.1 * u[:, 3])
    inside = (((xx - cx[:, None, None]) / rx[:, None, None]) ** 2
              + ((yy - cy[:, None, None]) / ry[:, None, None]) ** 2) <= 1.0
    has = (torch.arange(n, device=device) % 2 == 1)[:, None, None]
    return (inside & has).float()[:, None]
