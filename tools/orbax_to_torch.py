#!/usr/bin/env python
"""Convert a JAX ``cli.train`` save path (orbax) into the PyTorch port's
checkpoint layout (``checkpoint.pt`` files), so that a model trained with
``aa_clip_iqm_tpu`` on a TPU is served, evaluated or trained further with
``aa_clip_iqm_tpu_torch`` on a GPU.

    python tools/orbax_to_torch.py --save_path ckpt/jax_run --out ckpt/torch_run \\
        [--model_name ViT-L-14-336 --img_size 518] [the model flags of the run] \\
        [--image_lr 5e-4 --total_steps N]

It is a bridge, like the tests: the only file outside ``tests/`` that
imports both packages. It lives outside both because the port may not
import JAX or orbax; run it where JAX and orbax are installed (the machine
with the card has neither).

What it reads, through ``aa_clip_iqm_tpu/train/checkpoint.py``: the stage-1
text adapter (``text_adapter/``), the stage-2 resume point
(``image_adapter/``), every per-epoch ``image_adapter_{N}/`` and the
mid-epoch step checkpoints (``{text,image}_adapter_step/``). The restore
templates are the JAX package's ``loader.init_trainable`` and its
``train/optim.py`` optimizers for the model that the flags describe (the
flags of ``cli.evaluate``: the model, the ``--relu`` head, the adapt weights
and depths, the IQM sizes).

What it writes, through ``aa_clip_iqm_tpu_torch/train/checkpoint.py``
(``save_stage1``, ``save_stage2``, ``save_step``): the same directories.
The parameters always convert (``models/convert.params_from_jax``), bit for
bit in float32. Where a checkpoint holds optimizer state, optax's Adam /
AdamW state (``count``, ``mu``, ``nu``; stage 2 per label of its
``multi_transform``) becomes torch Adam / AdamW's ``step``, ``exp_avg`` and
``exp_avg_sq``, and stage 2's ``LambdaLR`` is put at ``count``: the
numerics agree, as ``aa_clip_iqm_tpu_torch/train/optim.py`` states. The
learning rate the first resumed step takes comes from the schedule, so pass
the run's ``--text_lr``, ``--image_lr``, ``--iqm_lr_scale`` and
``--total_steps`` (stage 2's optimizer steps over all epochs).
"""
from __future__ import annotations

import argparse
import os
import sys
import warnings

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def build_parser():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--save_path", type=str, required=True,
                   help="the JAX cli.train save dir (orbax)")
    p.add_argument("--out", type=str, required=True, help="the port's save dir to write")
    p.add_argument("--model_name", type=str, default="ViT-L-14-336")
    p.add_argument("--img_size", type=int, default=518)
    p.add_argument("--relu", action="store_true")
    p.add_argument("--text_adapt_weight", type=float, default=0.1)
    p.add_argument("--image_adapt_weight", type=float, default=0.1)
    p.add_argument("--text_adapt_until", type=int, default=3)
    p.add_argument("--image_adapt_until", type=int, default=6)
    p.add_argument("--iqm_hidden_size", type=int, default=512)
    p.add_argument("--iqm_num_layers", type=int, default=2)
    p.add_argument("--iqm_num_heads", type=int, default=8)
    p.add_argument("--text_lr", type=float, default=1e-5)
    p.add_argument("--image_lr", type=float, default=5e-4)
    p.add_argument("--iqm_lr_scale", type=float, default=0.1)
    p.add_argument("--image_weight_decay", type=float, default=1e-4)
    p.add_argument("--iqm_weight_decay", type=float, default=1e-3)
    p.add_argument("--total_steps", type=int, default=1,
                   help="stage 2's optimizer steps over the whole run")
    p.add_argument("--torch_lr_quirk_period", type=int, default=None,
                   help="the run's image_epoch, if it trained with torch_lr_quirk")
    return p


def model_kwargs(args) -> dict:
    return dict(model_name=args.model_name, img_size=args.img_size, relu=args.relu,
                text_adapt_weight=args.text_adapt_weight,
                image_adapt_weight=args.image_adapt_weight,
                text_adapt_until=args.text_adapt_until,
                image_adapt_until=args.image_adapt_until,
                iqm_hidden_size=args.iqm_hidden_size, iqm_num_layers=args.iqm_num_layers,
                iqm_num_heads=args.iqm_num_heads)


def _adam_state(state):
    """The ScaleByAdamState inside an optax chain's (possibly masked) state."""
    import optax

    if isinstance(state, optax.ScaleByAdamState):
        return state
    if isinstance(state, optax.MaskedState):
        return _adam_state(state.inner_state)
    if isinstance(state, tuple):
        for part in state:
            found = _adam_state(part)
            if found is not None:
                return found
    return None


class Converter:
    """The two packages' templates for one model, and the tree and
    optimizer conversions between them."""

    def __init__(self, args):
        import jax
        import numpy as np
        import torch

        from aa_clip_iqm_tpu import loader as jloader
        from aa_clip_iqm_tpu.train import optim as joptim
        from aa_clip_iqm_tpu_torch import loader as tloader

        self.args = args
        self.jcfg = jloader.build_model_config(**model_kwargs(args))
        self.tcfg = tloader.build_model_config(**model_kwargs(args))
        self.template = jax.tree.map(np.asarray, jloader.init_trainable(self.jcfg))
        self.stage1_tx = joptim.stage1_optimizer(args.text_lr)
        self.stage2_tx = joptim.stage2_optimizer(
            self.template, args.image_lr, max(args.total_steps, 1),
            iqm_lr_scale=args.iqm_lr_scale, image_wd=args.image_weight_decay,
            iqm_wd=args.iqm_weight_decay,
            torch_quirk_period_steps=args.torch_lr_quirk_period)
        # stage 2's label of each top-level group ('image', 'iqm', 'frozen').
        self.labels = {k: next(iter(jax.tree.leaves(v)))
                       for k, v in joptim.stage2_param_labels(self.template).items()}
        self._torch = torch

    # -- trees ----------------------------------------------------------
    def to_port(self, tree_np, group=None):
        """A JAX-layout trainable tree (or its ``group`` subtree) -> the
        port's layout, float32 tensors on the CPU, in the key order of the
        port's own ``init_trainable``: torch's optimizer state pairs its
        entries with the parameters by position, so every tree the converter
        writes takes the order the port's trainer builds."""
        import jax
        import numpy as np

        from aa_clip_iqm_tpu_torch import loader as tloader
        from aa_clip_iqm_tpu_torch.models.convert import params_from_jax, tree_map

        if group is not None:
            tree_np = {**self.template, group: tree_np}
        tree_np = jax.tree.map(np.asarray, tree_np)
        _, ported = params_from_jax(None, tree_np, self.tcfg, device="cpu",
                                    dtype=self._torch.float32)
        out = tloader.init_trainable(self.tcfg, device="cpu", dtype=self._torch.float32)
        with self._torch.no_grad():
            tree_map(lambda dst, src: dst.copy_(src), out, ported)     # by key
        return out if group is None else out[group]

    def port_trainable(self, tree_np, group=None):
        """:meth:`to_port` as leaf tensors that require grad (what the
        port's optimizers hold)."""
        from aa_clip_iqm_tpu_torch.models.convert import tree_leaves

        tree = self.to_port(tree_np, group)
        for t in tree_leaves(tree):
            t.requires_grad_(True)
        return tree

    # -- optimizer state --------------------------------------------------
    def _fill(self, optimizer, params, mu, nu, count):
        torch = self._torch
        for p, m, v in zip(params, mu, nu):
            optimizer.state[p] = {"step": torch.tensor(float(count)),
                                  "exp_avg": m.clone(), "exp_avg_sq": v.clone()}

    def stage1_opt(self, text_params, opt_state):
        """optax Adam state over the text adapter -> the port's stage-1
        OptState over ``text_params`` (the port's layout)."""
        from aa_clip_iqm_tpu_torch.models.convert import tree_leaves
        from aa_clip_iqm_tpu_torch.train import optim as toptim

        adam = _adam_state(opt_state)
        opt = toptim.stage1_optimizer(text_params, self.args.text_lr)
        mu = self.to_port(adam.mu, "text_adapter")
        nu = self.to_port(adam.nu, "text_adapter")
        self._fill(opt.optimizer, list(tree_leaves(text_params)), list(tree_leaves(mu)),
                   list(tree_leaves(nu)), int(adam.count))
        return opt

    def stage2_opt(self, trainable, opt_state):
        """optax's multi_transform state (AdamW per label, the 'frozen'
        label zeroed) -> the port's stage-2 OptState over ``trainable``
        (the port's layout), its LambdaLR at the optimizer's step count."""
        import jax
        import numpy as np

        from aa_clip_iqm_tpu_torch.train import optim as toptim

        args = self.args
        opt = toptim.stage2_optimizer(
            trainable, args.image_lr, max(args.total_steps, 1),
            iqm_lr_scale=args.iqm_lr_scale, image_wd=args.image_weight_decay,
            iqm_wd=args.iqm_weight_decay, torch_quirk_period_steps=args.torch_lr_quirk_period)
        count = 0
        for label in ("image", "iqm"):
            adam = _adam_state(opt_state.inner_states[label])
            # Each label's moments are masked to its own groups: the other
            # groups are filled with zeros, which the port's optimizer skips.
            full = {}
            for which in ("mu", "nu"):
                moments = getattr(adam, which)
                full[which] = self.to_port({
                    k: (moments[k] if self.labels[k] == label
                        else jax.tree.map(np.zeros_like, self.template[k]))
                    for k in self.template})
            self._fill(opt.optimizer, toptim._labelled(trainable, label),
                       toptim._labelled(full["mu"], label),
                       toptim._labelled(full["nu"], label), int(adam.count))
            count = int(adam.count)
        with warnings.catch_warnings():   # the schedule moves without optimizer steps here
            warnings.simplefilter("ignore")
            for _ in range(count):
                opt.scheduler.step()
        return opt


def convert(args, log=print) -> dict:
    """Convert every checkpoint under ``args.save_path`` into ``args.out``.
    Returns what was written: {directory name: has optimizer state}."""
    import re

    from aa_clip_iqm_tpu.train import checkpoint as jckpt
    from aa_clip_iqm_tpu_torch.train import checkpoint as tckpt

    conv = Converter(args)
    template = conv.template
    written = {}
    os.makedirs(args.out, exist_ok=True)

    # Stage 1: the text adapter and, where saved, its Adam state.
    s1 = jckpt.load_stage1(args.save_path, template["text_adapter"],
                           conv.stage1_tx.init(template["text_adapter"]))
    if s1 is not None:
        text = conv.port_trainable(s1["params"], "text_adapter")
        opt = None if s1["opt_state"] is None else conv.stage1_opt(text, s1["opt_state"])
        tckpt.save_stage1(args.out, s1["epoch"], text, opt)
        written["text_adapter"] = opt is not None

    # Stage 2: every per-epoch image_adapter_{N} (params only), then the
    # resume point with its AdamW state.
    numbered = sorted(int(m.group(1)) for m in (re.fullmatch(r"image_adapter_(\d+)", n)
                                                for n in os.listdir(args.save_path)) if m)
    for n in numbered:
        got = jckpt._load_pair(os.path.join(args.save_path, f"image_adapter_{n}"),
                               template, None)
        tckpt.save_stage2(args.out, got["epoch"], conv.port_trainable(got["params"]), None)
        written[f"image_adapter_{n}"] = False
    s2 = jckpt.load_stage2(args.save_path, template, conv.stage2_tx.init(template))
    if s2 is not None:
        trainable = conv.port_trainable(s2["params"])
        opt = None if s2["opt_state"] is None else conv.stage2_opt(trainable, s2["opt_state"])
        tckpt.save_stage2(args.out, s2["epoch"], trainable, opt)
        written["image_adapter"] = opt is not None

    # The mid-epoch step checkpoints (their optimizer state is mandatory).
    for stage in ("stage1", "stage2"):
        if stage == "stage1":
            params_t, opt_t = template["text_adapter"], conv.stage1_tx.init(
                template["text_adapter"])
        else:
            params_t, opt_t = template, conv.stage2_tx.init(template)
        got = jckpt.load_step(args.save_path, stage, params_t, opt_t)
        if got is None:
            continue
        if stage == "stage1":
            params = conv.port_trainable(got["params"], "text_adapter")
            opt = conv.stage1_opt(params, got["opt_state"])
        else:
            params = conv.port_trainable(got["params"])
            opt = conv.stage2_opt(params, got["opt_state"])
        tckpt.save_step(args.out, stage, got["epoch"], got["step"], params, opt)
        written[os.path.basename(tckpt._step_dir(args.out, stage))] = True
    for name, with_opt in written.items():
        log(f"{name}: params{' and optimizer state' if with_opt else ''}")
    if not written:
        raise FileNotFoundError(f"no checkpoint under {args.save_path}")
    return written


def main(argv=None):
    from aa_clip_iqm_tpu.platform import apply_platform_override

    apply_platform_override()
    args = build_parser().parse_args(argv)
    convert(args)
    print(f"converted {args.save_path} -> {args.out}")


if __name__ == "__main__":
    main()
