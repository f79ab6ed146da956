"""The ranks of the port's multi-process CPU runs (gloo), for
tests/test_torch_parallel.py. Imports torch and the port only: each rank is
a spawned process that joins a process group through a FileStore, runs one
job on the tiny config and pickles its results for the test process, which
holds them against JAX and against the port in one process.

    start(job, world, workdir, inputs) -> handle   (returns at once)
    finish(handle, timeout)            -> [result of rank 0, 1, ...]
    stop(handle)                       kills and joins what is left
"""
from __future__ import annotations

import dataclasses
import os
import pickle
import traceback

import numpy as np

IMG = 56


def start(job: str, world: int, workdir, inputs: str):
    import multiprocessing as mp

    os.makedirs(workdir, exist_ok=True)
    ctx = mp.get_context("spawn")
    procs = []
    for rank in range(world):
        p = ctx.Process(target=_entry, args=(job, rank, world, str(workdir), inputs),
                        daemon=True)
        p.start()
        procs.append(p)
    return job, world, str(workdir), procs


def finish(handle, timeout: float):
    import time

    job, world, workdir, procs = handle
    deadline = time.monotonic() + timeout
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    errors = []
    for rank, p in enumerate(procs):
        err = os.path.join(workdir, f"rank{rank}.err")
        if os.path.exists(err):
            with open(err) as f:
                errors.append(f"rank {rank}:\n{f.read()}")
        elif p.is_alive():
            errors.append(f"rank {rank} still running after {timeout} s")
        elif p.exitcode != 0:
            errors.append(f"rank {rank} exited {p.exitcode}")
    if errors:
        raise RuntimeError(f"{job} ({world} ranks) failed:\n" + "\n".join(errors))
    out = []
    for rank in range(world):
        with open(os.path.join(workdir, f"rank{rank}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


def stop(handle):
    _, _, _, procs = handle
    for p in procs:
        if p.is_alive():
            p.kill()
        p.join(10)


def _entry(job, rank, world, workdir, inputs):
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    try:
        store = dist.FileStore(os.path.join(workdir, "store"), world)
        dist.init_process_group("gloo", store=store, rank=rank, world_size=world)
        try:
            with open(inputs, "rb") as f:
                inp = pickle.load(f)
            result = JOBS[job](rank, inp, workdir)
            dist.barrier()
        finally:
            dist.destroy_process_group()
        with open(os.path.join(workdir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(result, f)
    except BaseException:
        with open(os.path.join(workdir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


# ----------------------------------------------------------------------
# Shared by the ranks and the test process
# ----------------------------------------------------------------------

def port_params(inp, requires_grad=True):
    import torch

    from aa_clip_iqm_tpu_torch import configs
    from aa_clip_iqm_tpu_torch.models.convert import params_from_jax, tree_leaves

    tf, tt = params_from_jax(inp["frozen"], inp["trainable"], configs.tiny_test_config(IMG),
                             device="cpu", dtype=torch.float32)
    for t in tree_leaves(tt or {}):
        t.requires_grad_(requires_grad)
    return tf, tt


def model_config(drop: float = 0.0):
    from aa_clip_iqm_tpu_torch import configs

    cfg = configs.tiny_test_config(IMG)
    if drop:
        cfg = dataclasses.replace(cfg, clip=dataclasses.replace(
            cfg.clip, vision=dataclasses.replace(cfg.clip.vision, patch_dropout=drop)))
    return cfg


#: Stage-2 cases: (name, valid rows of the 8, grad_accum_steps, patch dropout).
STAGE2_CASES = (("full", 8, 1, 0.0), ("padded", 7, 1, 0.0), ("accum 2", 7, 2, 0.0),
                ("patch dropout", 7, 1, 0.25))


def stage2_step(inp, case, mesh=None, frozen_sharding=None, rows=None):
    """One stage-2 step of ``case`` on fresh parameters, on the given rows of
    the global batch (all of it by default). Returns (loss, det_proj.w after
    the step, the flattened gradients)."""
    import torch

    from aa_clip_iqm_tpu_torch import configs
    from aa_clip_iqm_tpu_torch.models.convert import tree_leaves
    from aa_clip_iqm_tpu_torch.train import optim, steps

    name, valid, accum, drop = case
    tf, tt = port_params(inp)
    train_cfg = configs.TrainConfig(img_size=IMG, compute_dtype="float32",
                                    grad_accum_steps=accum)
    opt = optim.stage2_optimizer(tt, train_cfg.image_lr, 10)
    step = steps.make_stage2_step(model_config(drop), train_cfg, mesh=mesh,
                                  frozen_sharding=frozen_sharding)
    weights = (np.arange(8) < valid).astype(np.float32)
    lo, hi = rows or (0, 8)
    args = [torch.from_numpy(np.ascontiguousarray(a[lo:hi]))
            for a in (*inp["batch"], weights)]
    rng = torch.Generator().manual_seed(5) if drop else None
    _, _, loss = step(tt, opt, tf, *args, rng)
    grads = torch.cat([t.grad.reshape(-1) for t in tree_leaves(tt) if t.grad is not None])
    return (loss.item(), tt["image_adapter"]["det_proj"]["w"].detach().numpy().copy(),
            grads.numpy().copy())


def stage1_step(inp, mesh=None, rows=None):
    """One stage-1 step (features, then the text adapter's step) with a
    padded row. Returns (loss, the text adapter's leaves after it)."""
    import torch

    from aa_clip_iqm_tpu_torch import configs
    from aa_clip_iqm_tpu_torch.models.convert import tree_leaves
    from aa_clip_iqm_tpu_torch.prompts import batched_prompt_tokens
    from aa_clip_iqm_tpu_torch.train import optim, steps

    cfg = model_config()
    tf, tt = port_params(inp)
    train_cfg = configs.TrainConfig(dataset="MVTec", img_size=IMG, compute_dtype="float32")
    classes, tokens, n_norm, n_abn = batched_prompt_tokens("MVTec")
    images, masks, _, _ = inp["batch"]
    class_idx = np.array([0, 7, 14, 3, 3, 9, 1, 14], np.int64)
    weights = (np.arange(8) < 7).astype(np.float32)
    lo, hi = rows or (0, 8)
    feats = steps.make_stage1_visual_fn(cfg, mesh=mesh)(
        tf, torch.from_numpy(images[lo:hi]))
    opt = optim.stage1_optimizer(tt["text_adapter"], train_cfg.text_lr)
    step = steps.make_stage1_step(cfg, train_cfg, torch.from_numpy(np.asarray(tokens, np.int64)),
                                  len(classes), n_norm, n_abn, mesh=mesh)
    params, _, loss = step(tt["text_adapter"], opt, tf, feats,
                           torch.from_numpy(masks[lo:hi]), torch.from_numpy(class_idx[lo:hi]),
                           torch.from_numpy(weights[lo:hi]))
    return loss.item(), [t.detach().numpy().copy() for t in tree_leaves(params)]


def predict(inp, mode, mesh=None, frozen=None):
    """(maps, image logits) of the global batch."""
    import torch

    from aa_clip_iqm_tpu_torch.evaluation.predict import make_predict_fn

    tf, tt = port_params(inp, requires_grad=False)
    fn = make_predict_fn(model_config(), IMG, "Industrial", image_score_mode=mode, mesh=mesh)
    maps, logits = fn(tf if frozen is None else frozen, tt,
                      torch.from_numpy(inp["batch"][0]), torch.from_numpy(inp["anchors"]))
    return maps.numpy().copy(), logits.numpy().copy()


def evaluate(inp, mesh=None):
    """evaluate_dataset's rows over the synthetic dataset at batch 4 (each
    class's tail padded)."""
    from aa_clip_iqm_tpu_torch import configs
    from aa_clip_iqm_tpu_torch.data import datasets, synthetic
    from aa_clip_iqm_tpu_torch.evaluation.predict import evaluate_dataset
    from aa_clip_iqm_tpu_torch.prompts import compute_frozen_anchors

    synthetic.register_synthetic(inp["data_root"], inp["classes"])
    tf, tt = port_params(inp, requires_grad=False)
    cfg = model_config()
    anchors = compute_frozen_anchors(tf, tt, cfg, "Synth", adapted=False)
    sets = datasets.get_dataset("Synth", IMG, None, -1, "test",
                                metadata_root=inp["meta_root"], device_normalize=True)
    ecfg = configs.EvalConfig(dataset="Synth", img_size=IMG, batch_size=4)
    return evaluate_dataset(tf, tt, cfg, ecfg, sets, anchors, mesh=mesh)


def train(inp, save_path, mesh=None):
    """run_training over the synthetic dataset (stage 1 and 2, one epoch
    each, tails padded, --grad_accum 2). Returns the trained leaves."""
    import logging

    from aa_clip_iqm_tpu_torch import configs
    from aa_clip_iqm_tpu_torch.data import synthetic
    from aa_clip_iqm_tpu_torch.models.convert import tree_leaves
    from aa_clip_iqm_tpu_torch.train.driver import run_training

    synthetic.register_synthetic(inp["data_root"], inp["classes"])
    tf, tt = port_params(inp)
    train_cfg = configs.TrainConfig(
        dataset="Synth", img_size=IMG, training_mode="full_shot", text_epoch=1,
        image_epoch=1, text_batch_size=8, image_batch_size=8, grad_accum_steps=2,
        compute_dtype="float32", save_path=save_path, seed=7)
    logger = logging.getLogger("torch_parallel_worker")
    trained, _ = run_training(tf, tt, model_config(), train_cfg, logger,
                              metadata_root=inp["meta_root"], mesh=mesh)
    return [t.detach().numpy().copy() for t in tree_leaves(trained)]


# ----------------------------------------------------------------------
# Jobs, one per run
# ----------------------------------------------------------------------

def _mean_of_means(inp, case, mesh, rows):
    """The planted fault: DDP's mean of the ranks' own mean-loss gradients."""
    import torch
    import torch.distributed as dist

    _, _, grads = stage2_step(inp, case, rows=rows)
    g = torch.from_numpy(grads)
    dist.all_reduce(g, group=mesh.data_group)
    return (g / mesh.data_size).numpy()


def job_dp(rank, inp, workdir):
    """2 ranks on the data axis."""
    import torch

    from aa_clip_iqm_tpu_torch.parallel.mesh import make_mesh, replicate
    from aa_clip_iqm_tpu_torch.parallel.multihost import process_local_rows

    mesh = make_mesh()
    rows = process_local_rows(mesh, 8)
    out = {"rows": rows, "shape": mesh.shape, "data_size": mesh.data_size}
    out["stage2"] = {c[0]: stage2_step(inp, c, mesh=mesh, rows=rows) for c in STAGE2_CASES}
    out["mean_of_means"] = _mean_of_means(inp, STAGE2_CASES[1], mesh, rows)
    out["stage1"] = stage1_step(inp, mesh=mesh, rows=rows)
    tree = {"a": torch.full((3,), float(rank)), "b": [torch.full((2, 2), 5.0 + rank)]}
    replicate(mesh, tree)
    out["replicated"] = [tree["a"].numpy().copy(), tree["b"][0].numpy().copy()]
    out["predict"] = {m: predict(inp, m, mesh=mesh) for m in ("fixed", "reference_eval")}
    out["eval"] = evaluate(inp, mesh=mesh)
    save_path = os.path.join(workdir, f"ckpt_rank{rank}")
    out["train"] = train(inp, save_path, mesh=mesh)
    out["wrote"] = sorted(os.listdir(save_path)) if os.path.isdir(save_path) else []
    return out


def job_tp(rank, inp, workdir):
    """2 ranks on the model axis: the backbone split Megatron-wise."""
    from aa_clip_iqm_tpu_torch.parallel.mesh import make_mesh, shard_backbone

    mesh = make_mesh(n_data=1, n_model=2)
    tf, _ = port_params(inp, requires_grad=False)
    shard = shard_backbone(mesh, tf, model_config().clip)
    block = shard["visual"]["blocks"][0]
    shapes = {f"{a}.{b}.{k}": tuple(block[a][b][k].shape)
              for a, b in (("attn", "qkv"), ("attn", "out"), ("mlp", "c_fc"), ("mlp", "c_proj"))
              for k in ("w", "b")}
    qkv = block["attn"]["qkv"]["w"].numpy().copy()
    return {"shapes": shapes, "qkv": qkv, "model_index": mesh.coords()["model"],
            "predict": predict(inp, "fixed", mesh=mesh, frozen=shard)}


def job_ms(rank, inp, workdir):
    """4 ranks on a (replica 2, data 1, model 2) mesh: the stage-2 step with
    the backbone split by frozen_sharding, on the rank's rows."""
    from aa_clip_iqm_tpu_torch.parallel.mesh import (
        backbone_param_sharding,
        make_multislice_mesh,
    )
    from aa_clip_iqm_tpu_torch.parallel.multihost import process_local_rows

    mesh = make_multislice_mesh(2, n_data=1, n_model=2)
    rows = process_local_rows(mesh, 8)
    tf, _ = port_params(inp, requires_grad=False)
    sharding = backbone_param_sharding(mesh, tf)
    return {"rows": rows, "coords": mesh.coords(),
            "stage2": stage2_step(inp, STAGE2_CASES[1], mesh=mesh, frozen_sharding=sharding,
                                  rows=rows)}


JOBS = {"dp": job_dp, "tp": job_tp, "ms": job_ms}
