"""The port's captured programs (train/graphs.py) and graphable optimizers.

On the CPU (tiny_test_config(56), float32): a graphable optimizer's tensor
learning rates give the float rates' updates bit for bit, and JAX's optax
updates within 1e-6 (the tolerance of tests/test_torch_optim.py), in both
stages, and its state loads into either form; a stage-2 step fed pre-drawn
kept-token indices equals one given the generator, bit for bit;
``state_restored`` (the warm-up's snapshot and restore) leaves the adapters
and the optimizer state bit-equal, so that the next step is the undisturbed
optimizer's; on the CPU, and under NaN checks, nothing is captured.

Marked ``cuda`` (skipped without a card): graph replays against the eager
steps and sweep on a small model whose heads are 64 wide (so that the
kernels run). On a machine with a card and nvcc:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_train_graphs.py -q

(the CPU cases import JAX, which that machine need not have, inside the test).
"""
import copy
import logging
from dataclasses import replace

import numpy as np
import pytest
import torch

from aa_clip_iqm_tpu_torch import configs as tconfigs
from aa_clip_iqm_tpu_torch.loader import init_trainable, random_backbone
from aa_clip_iqm_tpu_torch.models import clip as clip_mod
from aa_clip_iqm_tpu_torch.models.convert import tree_leaves
from aa_clip_iqm_tpu_torch.train import graphs, optim, steps
from aa_clip_iqm_tpu_torch.utils.profiling import enable_nan_checks

IMG = 56
LOGGER = logging.getLogger("test_torch_train_graphs")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    torch.set_num_threads(1)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# --------------------------------------------------------------------------
# The optimizers: tensor learning rates
# --------------------------------------------------------------------------

def _jax_trainables(seed=1):
    import jax

    from aa_clip_iqm_tpu.configs import tiny_test_config
    from aa_clip_iqm_tpu.models import adapters as jadapters
    from aa_clip_iqm_tpu_torch.models.convert import params_from_jax

    jt = jadapters.init_adapter_params(jax.random.PRNGKey(seed), tiny_test_config(IMG))
    _, tt = params_from_jax(None, jax.tree.map(np.asarray, jt),
                            tconfigs.tiny_test_config(IMG), device="cpu",
                            dtype=torch.float32)
    return jt, tt


def _fake_grads(jt, step):
    """Seeded gradients as a JAX tree, as tests/test_torch_optim.py makes them."""
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(100 + step)
    return jax.tree.map(
        lambda p: jnp.asarray(rng.standard_normal(p.shape).astype(np.float32)), jt)


def _set_grads(tt, jgrads):
    """The JAX tree's gradients on the port's tree (through the converter)."""
    import jax

    from aa_clip_iqm_tpu_torch.models.convert import params_from_jax

    _, tg = params_from_jax(None, jax.tree.map(np.asarray, jgrads),
                            tconfigs.tiny_test_config(IMG), device="cpu",
                            dtype=torch.float32)
    for p, g in zip(tree_leaves(tt), tree_leaves(tg)):
        p.grad = g


@pytest.mark.parametrize("stage", [1, 2])
def test_tensor_lr_is_bit_for_bit_the_float_lr_and_matches_optax(stage):
    """Three steps of the stage's optimizer built graphable (tensor learning
    rates, filled in place by the schedule) and not: the same bits, the same
    rate each step, and JAX's optax parameters within 1e-6."""
    import jax
    import optax

    from aa_clip_iqm_tpu.train import optim as joptim
    from aa_clip_iqm_tpu_torch.models.convert import params_to_jax

    jt, t_float = _jax_trainables()
    _, t_tensor = _jax_trainables()
    if stage == 1:
        def make(tt, graphable):
            return optim.stage1_optimizer(tt["text_adapter"], 1e-5, graphable=graphable)

        tx, jp = joptim.stage1_optimizer(1e-5), jt["text_adapter"]
    else:
        def make(tt, graphable):
            return optim.stage2_optimizer(tt, 5e-4, 6, graphable=graphable)

        tx, jp = joptim.stage2_optimizer(jt, 5e-4, 6), jt
    o_float, o_tensor = make(t_float, False), make(t_tensor, True)
    assert o_tensor.graphable and not o_float.graphable
    for group in o_tensor.optimizer.param_groups:
        assert isinstance(group["lr"], torch.Tensor) and group["lr"].dtype == torch.float64
        assert not group["capturable"]     # refused on the CPU
    jstate = tx.init(jp)
    for step in range(3):
        jgrads = _fake_grads(jt, step)
        _set_grads(t_float, jgrads)
        _set_grads(t_tensor, jgrads)
        if stage == 1:
            jgrads = jgrads["text_adapter"]
        updates, jstate = tx.update(jgrads, jstate, jp)
        jp = optax.apply_updates(jp, updates)
        o_float.step()
        o_tensor.step()
        for gf, gt in zip(o_float.optimizer.param_groups, o_tensor.optimizer.param_groups):
            assert gt["lr"].item() == gf["lr"]
    for a, b in zip(tree_leaves(t_float), tree_leaves(t_tensor)):
        assert torch.equal(a, b)
    got = params_to_jax(t_tensor)
    if stage == 1:
        got = got["text_adapter"]
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(jax.tree.map(np.asarray, jp))):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("saved_graphable", [False, True])
def test_state_loads_into_either_form(saved_graphable):
    """A state saved by one form of the stage-2 optimizer and loaded into the
    other (as a checkpoint of a CPU run resumed on the card, or back): the
    loading optimizer keeps its own form, counts the load in ``version``,
    and its next step is the saving optimizer's, bit for bit."""
    jt, ta = _jax_trainables()
    _, tb = _jax_trainables()
    a = optim.stage2_optimizer(ta, 5e-4, 6, graphable=saved_graphable)
    for step in range(2):
        _set_grads(ta, _fake_grads(jt, step))
        a.step()
    b = optim.stage2_optimizer(tb, 5e-4, 6, graphable=not saved_graphable)
    with torch.no_grad():
        for dst, src in zip(tree_leaves(tb), tree_leaves(ta)):
            dst.copy_(src)
    assert b.version == 0
    b.load_state_dict(copy.deepcopy(a.state_dict()))
    assert b.version == 1
    for group in b.optimizer.param_groups:
        assert isinstance(group["lr"], torch.Tensor) == (not saved_graphable)
        assert not group["capturable"]
    for opt, params in ((a, ta), (b, tb)):
        _set_grads(params, _fake_grads(jt, 2))
        opt.step()
    for x, y in zip(tree_leaves(ta), tree_leaves(tb)):
        assert torch.equal(x, y)


# --------------------------------------------------------------------------
# The steps: kept-token indices drawn outside, the warm-up undone
# --------------------------------------------------------------------------

def _small_model(device, dtype, img=IMG, patch_dropout=0.0, heads64=False):
    """tiny_test_config, or (``heads64``) the card tests' small model whose
    heads are 64 wide, as tests/test_torch_cuda_kernels.py builds it."""
    cfg = tconfigs.tiny_test_config(img)
    vision = replace(cfg.clip.vision, patch_dropout=patch_dropout)
    if heads64:
        vision = replace(vision, width=128, head_width=64, layers=3)
        cfg = replace(cfg, adapter=replace(cfg.adapter, levels=(2, 3)),
                      surgery_until_layer=3)
    cfg = replace(cfg, clip=replace(cfg.clip, vision=vision))
    frozen = random_backbone(cfg, seed=0, device=device, dtype=dtype)
    return cfg, frozen


def _trainable(cfg, device):
    return init_trainable(cfg, seed=1, device=device, dtype=torch.float32,
                          requires_grad=True)


def _stage2_batch(cfg, device, img, seed, n=4):
    rng = np.random.default_rng(seed)

    def on(a):
        return torch.from_numpy(a).to(device)

    return (on(rng.standard_normal((n, 3, img, img)).astype(np.float32)),
            on((rng.random((n, 1, img, img)) > 0.8).astype(np.float32)),
            on(rng.integers(0, 2, n).astype(np.int64)),
            on(rng.standard_normal((n, cfg.clip.embed_dim, 2)).astype(np.float32)),
            on(np.array([1, 1, 1, 0][:n], np.float32)))


def _opt_tensors(opt_state):
    return [(k, v.detach().clone()) for st in opt_state.optimizer.state.values()
            for k, v in sorted(st.items()) if isinstance(v, torch.Tensor)]


def _same(a, b):
    return len(a) == len(b) and all(
        ka == kb and torch.equal(x, y) for (ka, x), (kb, y) in zip(a, b))


@pytest.mark.parametrize("accum", [1, 2])
def test_stage2_step_fed_drawn_indices_equals_the_generator(accum):
    """What a captured step does with a patch-dropout generator (draw the
    kept tokens outside with ``step.keep_indices``, feed the tensor) is
    what the eager step does with the generator itself: the same loss,
    gradients and parameters, bit for bit."""
    cfg, frozen = _small_model("cpu", torch.float32, patch_dropout=0.25)
    step = steps.make_stage2_step(
        cfg, tconfigs.TrainConfig(img_size=IMG, grad_accum_steps=accum))
    batch = _stage2_batch(cfg, "cpu", IMG, seed=4)
    results = []
    for predraw in (False, True):
        trainable = _trainable(cfg, "cpu")
        opt = optim.stage2_optimizer(trainable, 5e-4, 4)
        gen = torch.Generator().manual_seed(7)
        rng = step.keep_indices(gen, 4, torch.device("cpu")) if predraw else gen
        _, _, loss = step(trainable, opt, frozen, *batch, rng)
        results.append((loss, [t.detach().clone() for t in tree_leaves(trainable)],
                        [None if t.grad is None else t.grad.clone()
                         for t in tree_leaves(trainable)]))
        if predraw:
            keep = cfg.clip.vision.num_patches * 3 // 4
            assert rng.shape == (4, keep)
            assert bool((rng[:, 1:] > rng[:, :-1]).all())
    (la, pa, ga), (lb, pb, gb) = results
    assert torch.equal(la, lb)
    assert all(torch.equal(a, b) for a, b in zip(pa, pb))
    assert all((a is None and b is None) or torch.equal(a, b) for a, b in zip(ga, gb))


@pytest.mark.parametrize("fresh", [True, False], ids=["fresh_optimizer", "after_a_step"])
def test_state_restored_undoes_the_warm_up(fresh):
    """Two updates inside ``state_restored`` (what a warm-up before a capture
    runs) leave the adapters and the optimizer state bit-equal to before
    (entries made inside zeroed, as a fresh Adam state is); the next step
    then equals the step of a twin that never ran them."""
    cfg, frozen = _small_model("cpu", torch.float32)
    step = steps.make_stage2_step(cfg, tconfigs.TrainConfig(img_size=IMG))
    batch = _stage2_batch(cfg, "cpu", IMG, seed=5)
    runs = []
    for disturbed in (False, True):
        trainable = _trainable(cfg, "cpu")
        opt = optim.stage2_optimizer(trainable, 5e-4, 4, graphable=True)
        if not fresh:
            step(trainable, opt, frozen, *batch)
        params0 = [t.detach().clone() for t in tree_leaves(trainable)]
        state0 = _opt_tensors(opt)
        if disturbed:
            with graphs.state_restored(trainable, opt):
                step.update(trainable, opt, frozen, *batch)
                step.update(trainable, opt, frozen, *_stage2_batch(cfg, "cpu", IMG, seed=6))
            assert all(torch.equal(a, b) for a, b in zip(params0, tree_leaves(trainable)))
            after = _opt_tensors(opt)
            if fresh:
                assert not state0 and after and all(not v.any() for _, v in after)
            else:
                assert _same(after, state0)
        _, _, loss = step(trainable, opt, frozen, *_stage2_batch(cfg, "cpu", IMG, seed=8))
        runs.append((loss, [t.detach().clone() for t in tree_leaves(trainable)],
                     _opt_tensors(opt)))
    (la, pa, sa), (lb, pb, sb) = runs
    assert torch.equal(la, lb)
    assert all(torch.equal(a, b) for a, b in zip(pa, pb))
    assert _same(sa, sb)


def test_graphed_step_needs_a_graphable_optimizer():
    cfg, frozen = _small_model("cpu", torch.float32)
    trainable = _trainable(cfg, "cpu")
    step = graphs.GraphedStep(steps.make_stage2_step(cfg, tconfigs.TrainConfig(img_size=IMG)),
                              graphs.GraphCache())
    with pytest.raises(ValueError, match="graphable"):
        step(trainable, optim.stage2_optimizer(trainable, 5e-4, 4, graphable=False), frozen,
             *_stage2_batch(cfg, "cpu", IMG, seed=1))


def test_keys_and_buffers_round_trip():
    """A capture's key names the arguments' structure, shapes and dtypes and
    the FUSED_ATTN route; the static buffers refill the same structure."""
    a, b, c = torch.zeros(2, 3), torch.ones(4, dtype=torch.int64), torch.zeros(1)
    args = [a, [b, c], None]
    flat = graphs._flatten(args)
    assert [t is u for t, u in zip(flat, (a, b, c))] == [True] * 3
    again = graphs._unflatten(args, [t.clone() for t in flat])
    assert again[2] is None and [tuple(t.shape) for t in again[1]] == [(4,), (1,)]
    key = graphs._key(args)
    assert key[:3] == (((2, 3), torch.float32), (((4,), torch.int64), ((1,), torch.float32)),
                       None)
    saved = clip_mod.FUSED_ATTN
    try:
        clip_mod.FUSED_ATTN = not saved
        assert graphs._key(args) != key
    finally:
        clip_mod.FUSED_ATTN = saved


def test_graphs_only_on_cuda_without_nan_checks():
    assert graphs.enabled("cuda") and not graphs.enabled("cpu")
    enable_nan_checks(True)
    try:
        assert not graphs.enabled("cuda")
    finally:
        enable_nan_checks(False)


def test_the_cpu_never_captures(tmp_path, monkeypatch):
    """run_training (both stages, a tail batch in each) and evaluate_dataset
    on the CPU run the eager programs: a capture, or even a graph cache,
    would raise here."""
    from aa_clip_iqm_tpu_torch.configs import EvalConfig
    from aa_clip_iqm_tpu_torch.data import synthetic
    from aa_clip_iqm_tpu_torch.data.datasets import get_dataset
    from aa_clip_iqm_tpu_torch.evaluation.predict import evaluate_dataset
    from aa_clip_iqm_tpu_torch.train import driver

    def refuse(*a, **k):
        raise AssertionError("a capture on the CPU")

    monkeypatch.setattr(graphs, "capture", refuse)
    monkeypatch.setattr(graphs.GraphCache, "__init__", refuse)
    classes = ("widget",)
    root = str(tmp_path)
    synthetic.generate(root, n_normal=3, n_anomalous=3, size=70, class_names=classes,
                       seed=3)
    meta_root = synthetic.register_synthetic(root, classes)
    cfg, frozen = _small_model("cpu", torch.float32)
    trainable = _trainable(cfg, "cpu")
    train_cfg = tconfigs.TrainConfig(
        dataset="Synth", img_size=IMG, training_mode="full_shot", shot=-1,
        text_batch_size=4, image_batch_size=4, text_epoch=1, image_epoch=1,
        save_path=str(tmp_path / "ckpt"), compute_dtype="float32")
    _, anchors = driver.run_training(frozen, trainable, cfg, train_cfg, LOGGER,
                                     metadata_root=meta_root)
    datasets = get_dataset("Synth", IMG, None, -1, "test", metadata_root=meta_root)
    rows = evaluate_dataset(frozen, trainable, cfg,
                            EvalConfig(dataset="Synth", img_size=IMG, batch_size=4),
                            datasets, anchors)
    assert [r["class name"] for r in rows] == ["widget", "Average"]


# --------------------------------------------------------------------------
# On the card: replays against the eager programs
# --------------------------------------------------------------------------

CARD_IMG = 266    # 362 tokens: enough for the packed attention kernels


def _rel(a, b):
    a, b = a.float(), b.float()
    return float((a - b).square().mean().sqrt() / b.square().mean().sqrt().clamp_min(1e-30))


def _run_stage2(cfg, frozen, dev, options, graphed, n_steps=3):
    trainable = _trainable(cfg, dev)
    opt = optim.stage2_optimizer(trainable, 5e-4, 10)
    train_cfg = tconfigs.TrainConfig(
        img_size=CARD_IMG, grad_accum_steps=options.get("grad_accum_steps", 1),
        remat=options.get("remat", False), clip_grad_norm=options.get("clip_grad_norm"))
    step = steps.make_stage2_step(cfg, train_cfg, compute_dtype=torch.bfloat16,
                                  clip_grad_norm=train_cfg.clip_grad_norm)
    if graphed:
        step = graphs.GraphedStep(step, graphs.GraphCache())
    losses = []
    for i in range(n_steps):
        batch = _stage2_batch(cfg, dev, CARD_IMG, seed=10 + i)
        rng = None
        if cfg.clip.vision.patch_dropout:
            rng = torch.Generator(device=dev).manual_seed(100 + i)
        losses.append(step(trainable, opt, frozen, *batch, rng)[2])
    torch.cuda.synchronize()
    return step, trainable, opt, losses


def _hold(replayed, eager, again):
    """Replays against eager steps: bit for bit where two eager runs agree
    bit for bit, else within the eager-to-eager bound of 1e-3."""
    pairs = list(zip(replayed, eager))
    equal_again = all(torch.equal(a, b) for a, b in zip(eager, again))
    if equal_again:
        assert all(torch.equal(a, b) for a, b in pairs)
    else:
        assert max(_rel(a, b) for a, b in pairs) <= 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("options", [
    {}, {"grad_accum_steps": 2}, {"patch_dropout": 0.25}, {"fused": True},
    {"remat": True}, {"clip_grad_norm": 1.0},
], ids=["plain", "accum2", "patch_dropout", "fused", "remat", "clip"])
def test_stage2_replays_equal_eager_steps(dev, options):
    """Three replays of one captured stage-2 step against three eager
    capturable steps from the same state: losses, adapters and Adam moments;
    one capture, three replays, three optimizer steps."""
    cfg, frozen = _small_model(dev, torch.bfloat16, img=CARD_IMG, heads64=True,
                               patch_dropout=options.get("patch_dropout", 0.0))
    saved = clip_mod.FUSED_ATTN
    clip_mod.FUSED_ATTN = bool(options.get("fused"))
    try:
        runs = [_run_stage2(cfg, frozen, dev, options, graphed)
                for graphed in (False, False, True)]
    finally:
        clip_mod.FUSED_ATTN = saved
    flat = [[*run[3], *tree_leaves(run[1]), *(v for _, v in _opt_tensors(run[2]))]
            for run in runs]
    _hold(flat[2], flat[0], flat[1])
    step, _, opt, _ = runs[2]
    assert [c.replays for c in step.graphs.values()] == [3]
    assert all(int(st["step"]) == 3 for st in opt.optimizer.state.values())


@pytest.mark.cuda
def test_stage2_recaptures_after_a_load_and_a_tail(dev):
    """A tail batch gets its own capture; a load into the optimizer makes
    the step capture again, and the replay after it equals the eager step
    after the same load."""
    cfg, frozen = _small_model(dev, torch.bfloat16, img=CARD_IMG, heads64=True)
    results = []
    for graphed in (False, True):
        step, trainable, opt, _ = _run_stage2(cfg, frozen, dev, {}, graphed, n_steps=1)
        state = copy.deepcopy(opt.state_dict())
        tail = _stage2_batch(cfg, dev, CARD_IMG, seed=20, n=2)
        step(trainable, opt, frozen, *tail, None)
        opt.load_state_dict(state)
        _, _, loss = step(trainable, opt, frozen,
                          *_stage2_batch(cfg, dev, CARD_IMG, seed=21), None)
        torch.cuda.synchronize()
        if graphed:   # the full batch, the tail, the full batch again
            assert len(step.cache.captures) == 2 and len(step.graphs) == 2
        results.append([loss, *tree_leaves(trainable)])
    assert max(_rel(a, b) for a, b in zip(results[1], results[0])) <= 1e-3


@pytest.mark.cuda
def test_stage1_replays_equal_eager_steps(dev):
    """The stage-1 feature program and step as graphs against the eager
    ones over two batches and a tail: features, losses, the text adapter
    and its Adam moments."""
    from aa_clip_iqm_tpu_torch.prompts import batched_prompt_tokens

    cfg, frozen = _small_model(dev, torch.bfloat16, img=CARD_IMG, heads64=True)
    classes, tokens, n_norm, n_abn = batched_prompt_tokens("MVTec")
    tokens = torch.from_numpy(np.asarray(tokens, np.int64)).to(dev)
    train_cfg = tconfigs.TrainConfig(img_size=CARD_IMG, dataset="MVTec")
    runs = []
    for graphed in (False, False, True):
        trainable = _trainable(cfg, dev)
        opt = optim.stage1_optimizer(trainable["text_adapter"], 1e-5)
        visual = steps.make_stage1_visual_fn(cfg, compute_dtype=torch.bfloat16)
        step = steps.make_stage1_step(cfg, train_cfg, tokens, len(classes), n_norm, n_abn,
                                      compute_dtype=torch.bfloat16)
        if graphed:
            cache = graphs.GraphCache()
            visual = graphs.GraphedFn(visual, cache, "features")
            step = graphs.GraphedStep(step, cache, "step")
        out = []
        for i, n in enumerate((4, 4, 2)):
            rng = np.random.default_rng(30 + i)
            images = torch.from_numpy(
                rng.standard_normal((n, 3, CARD_IMG, CARD_IMG)).astype(np.float32)).to(dev)
            masks = torch.from_numpy(
                (rng.random((n, 1, CARD_IMG, CARD_IMG)) > 0.8).astype(np.float32)).to(dev)
            class_idx = torch.from_numpy(rng.integers(0, len(classes), n)).to(dev)
            feats = visual(frozen, images)
            out.extend(f.clone() for f in feats)
            out.append(step(trainable["text_adapter"], opt, frozen, feats, masks, class_idx,
                            torch.ones(n, device=dev))[2])
        torch.cuda.synchronize()
        runs.append([*out, *tree_leaves(trainable["text_adapter"]),
                     *(v for _, v in _opt_tensors(opt))])
        if graphed:
            assert sorted(c.replays for c in cache.captures) == [1, 1, 2, 2]
    _hold(runs[2], runs[0], runs[1])


@pytest.mark.cuda
def test_sweep_on_graphs_equals_eager(dev, monkeypatch):
    """evaluate_dataset with its predict calls replayed (a bucket of 4 and
    its tail bucket of 2) against the eager sweep: the metrics to 1e-4, and
    a second sweep on the same cache replays without capturing."""
    from aa_clip_iqm_tpu_torch.configs import EvalConfig
    from aa_clip_iqm_tpu_torch.evaluation.predict import evaluate_dataset
    from aa_clip_iqm_tpu_torch.prompts import compute_frozen_anchors

    cfg, frozen = _small_model(dev, torch.bfloat16, img=CARD_IMG, heads64=True)
    trainable = init_trainable(cfg, seed=1, device=dev, dtype=torch.bfloat16)
    anchors = compute_frozen_anchors(frozen, trainable, cfg, "MVTec", adapted=False,
                                     compute_dtype=torch.bfloat16)

    class Memory:
        def __init__(self, seed, n=6):
            rng = np.random.default_rng(seed)
            self.images = rng.integers(0, 256, (n, 3, CARD_IMG, CARD_IMG), dtype=np.uint8)
            self.masks = (rng.random((n, 1, CARD_IMG, CARD_IMG)) > 0.9).astype(np.float32)
            self.labels = np.array([0, 1] * (n // 2), np.int64)

        def __len__(self):
            return len(self.images)

        def batches(self, batch_size):
            for s in range(0, len(self.images), batch_size):
                n = len(self.images[s:s + batch_size])
                yield {"image": self.images[s:s + n], "mask": self.masks[s:s + n],
                       "label": self.labels[s:s + n], "n_valid": n,
                       "file_name": [f"{s + i}" for i in range(n)]}

    datasets = {"bottle": Memory(1), "screw": Memory(2)}
    eval_cfg = EvalConfig(dataset="MVTec", img_size=CARD_IMG, batch_size=4)
    cache = graphs.GraphCache()
    on_graphs = evaluate_dataset(frozen, trainable, cfg, eval_cfg, datasets, anchors,
                                 compute_dtype=torch.bfloat16, graphs=cache)
    again = evaluate_dataset(frozen, trainable, cfg, eval_cfg, datasets, anchors,
                             compute_dtype=torch.bfloat16, graphs=cache)
    assert sorted(c.replays for c in cache.captures) == [4, 4]
    monkeypatch.setattr(graphs, "enabled", lambda device: False)
    eager = evaluate_dataset(frozen, trainable, cfg, eval_cfg, datasets, anchors,
                             compute_dtype=torch.bfloat16)
    keys = ("pixel AUC", "pixel AP", "image AUC", "image AP")
    for rows in (on_graphs, again):
        for r, e in zip(rows, eager):
            assert all(abs(r[k] - e[k]) <= 1e-4 * 100 + 1e-9 for k in keys), (r, e)
