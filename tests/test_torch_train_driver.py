"""The port's training driver on the CPU, tiny_test_config(56), fp32, on a
synthetic dataset written at the model's image size: TrainDataset batches
equal the JAX package's bit for bit; run_training writes checkpoints and
scalars.jsonl in the pinned schema; a run interrupted after k steps and
resumed from its step checkpoint ends bit-identical to an uninterrupted one,
in both stages; the CLIs train and then evaluate from the checkpoint."""
import json
import logging
import os

import numpy as np
import pytest
import torch

from aa_clip_iqm_tpu.data import datasets as jdatasets
from aa_clip_iqm_tpu.data import synthetic as jsynthetic
from aa_clip_iqm_tpu_torch import configs as tconfigs
from aa_clip_iqm_tpu_torch.cli import evaluate as tcli_eval
from aa_clip_iqm_tpu_torch.cli import train as tcli_train
from aa_clip_iqm_tpu_torch.data import datasets as tdatasets
from aa_clip_iqm_tpu_torch.data import synthetic as tsynthetic
from aa_clip_iqm_tpu_torch.loader import init_trainable, random_backbone
from aa_clip_iqm_tpu_torch.models.convert import tree_leaves
from aa_clip_iqm_tpu_torch.ops import interp
from aa_clip_iqm_tpu_torch.prompts import compute_frozen_anchors
from aa_clip_iqm_tpu_torch.train import checkpoint as ckpt
from aa_clip_iqm_tpu_torch.train import driver, optim, steps

IMG = 56
CLASSES = ("widget", "gadget")
LOGGER = logging.getLogger("test_torch_train_driver")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """8 images per class (half with a defect), at the model's image size so
    that neither package resizes; registered with both packages."""
    root = str(tmp_path_factory.mktemp("synth"))
    tsynthetic.generate(root, n_normal=4, n_anomalous=4, size=IMG,
                        class_names=CLASSES, seed=3)
    meta_root = tsynthetic.register_synthetic(root, CLASSES)
    assert jsynthetic.register_synthetic(root, CLASSES) == meta_root
    return root, meta_root


def _model():
    cfg = tconfigs.tiny_test_config(IMG)
    frozen = random_backbone(cfg, seed=0, device="cpu", dtype=torch.float32)
    trainable = init_trainable(cfg, seed=1, device="cpu", dtype=torch.float32,
                               requires_grad=True)
    return cfg, frozen, trainable


def _train_cfg(save_path, **kw):
    base = dict(dataset="Synth", img_size=IMG, training_mode="full_shot", shot=-1,
                text_batch_size=4, image_batch_size=4, text_epoch=2, image_epoch=2,
                save_path=str(save_path), compute_dtype="float32",
                checkpoint_every_steps=1)
    base.update(kw)
    return tconfigs.TrainConfig(**base)


def _equal(a, b):
    la, lb = list(tree_leaves(a)), list(tree_leaves(b))
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert torch.equal(x, y)


@pytest.mark.parametrize("text", [True, False], ids=["stage1", "stage2"])
def test_train_dataset_batches_equal_jax(data, text):
    """Same files, same (seed, epoch) streams: images, masks, labels and order
    equal the JAX package's, bit for bit, for two epochs, and a stream that
    starts at batch 1 equals the tail of the whole one."""
    _, meta_root = data
    jds = jdatasets.get_dataset("Synth", IMG, "full_shot", -1, "train", None,
                                metadata_root=meta_root, seed=5)[0 if text else 1]
    tds = tdatasets.get_dataset("Synth", IMG, "full_shot", -1, "train", None,
                                metadata_root=meta_root, seed=5)[0 if text else 1]
    assert len(tds) == len(jds) == 16 and tds.text == text
    moved = False
    for epoch in (0, 1):
        jb = list(jds.epoch_batches(epoch, 6))
        tb = list(tds.epoch_batches(epoch, 6))
        assert [b["image"].shape[0] for b in tb] == [6, 6, 4]
        for a, b in zip(tb, jb):
            for key in ("image", "mask", "label"):
                assert a[key].dtype == b[key].dtype
                np.testing.assert_array_equal(a[key], b[key])
            assert a["file_name"] == b["file_name"] and a["class_name"] == b["class_name"]
            assert set(np.unique(a["mask"])) <= {0.0, 1.0}
        tail = list(tds.epoch_batches(epoch, 6, start_batch=1))
        assert len(tail) == 2
        np.testing.assert_array_equal(tail[0]["image"], tb[1]["image"])
        moved |= tb[0]["file_name"] != sorted(tb[0]["file_name"])
    assert moved                                            # it shuffles
    assert not np.array_equal(next(tds.epoch_batches(0, 6))["image"],
                              next(tds.epoch_batches(1, 6))["image"])


def test_few_shot_needs_a_shot(data):
    with pytest.raises(ValueError, match="shot should be positive"):
        tdatasets.get_dataset("Synth", IMG, "few_shot", -1, "train",
                              metadata_root=data[1])


def test_run_training_writes_checkpoints_and_scalars(data, tmp_path):
    cfg, frozen, trainable = _model()
    start = [t.detach().clone() for t in tree_leaves(trainable)]
    train_cfg = _train_cfg(tmp_path, text_epoch=1, keep_checkpoints=1)
    out, anchors = driver.run_training(frozen, trainable, cfg, train_cfg, LOGGER,
                                       metadata_root=data[1])
    assert out is trainable and list(anchors) == list(CLASSES)
    assert anchors["widget"].shape == (cfg.clip.embed_dim, 2)
    assert any(not torch.equal(a, b) for a, b in zip(start, tree_leaves(trainable)))
    names = sorted(os.listdir(tmp_path))
    # keep_checkpoints=1 pruned image_adapter_1; the step tier is cleared.
    assert names == ["image_adapter", "image_adapter_2", "scalars.jsonl", "text_adapter"]
    assert os.listdir(tmp_path / "image_adapter") == [ckpt.FILE]
    rows = [json.loads(line) for line in open(tmp_path / "scalars.jsonl")]
    assert all(set(r) == {"stage", "epoch", "step", "loss", "lr", "wall_ms"} for r in rows)
    assert [(r["stage"], r["epoch"], r["step"]) for r in rows] == (
        [("stage1", 0, s) for s in range(4)]
        + [("stage2", e, s) for e in (0, 1) for s in range(4)])
    assert all(np.isfinite(r["loss"]) and r["wall_ms"] >= 0 for r in rows)
    assert all(r["lr"] == train_cfg.text_lr for r in rows[:4])
    sched = optim.cosine_annealing(train_cfg.image_lr, 8)
    assert [r["lr"] for r in rows[4:]] == [sched(k) for k in range(8)]
    # What the checkpoint holds is what the run returned.
    _, _, fresh = _model()
    restored, adapted, epoch = ckpt.restore_adapters(str(tmp_path), fresh)
    assert adapted and epoch == 2
    _equal(restored, trainable)
    assert ckpt.latest_numbered_dir(str(tmp_path)).endswith("image_adapter_2")
    with pytest.raises(FileNotFoundError):
        ckpt.restore_adapters(str(tmp_path / "nothing"), fresh)
    assert ckpt.restore_adapters(str(tmp_path / "nothing"), fresh,
                                 require_stage2=False)[1:] == (False, None)


class SimulatedOutage(Exception):
    pass


class InterruptAfter:
    """Dataset wrapper that fails after ``n_steps`` batches in all."""

    def __init__(self, ds, n_steps):
        self.ds, self.remaining = ds, n_steps

    def __len__(self):
        return len(self.ds)

    def epoch_batches(self, epoch, batch_size, start_batch=0):
        for batch in self.ds.epoch_batches(epoch, batch_size, start_batch=start_batch):
            if self.remaining <= 0:
                raise SimulatedOutage(f"interrupted in epoch {epoch}")
            self.remaining -= 1
            yield batch


def _datasets(data, seed=111):
    return tdatasets.get_dataset("Synth", IMG, "full_shot", metadata_root=data[1],
                                 seed=seed)


@pytest.mark.parametrize("use_async", [True, False], ids=["async", "sync"])
def test_stage1_interrupt_resume_bit_identical(data, tmp_path, use_async):
    text_ds, _ = _datasets(data)
    cfg, frozen, whole = _model()
    driver.run_stage1(frozen, whole, cfg, _train_cfg(tmp_path / "a"), text_ds, LOGGER)
    _, _, part = _model()
    cut = _train_cfg(tmp_path / "b", async_step_checkpoint=use_async)
    with pytest.raises(SimulatedOutage):        # dies in epoch 1 after 5 of 8 steps
        driver.run_stage1(frozen, part, cfg, cut, InterruptAfter(text_ds, 5), LOGGER)
    assert os.path.isfile(tmp_path / "b" / "text_adapter_step" / ckpt.FILE)
    _, _, resumed = _model()                    # a new process: fresh tensors
    driver.run_stage1(frozen, resumed, cfg, cut, text_ds, LOGGER)
    _equal(resumed["text_adapter"], whole["text_adapter"])
    assert not os.path.exists(tmp_path / "b" / "text_adapter_step")


@pytest.mark.parametrize("patch_dropout", [0.0, 0.25], ids=["plain", "patch-dropout"])
def test_stage2_interrupt_resume_bit_identical(data, tmp_path, patch_dropout):
    from aa_clip_iqm_tpu_torch.loader import build_model_config

    _, image_ds = _datasets(data)
    _, frozen, whole = _model()
    cfg = build_model_config("tiny-test", IMG, patch_dropout=patch_dropout)
    anchors = compute_frozen_anchors(frozen, whole, cfg, "Synth", adapted=False)
    driver.run_stage2(frozen, whole, cfg, _train_cfg(tmp_path / "a"), image_ds, anchors,
                      LOGGER)
    _, _, part = _model()
    cut = _train_cfg(tmp_path / "b")
    with pytest.raises(SimulatedOutage):        # dies in epoch 1 after 6 of 8 steps
        driver.run_stage2(frozen, part, cfg, cut, InterruptAfter(image_ds, 6), anchors,
                          LOGGER)
    _, _, resumed = _model()
    driver.run_stage2(frozen, resumed, cfg, cut, image_ds, anchors, LOGGER)
    _equal(resumed, whole)
    # scalars.jsonl: epoch 0 by the interrupted run; the resumed run appends
    # epoch 1 from its resume step on, with the uninterrupted run's numbers.
    rows_a = [json.loads(line) for line in open(tmp_path / "a" / "scalars.jsonl")]
    rows_b = [json.loads(line) for line in open(tmp_path / "b" / "scalars.jsonl")]
    assert [(r["epoch"], r["step"]) for r in rows_b] == [
        (0, 0), (0, 1), (0, 2), (0, 3), (1, 2), (1, 3)]
    by_step = {(r["epoch"], r["step"]): r for r in rows_a}
    for r in rows_b:
        assert r["loss"] == by_step[(r["epoch"], r["step"])]["loss"]
        assert r["lr"] == by_step[(r["epoch"], r["step"])]["lr"]


def test_step_checkpoint_round_trip_and_stale_epochs(tmp_path):
    """Tensors and optimizer state come back bit for bit; a step checkpoint of
    an epoch that was completed is ignored; the write is one renamed file."""
    _, _, trainable = _model()
    opt = optim.stage2_optimizer(trainable, 5e-4, 10)
    for t in tree_leaves(trainable):
        t.grad = torch.full_like(t, 0.01)
    opt.step()
    ckpt.save_step(str(tmp_path), "stage2", 3, 7, trainable, opt)
    assert os.listdir(tmp_path / "image_adapter_step") == [ckpt.FILE]
    _, _, other = _model()
    opt2 = optim.stage2_optimizer(other, 5e-4, 10)
    assert ckpt.load_step(str(tmp_path), "stage2", other, opt2, min_epoch=4) is None
    assert not torch.equal(other["query_proj"]["w"], trainable["query_proj"]["w"])
    got = ckpt.load_step(str(tmp_path), "stage2", other, opt2)
    assert (got["epoch"], got["step"]) == (3, 7) and got["params"] is other
    _equal(other, trainable)
    _equal(opt2.state_dict()["optimizer"]["state"], opt.state_dict()["optimizer"]["state"])
    assert opt2.scheduler.last_epoch == opt.scheduler.last_epoch == 1
    assert ckpt.load_step(str(tmp_path), "stage1", other["text_adapter"], opt2) is None
    ckpt.clear_step(str(tmp_path), "stage2")
    assert ckpt.load_step(str(tmp_path), "stage2", other, opt2) is None


def test_async_saver_snapshots_before_the_next_update(tmp_path, monkeypatch):
    """The snapshot is taken when save() is called: an in-place update right
    after it does not reach the file. A failed write surfaces at wait()."""
    _, _, trainable = _model()
    opt = optim.stage2_optimizer(trainable, 5e-4, 10)
    before = [t.detach().clone() for t in tree_leaves(trainable)]
    saver = driver._StepSaver(use_async=True)
    saver.save(str(tmp_path), "stage2", 0, 1, trainable, opt)
    with torch.no_grad():
        for t in tree_leaves(trainable):
            t.add_(1.0)
    saver.wait()
    _, _, other = _model()
    ckpt.load_step(str(tmp_path), "stage2", other, optim.stage2_optimizer(other, 5e-4, 10))
    for a, b in zip(tree_leaves(other), before):
        assert torch.equal(a, b)

    def boom(*a, **k):
        raise RuntimeError("disk full")

    monkeypatch.setattr(ckpt, "save_step", boom)
    saver.save(str(tmp_path), "stage2", 0, 2, trainable, opt)
    with pytest.raises(RuntimeError, match="disk full"):
        saver.wait()


def test_pad_batch():
    batch = {"image": np.ones((3, 3, 4, 4), np.float32), "mask": np.ones((3, 1, 4, 4), np.float32),
             "label": np.array([1, 0, 1]), "class_name": ["a", "b", "c"]}
    same, n = driver._pad_batch(batch, 3)
    assert same is batch and n == 3
    out, n = driver._pad_batch(batch, 4)
    assert n == 3 and out["image"].shape[0] == 4 and not out["image"][3].any()
    assert out["label"].tolist() == [1, 0, 1, 0] and out["class_name"] == ["a", "b", "c", "c"]


def test_anchors_built_in_inference_mode_can_be_saved_for_backward():
    """Stage 2's loss saves the anchors (and the cached resize operators) for
    its backward; tensors made in inference mode would refuse that."""
    cfg, frozen, trainable = _model()
    interp._device_operator.cache_clear()
    with torch.inference_mode():
        anchors = compute_frozen_anchors(frozen, trainable, cfg, "MVTec", adapted=False)
        interp.resize_bilinear(torch.zeros(1, 4, 4), IMG, IMG, align_corners=False)
        interp.resize_bilinear(torch.zeros(1, 4, 4), IMG, IMG, align_corners=True)
    assert not anchors["bottle"].is_inference() and not anchors["bottle"].requires_grad
    step = steps.make_stage2_step(cfg, tconfigs.TrainConfig(img_size=IMG,
                                                            compute_dtype="float32"))
    rng = np.random.default_rng(0)
    images = torch.from_numpy(rng.standard_normal((2, 3, IMG, IMG)).astype(np.float32))
    masks = torch.from_numpy((rng.random((2, 1, IMG, IMG)) > 0.8).astype(np.float32))
    stack = torch.stack([anchors["bottle"], anchors["screw"]])
    _, _, loss = step(trainable, optim.stage2_optimizer(trainable, 5e-4, 4), frozen,
                      images, masks, torch.tensor([0, 1]), stack, torch.ones(2))
    assert torch.isfinite(loss)
    assert trainable["image_adapter"]["layer_adapters"][0]["w"].grad.abs().max() > 0


def test_trainable_is_float32_and_bf16_compute_trains():
    """float32 master weights under a bf16 forward: the step moves them, and
    they stay float32; the frozen backbone stays bf16 and gets no gradient."""
    cfg = tconfigs.tiny_test_config(IMG)
    frozen = random_backbone(cfg, seed=0, device="cpu", dtype=torch.bfloat16)
    trainable = init_trainable(cfg, seed=1, device="cpu", dtype=torch.float32,
                               requires_grad=True)
    assert {t.dtype for t in tree_leaves(trainable)} == {torch.float32}
    assert frozen["visual"]["blocks"][0]["mlp"]["c_fc"]["w"].dtype == torch.bfloat16
    assert init_trainable(cfg, device="cpu")["query_proj"]["w"].dtype == torch.bfloat16
    before = trainable["image_adapter"]["det_proj"]["w"].detach().clone()
    step = steps.make_stage2_step(cfg, tconfigs.TrainConfig(img_size=IMG),
                                  compute_dtype=torch.bfloat16)
    rng = np.random.default_rng(1)
    anchors = torch.from_numpy(rng.standard_normal((2, 32, 2)).astype(np.float32))
    _, _, loss = step(trainable, optim.stage2_optimizer(trainable, 5e-4, 4), frozen,
                      torch.from_numpy(rng.standard_normal((2, 3, IMG, IMG)).astype(np.float32)),
                      torch.zeros(2, 1, IMG, IMG), torch.tensor([0, 1]), anchors,
                      torch.ones(2))
    assert torch.isfinite(loss)
    after = trainable["image_adapter"]["det_proj"]["w"]
    assert after.dtype == torch.float32 and not torch.equal(after, before)
    assert all(t.grad is None and not t.requires_grad for t in tree_leaves(frozen))


def test_cli_train_then_evaluate(data, tmp_path, capsys):
    """``cli.train`` runs both stages end to end; ``cli.evaluate`` then reads
    its checkpoint (no --no_adapters) and scores with the trained adapters."""
    _, meta_root = data
    common = ["--model_name", "tiny-test", "--img_size", str(IMG), "--dataset", "Synth",
              "--random_backbone", "--device", "cpu", "--compute_dtype", "float32",
              "--metadata_root", meta_root, "--save_path", str(tmp_path / "ckpt")]
    trainable, anchors = tcli_train.main(common + [
        "--training_mode", "full_shot", "--text_epoch", "1", "--image_epoch", "1",
        "--text_batch_size", "8", "--image_batch_size", "8", "--grad_accum", "2",
        "--remat", "--clip_grad_norm", "1.0", "--seed", "7"])
    assert sorted(os.listdir(tmp_path / "ckpt")) == [
        "image_adapter", "image_adapter_1", "scalars.jsonl", "text_adapter", "train.log"]
    rows = tcli_eval.main(common + ["--image_batch_size", "4", "--seed", "7"])
    assert [r["class name"] for r in rows] == [*CLASSES, "Average"]
    assert "restored adapters" in open(tmp_path / "ckpt" / "test.log").read()
    untrained = tcli_eval.main(common + ["--image_batch_size", "4", "--seed", "7",
                                         "--no_adapters"])
    assert any(a["pixel AUC"] != b["pixel AUC"] for a, b in zip(rows, untrained))
    # --data_parallel without a launcher changes nothing, as JAX's with one
    # device: the same adapters bit for bit.
    def stage2_only(name, *extra):
        return tcli_train.main([*common[:-1], str(tmp_path / name), "--training_mode",
                                "full_shot", "--text_epoch", "0", "--image_epoch", "1",
                                "--image_batch_size", "8", "--seed", "7", *extra])[0]

    plain, flagged = stage2_only("one"), stage2_only("dp", "--data_parallel")
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(plain), tree_leaves(flagged)))
    capsys.readouterr()
    assert list(anchors) == list(CLASSES) and "iqm" in trainable
