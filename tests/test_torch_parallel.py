"""The port's data and tensor parallelism (aa_clip_iqm_tpu_torch/parallel)
on the CPU, with gloo, against the JAX package on its 8-device virtual mesh
(tests/conftest.py) and against the port in one process, at JAX's own
tolerances (tests/test_parallel.py).

Three runs, each its ranks in spawned processes that meet through a
FileStore under tmp_path (``torch_parallel_worker``): 2 ranks on the data
axis, 2 on the model axis, and 4 on a (replica 2, data 1, model 2) mesh.
They start together when the module's first test asks for them, each with
its own timeout, and are killed and joined in the fixture's teardown. The
layout tests need no process."""
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_worker as worker
from aa_clip_iqm_tpu.configs import TrainConfig as JTrainConfig
from aa_clip_iqm_tpu.configs import tiny_test_config
from aa_clip_iqm_tpu.evaluation.predict import make_predict_fn as jmake_predict_fn
from aa_clip_iqm_tpu.models import adapters as jadapters
from aa_clip_iqm_tpu.models.clip import init_clip_params
from aa_clip_iqm_tpu.parallel import mesh as jmesh
from aa_clip_iqm_tpu.train import optim as joptim
from aa_clip_iqm_tpu.train import steps as jsteps
from aa_clip_iqm_tpu_torch.data import synthetic as tsynthetic
from aa_clip_iqm_tpu_torch.evaluation.predict import results_table
from aa_clip_iqm_tpu_torch.parallel import mesh as tmesh
from aa_clip_iqm_tpu_torch.parallel import multihost

IMG = worker.IMG
CLASSES = ("widget", "gadget")
TIMEOUT = 120
RUNS = {"dp": 2, "tp": 2, "ms": 4}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def model():
    cfg = tiny_test_config(IMG)
    frozen = init_clip_params(jax.random.PRNGKey(0), cfg.clip)
    trainable = jadapters.init_adapter_params(jax.random.PRNGKey(1), cfg)
    return cfg, frozen, trainable


@pytest.fixture(scope="module")
def inputs(model, tmp_path_factory):
    """What every rank reads: the JAX package's weights as numpy trees, one
    batch of 8, anchors, and a synthetic dataset of 11 images a class."""
    _, frozen, trainable = model
    rng = np.random.default_rng(5)
    anchors = rng.standard_normal((8, 32, 2)).astype(np.float32)
    anchors /= np.linalg.norm(anchors, axis=1, keepdims=True)
    batch = (rng.standard_normal((8, 3, IMG, IMG)).astype(np.float32),
             (rng.random((8, 1, IMG, IMG)) > 0.8).astype(np.float32),
             rng.integers(0, 2, 8).astype(np.int64), anchors)
    root = str(tmp_path_factory.mktemp("synth"))
    tsynthetic.generate(root, n_normal=5, n_anomalous=6, size=IMG, class_names=CLASSES, seed=3)
    meta_root = tsynthetic.register_synthetic(root, CLASSES)
    inp = {"frozen": jax.tree.map(np.asarray, frozen),
           "trainable": jax.tree.map(np.asarray, trainable),
           "batch": batch, "anchors": anchors, "data_root": root, "meta_root": meta_root,
           "classes": CLASSES}
    path = str(tmp_path_factory.mktemp("inputs") / "inputs.pkl")
    with open(path, "wb") as f:
        pickle.dump(inp, f)
    return inp, path


@pytest.fixture(scope="module")
def started(inputs, tmp_path_factory):
    _, path = inputs
    base = tmp_path_factory.mktemp("runs")
    handles = {}
    try:
        for job, world in RUNS.items():
            handles[job] = worker.start(job, world, base / job, path)
        yield handles
    finally:
        for h in handles.values():
            worker.stop(h)


@pytest.fixture(scope="module")
def jax_refs(model, inputs):
    """JAX's sharded programs on the same inputs: the stage-2 step on the
    data axis and on a (2, 2, 2) multislice mesh with a TP backbone, and
    predict on the data axis (both score modes) and over a TP backbone."""
    cfg, frozen, trainable = model
    inp, _ = inputs
    images, masks, labels, anchors = (jnp.asarray(a) for a in inp["batch"])
    weights = jnp.asarray((np.arange(8) < 7).astype(np.float32))
    train_cfg = JTrainConfig(img_size=IMG, image_epoch=1, compute_dtype="float32")
    tx = joptim.stage2_optimizer(trainable, train_cfg.image_lr, 10)
    opt = tx.init(trainable)
    args = (images, masks, labels, anchors, weights)
    out = {}
    dp = jmesh.make_mesh()
    step = jsteps.make_stage2_step(cfg, train_cfg, tx, compute_dtype=jnp.float32, mesh=dp,
                                   donate=False)
    t, _, loss = step(trainable, opt, frozen, *args)
    out["stage2 dp"] = (float(loss), np.asarray(t["image_adapter"]["det_proj"]["w"]))
    ms = jmesh.make_multislice_mesh(2, n_data=2, n_model=2)
    step = jsteps.make_stage2_step(
        cfg, train_cfg, tx, compute_dtype=jnp.float32, mesh=ms, donate=False,
        frozen_sharding=jmesh.backbone_param_sharding(ms, frozen))
    t, _, loss = step(trainable, opt, jmesh.shard_backbone(ms, frozen), *args)
    out["stage2 ms"] = (float(loss), np.asarray(t["image_adapter"]["det_proj"]["w"]))
    janchors = jnp.asarray(inp["anchors"])
    for mode in ("fixed", "reference_eval"):
        fn = jmake_predict_fn(cfg, IMG, "Industrial", mesh=dp, image_score_mode=mode)
        out[f"predict {mode}"] = tuple(np.asarray(a) for a in fn(frozen, trainable, images,
                                                                 janchors))
    tp = jmesh.make_mesh(n_data=4, n_model=2)
    frozen_tp = jmesh.shard_backbone(tp, frozen)
    out["tp qkv shard"] = frozen_tp["visual"]["blocks"]["attn"]["qkv"]["w"] \
        .addressable_shards[0].data.shape
    fn = jmake_predict_fn(cfg, IMG, "Industrial")
    out["predict tp"] = tuple(np.asarray(a) for a in fn(frozen_tp, trainable, images, janchors))
    return out


@pytest.fixture(scope="module")
def runs(started, jax_refs):
    """Each run's per-rank results (the JAX references are computed first,
    while the ranks work)."""
    return {job: worker.finish(h, TIMEOUT) for job, h in started.items()}


@pytest.fixture(scope="module")
def single(inputs):
    """The port in one process, on the whole batch."""
    inp, _ = inputs
    return {"stage2": {c[0]: worker.stage2_step(inp, c) for c in worker.STAGE2_CASES},
            "stage1": worker.stage1_step(inp),
            "predict": {m: worker.predict(inp, m) for m in ("fixed", "reference_eval")},
            "eval": worker.evaluate(inp)}


def _scale_close(got, ref, tol):
    scale = float(np.abs(ref).max())
    np.testing.assert_allclose(got, ref, rtol=tol, atol=tol * scale)


# ----------------------------------------------------------------------
# Data parallelism
# ----------------------------------------------------------------------

@pytest.mark.parametrize("case", worker.STAGE2_CASES, ids=[c[0] for c in worker.STAGE2_CASES])
def test_data_parallel_stage2_matches_one_process(runs, single, case):
    """Both ranks take the single process's step on the whole batch: the
    same loss, the same gradients (the padded tail, --accum 2 with the
    ranks' 4 rows split 2 + 2, patch dropout drawn for the global batch)."""
    loss1, det1, g1 = single["stage2"][case[0]]
    for rank in runs["dp"]:
        loss, det, g = rank["stage2"][case[0]]
        np.testing.assert_allclose(loss, loss1, rtol=1e-5)
        _scale_close(g, g1, 1e-5)
        np.testing.assert_allclose(det, det1, rtol=1e-4, atol=1e-5)


def test_data_parallel_stage2_matches_jax(runs, jax_refs):
    """The padded batch (7 valid rows of 8, so the ranks hold 4 and 3)
    against JAX's sharded step, at test_parallel.py's tolerances."""
    jloss, jdet = jax_refs["stage2 dp"]
    for rank in runs["dp"]:
        loss, det, _ = rank["stage2"]["padded"]
        np.testing.assert_allclose(loss, jloss, rtol=1e-4)
        np.testing.assert_allclose(det, jdet, rtol=1e-4, atol=1e-5)


def test_mean_of_per_rank_means_is_not_the_step(runs, single):
    """The planted fault: DDP's mean of the ranks' mean-loss gradients is
    another gradient once the ranks hold different numbers of valid rows;
    the test above would catch it."""
    _, _, g1 = single["stage2"]["padded"]
    wrong = runs["dp"][0]["mean_of_means"]
    with pytest.raises(AssertionError):
        _scale_close(wrong, g1, 1e-5)


def test_data_parallel_rows(runs):
    assert [r["rows"] for r in runs["dp"]] == [(0, 4), (4, 8)]
    assert runs["dp"][0]["shape"] == {"data": 2, "model": 1}


def test_replicate_broadcasts_rank_0(runs):
    for rank in runs["dp"]:
        a, b = rank["replicated"]
        np.testing.assert_array_equal(a, np.zeros(3))
        np.testing.assert_array_equal(b, np.full((2, 2), 5.0))


def test_data_parallel_stage1_matches_one_process(runs, single):
    """Stage 1: the orthogonality term is the square of a global mean, so
    the step sums the ranks' numerators before the loss: the single
    process's loss and update."""
    loss1, leaves1 = single["stage1"]
    for rank in runs["dp"]:
        loss, leaves = rank["stage1"]
        np.testing.assert_allclose(loss, loss1, rtol=1e-5)
        for a, b in zip(leaves, leaves1):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("mode", ["fixed", "reference_eval"])
def test_data_parallel_predict_matches_jax(runs, single, jax_refs, mode):
    """Each rank predicts its rows and gathers the rest; reference_eval
    scores every row from global row 1, sent from the rank that holds it."""
    jmap, jlogit = jax_refs[f"predict {mode}"]
    smap, slogit = single["predict"][mode]
    for rank in runs["dp"]:
        maps, logits = rank["predict"][mode]
        np.testing.assert_allclose(maps, jmap, rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(logits, jlogit, rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(maps, smap, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(logits, slogit, rtol=1e-5, atol=1e-6)


def test_data_parallel_evaluation_table(runs, single):
    """The per-class table of a sweep split over 2 ranks (batch 4, every
    class's tail padded) is the single process's."""
    want = single["eval"]
    for rank in runs["dp"]:
        rows = rank["eval"]
        assert [r["class name"] for r in rows] == [*CLASSES, "Average"]
        for a, b in zip(rows, want):
            for key in ("pixel AUC", "pixel AP", "image AUC", "image AP"):
                assert abs(a[key] - b[key]) <= 1e-6, (a, b)
        assert results_table(rows) == results_table(want)


def test_data_parallel_training_writes_on_rank_0_only(runs, inputs, tmp_path):
    """run_training on 2 ranks (each given its own save path, to see who
    writes): rank 0 writes the checkpoints and scalars.jsonl, rank 1
    nothing; both end on the same adapters, those of one process trained on
    the same data (tails padded for 2 ranks and --accum 2)."""
    inp, _ = inputs
    r0, r1 = runs["dp"]
    assert r0["wrote"] == ["image_adapter", "image_adapter_1", "scalars.jsonl",
                           "text_adapter"]
    assert r1["wrote"] == []
    one = worker.train(inp, str(tmp_path / "one"))
    for a, b, c in zip(r0["train"], r1["train"], one):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_allclose(a, c, rtol=1e-4, atol=1e-5)


# ----------------------------------------------------------------------
# Tensor parallelism and the multislice mesh
# ----------------------------------------------------------------------

def test_tensor_parallel_shard_shapes(runs, inputs, jax_refs):
    """Each rank holds JAX's shard shape (3d / n_model qkv columns), and
    its qkv columns are [q_r | k_r | v_r] for its heads."""
    inp, _ = inputs
    width = 64
    qkv = inp["frozen"]["visual"]["blocks"]["attn"]["qkv"]["w"][0]      # (d, 3d)
    for rank in runs["tp"]:
        s = rank["shapes"]
        assert s["attn.qkv.w"] == (width, 3 * width // 2) and s["attn.qkv.b"] == (96,)
        assert s["attn.out.w"] == (width // 2, width) and s["attn.out.b"] == (width,)
        assert s["mlp.c_fc.w"] == (width, 2 * width) and s["mlp.c_proj.w"] == (2 * width, width)
        assert s["mlp.c_fc.b"] == (2 * width,) and s["mlp.c_proj.b"] == (width,)
        j = rank["model_index"]
        half = width // 2
        want = np.concatenate([qkv[:, sec * width + j * half: sec * width + (j + 1) * half]
                               for sec in range(3)], axis=1)
        np.testing.assert_array_equal(rank["qkv"], want)
    # JAX's shard of the stacked leaf on its (4, 2) mesh: the same shape.
    assert jax_refs["tp qkv shard"][1:] == runs["tp"][0]["shapes"]["attn.qkv.w"]


def test_tensor_parallel_predict_matches_jax(runs, jax_refs):
    jmap, jlogit = jax_refs["predict tp"]
    for rank in runs["tp"]:
        maps, logits = rank["predict"]
        np.testing.assert_allclose(maps, jmap, rtol=1e-3, atol=1e-4)
        np.testing.assert_allclose(logits, jlogit, rtol=1e-3, atol=1e-4)


def test_multislice_stage2_matches_jax(runs, jax_refs, single):
    """('replica', 'data', 'model') = (2, 1, 2): replica-major rows, TP
    backbone split by frozen_sharding, the gradient summed over the
    replicas; JAX's (2, 2, 2) step and the single process's."""
    jloss, jdet = jax_refs["stage2 ms"]
    loss1, _, g1 = single["stage2"]["padded"]
    want_rows = {0: (0, 4), 1: (4, 8)}
    for rank in runs["ms"]:
        assert rank["rows"] == want_rows[rank["coords"]["replica"]]
        loss, det, g = rank["stage2"]
        np.testing.assert_allclose(loss, jloss, rtol=1e-4)
        np.testing.assert_allclose(det, jdet, rtol=1e-4, atol=1e-5)
        _scale_close(g, g1, 1e-4)


# ----------------------------------------------------------------------
# Layouts, without processes
# ----------------------------------------------------------------------

def test_multislice_mesh_validates_device_count():
    """test_parallel.py's refusals: more cells than ranks, and a data axis
    that would be 0."""
    ranks = list(range(8))
    with pytest.raises(ValueError, match="devices"):
        tmesh.make_multislice_mesh(2, n_data=8, n_model=2, devices=ranks)
    mesh = tmesh.make_multislice_mesh(2, n_data=2, n_model=2, devices=ranks)
    assert mesh.devices.shape == (2, 2, 2)
    assert mesh.shape == {"replica": 2, "data": 2, "model": 2}
    with pytest.raises(ValueError, match="data axis"):
        tmesh.make_multislice_mesh(8, n_model=2, devices=ranks)


def test_multislice_mesh_groups_ranks_by_node():
    """Nodes of 4 ranks (rank // LOCAL_WORLD_SIZE): each replica row on one
    node, and a row that would straddle two nodes is refused."""
    mesh = tmesh.make_multislice_mesh(2, n_data=2, n_model=2, devices=[4, 5, 6, 7, 0, 1, 2, 3],
                                      local_world_size=4)
    assert mesh.devices.tolist() == [[[0, 1], [2, 3]], [[4, 5], [6, 7]]]
    with pytest.raises(ValueError, match="spans nodes"):
        tmesh.make_multislice_mesh(2, n_data=1, n_model=2, devices=[0, 1, 2, 4, 5, 6],
                                   local_world_size=3)
    assert tmesh.batch_sharding(mesh).spec == tmesh.P(("replica", "data"))
    assert tmesh.replicated(mesh).spec == tmesh.P()


def test_mesh_layout_matches_jax():
    """The port's rank grid is JAX's device grid with ranks for devices."""
    jm = jmesh.make_mesh(n_data=4, n_model=2)
    tm = tmesh.make_mesh(n_data=4, n_model=2, devices=range(8))
    assert tm.devices.tolist() == [[d.id for d in row] for row in jm.devices]
    assert tm.axis_names == jm.axis_names
    js = jmesh.make_multislice_mesh(2, n_data=2, n_model=2)
    ts = tmesh.make_multislice_mesh(2, n_data=2, n_model=2, devices=range(8))
    assert ts.devices.tolist() == np.vectorize(lambda d: d.id)(js.devices).tolist()
    assert ts.data_axes == ("replica", "data") and ts.data_size == 4


def test_backbone_param_sharding_matches_jax(model):
    """The specs are JAX's without its leading layer axis; qkv's columns are
    split within each of q, k and v."""
    _, frozen, _ = model
    jspec = jmesh.backbone_param_sharding(jmesh.make_mesh(n_data=4, n_model=2), frozen)
    tf, _ = worker.port_params({"frozen": jax.tree.map(np.asarray, frozen), "trainable": None})
    mesh = tmesh.make_mesh(n_data=4, n_model=2, devices=range(8))
    tspec = tmesh.backbone_param_sharding(mesh, tf)
    for path in (("attn", "qkv", "w"), ("attn", "qkv", "b"), ("attn", "out", "w"),
                 ("attn", "out", "b"), ("mlp", "c_fc", "w"), ("mlp", "c_fc", "b"),
                 ("mlp", "c_proj", "w"), ("mlp", "c_proj", "b"), ("ln_1", "scale")):
        j = jspec["visual"]["blocks"]
        t = tspec["visual"]["blocks"][0]
        for k in path:
            j, t = j[k], t[k]
        assert tuple(t.spec) == tuple(j.spec)[1:], path
    assert tspec["visual"]["blocks"][0]["attn"]["qkv"]["w"].sections == 3
    assert tspec["visual"]["proj"].spec == tmesh.P()


def test_tensor_parallel_refuses_what_it_cannot_split(model):
    cfg, frozen, _ = model
    mesh = tmesh.make_mesh(n_data=1, n_model=8, devices=range(8))
    with pytest.raises(ValueError, match="heads"):
        tmesh.check_tensor_parallel(mesh, worker.model_config().clip)
    tmesh.check_tensor_parallel(tmesh.make_mesh(n_data=2, n_model=4, devices=range(8)),
                                worker.model_config().clip)


def test_process_local_rows():
    """Contiguous blocks in data order, shared by 'model' peers; a batch the
    data ranks do not divide, and a rank at two data positions, raise."""
    dp = tmesh.make_mesh(devices=range(8))
    assert [multihost.process_local_rows(dp, 16, rank=r) for r in (0, 3, 7)] == [
        (0, 2), (6, 8), (14, 16)]
    tp = tmesh.make_mesh(n_data=4, n_model=2, devices=range(8))
    assert multihost.process_local_rows(tp, 8, rank=0) == multihost.process_local_rows(
        tp, 8, rank=1) == (0, 2)
    ms = tmesh.make_multislice_mesh(2, n_data=2, n_model=2, devices=range(8))
    assert [multihost.process_local_rows(ms, 4, rank=r) for r in range(0, 8, 2)] == [
        (0, 1), (1, 2), (2, 3), (3, 4)]
    with pytest.raises(ValueError, match="split"):
        multihost.process_local_rows(dp, 12, rank=0)
    odd = tmesh.Mesh(np.array([[0], [1], [2]]), ("data", "model"), rank=0, device="cpu")
    odd.devices = np.array([[0], [1], [0]])     # rank 0 at data positions 0 and 2
    with pytest.raises(ValueError, match="not contiguous"):
        multihost.process_local_rows(odd, 6, rank=0)


def test_global_device_batch_and_shard_batch():
    mesh = tmesh.make_mesh(devices=range(2), rank=1, device="cpu")
    rng = np.random.default_rng(11)
    batch = {"image": rng.standard_normal((8, 3, 4, 4)).astype(np.float32),
             "label": rng.integers(0, 2, 8).astype(np.int64), "class_name": ["a"] * 8}
    out = multihost.global_device_batch(mesh, batch, global_batch=8)
    assert out["class_name"] == ["a"] * 8
    np.testing.assert_array_equal(out["image"].numpy(), batch["image"][4:])
    local = multihost.global_device_batch(mesh, {"label": batch["label"][4:]}, 8)
    np.testing.assert_array_equal(local["label"].numpy(), batch["label"][4:])
    with pytest.raises(ValueError, match="rows"):
        multihost.global_device_batch(mesh, {"label": batch["label"][:3]}, 8)
    shard = tmesh.shard_batch(mesh, batch)
    np.testing.assert_array_equal(shard["label"].numpy(), batch["label"][4:])


def test_multihost_noop_without_optin(monkeypatch):
    monkeypatch.delenv("AACLIP_MULTIHOST", raising=False)
    assert multihost.maybe_initialize() is False
    assert not torch.distributed.is_initialized()
    for key in ("RANK", "WORLD_SIZE"):
        monkeypatch.delenv(key, raising=False)
    assert multihost.data_parallel_mesh("cpu") == (None, "cpu")
    assert multihost.is_primary()


# ----------------------------------------------------------------------
# The CLIs under torchrun
# ----------------------------------------------------------------------

def test_cli_data_parallel_under_torchrun(tmp_path):
    """``--data_parallel`` under ``torchrun --nproc_per_node 2`` on gloo:
    cli.train writes from rank 0 only and ends on one process's adapters;
    cli.evaluate prints one table, one process's."""
    import subprocess
    import sys

    from aa_clip_iqm_tpu_torch import configs
    from aa_clip_iqm_tpu_torch.loader import init_trainable
    from aa_clip_iqm_tpu_torch.models.convert import tree_leaves
    from aa_clip_iqm_tpu_torch.train.checkpoint import restore_adapters

    root = str(tmp_path)
    tsynthetic.generate(os.path.join(root, "staging"), n_normal=3, n_anomalous=4, size=IMG,
                        class_names=("bottle",), seed=3, dataset_name="MVTec-AD")
    os.makedirs(os.path.join(root, "data"))
    os.rename(os.path.join(root, "staging", "MVTec-AD"), os.path.join(root, "data", "MVTec-AD"))
    os.makedirs(os.path.join(root, "metadata", "MVTec"))
    os.rename(os.path.join(root, "staging", "metadata", "MVTec-AD", "full-shot.jsonl"),
              os.path.join(root, "metadata", "MVTec", "full-shot.jsonl"))
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {**os.environ, "AACLIP_DATA_ROOT": os.path.join(root, "data"), "PYTHONPATH": repo,
           "OMP_NUM_THREADS": "1"}
    common = ["--dataset", "MVTec", "--device", "cpu", "--model_name", "tiny-test",
              "--img_size", str(IMG), "--compute_dtype", "float32", "--random_backbone",
              "--metadata_root", os.path.join(root, "metadata"), "--seed", "7",
              "--image_batch_size", "4"]
    train = ["--training_mode", "full_shot", "--text_epoch", "0", "--image_epoch", "1"]
    torchrun = [sys.executable, "-m", "torch.distributed.run", "--standalone",
                "--nproc_per_node", "2", "-m"]

    def run(cmd, save):
        res = subprocess.run([*cmd, *common, "--save_path", os.path.join(root, save)],
                             capture_output=True, text=True, cwd=repo, env=env, timeout=120)
        assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-3000:]
        return res.stdout

    run([*torchrun, "aa_clip_iqm_tpu_torch.cli.train", "--data_parallel", *train], "dp")
    run([sys.executable, "-m", "aa_clip_iqm_tpu_torch.cli.train", *train], "one")
    assert sorted(os.listdir(os.path.join(root, "dp"))) == [
        "image_adapter", "image_adapter_1", "scalars.jsonl", "train.log"]
    with open(os.path.join(root, "dp", "train.log")) as f:
        assert "data-parallel over 2 ranks (gloo)" in f.read()
    cfg = configs.tiny_test_config(IMG)
    dp, _, _ = restore_adapters(os.path.join(root, "dp"), init_trainable(cfg, device="cpu"))
    one, _, _ = restore_adapters(os.path.join(root, "one"), init_trainable(cfg, device="cpu"))
    for a, b in zip(tree_leaves(dp), tree_leaves(one)):
        np.testing.assert_allclose(a.float().numpy(), b.float().numpy(), rtol=1e-4, atol=1e-5)
    table_dp = run([*torchrun, "aa_clip_iqm_tpu_torch.cli.evaluate", "--data_parallel"], "dp")
    table_one = run([sys.executable, "-m", "aa_clip_iqm_tpu_torch.cli.evaluate"], "dp")
    assert table_dp.count("Average") == 1
    assert table_dp.strip().splitlines()[-3:] == table_one.strip().splitlines()[-3:]
