"""The port's data layer against the JAX package's, on the CPU: get_dataset
called with the same positional and keyword arguments in both packages gives
the same datasets (test, visualize, few-shot and full-shot train), and the
TrainDataset / SingleClassTestDataset batch streams (``__getitem__``,
``batches(shuffle, drop_last)``, ``epoch_batches``, ``pad_to_batch``) equal
JAX's bit for bit at AACLIP_DATA_WORKERS 1 and 3, on a synthetic dataset
written at the model's image size (so that neither package resizes, and
JAX's transform backend and the port's agree exactly, as in
tests/test_torch_train_driver.py). Tolerance: none, every array is compared
with assert_array_equal."""
import json
import logging
import os

import numpy as np
import pytest

from aa_clip_iqm_tpu.data import datasets as jdatasets
from aa_clip_iqm_tpu.data import synthetic as jsynthetic
from aa_clip_iqm_tpu_torch.data import datasets as tdatasets
from aa_clip_iqm_tpu_torch.data import synthetic as tsynthetic

IMG = 56
CLASSES = ("widget", "gadget")
SHOT = 2


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """5 images a class (3 with a defect), registered with both packages,
    and a 2-shot metadata file beside the full-shot one."""
    root = str(tmp_path_factory.mktemp("synth"))
    tsynthetic.generate(root, n_normal=2, n_anomalous=3, size=IMG,
                        class_names=CLASSES, seed=5)
    meta_root = tsynthetic.register_synthetic(root, CLASSES)
    assert jsynthetic.register_synthetic(root, CLASSES) == meta_root
    meta_dir = os.path.join(meta_root, "Synth")
    rows = tdatasets.load_metadata(os.path.join(meta_dir, "full-shot.jsonl"))
    few = [r for c in CLASSES for r in [r for r in rows if r["class_name"] == c][-SHOT:]]
    with open(os.path.join(meta_dir, f"{SHOT}-shot.jsonl"), "w") as f:
        f.writelines(json.dumps(r) + "\n" for r in few)
    return root, meta_root


@pytest.fixture
def workers(monkeypatch):
    def set_workers(n):
        monkeypatch.setenv("AACLIP_DATA_WORKERS", str(n))

    return set_workers


class _Lines(logging.Handler):
    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def _logger(name):
    logger = logging.getLogger(name)
    logger.setLevel(logging.INFO)
    handler = _Lines()
    logger.handlers = [handler]
    logger.propagate = False
    return logger, handler


def _same_batches(got, want):
    got, want = list(got), list(want)
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        assert a["file_name"] == b["file_name"] and a["class_name"] == b["class_name"]
        assert a.get("n_valid") == b.get("n_valid")
        for key in ("image", "mask", "label"):
            assert a[key].dtype == b[key].dtype
            np.testing.assert_array_equal(a[key], b[key])


LOG = object()   # where a call passes the logger: each package's own


# (positional arguments after (name, img_size), keyword arguments): JAX's
# positional form, its keyword form, and the defaults.
CALLS = {
    "test_positional": ((None, -1, "test", LOG), {"device_normalize": True}),
    "test_keywords": ((), {"training_mode": None, "stage": "test", "logger": LOG}),
    "visualize": ((None,), {"stage": "visualize", "logger": LOG, "device_normalize": True}),
    "few_shot_positional": (("few_shot", SHOT, "train", LOG), {"seed": 7}),
    "full_shot_default_stage": (("full_shot",), {}),
}


@pytest.mark.parametrize("call", CALLS.values(), ids=CALLS.keys())
def test_get_dataset_same_arguments_same_datasets(data, call):
    """C1: the port's get_dataset has JAX's signature, order and defaults
    (stage "train"; "visualize" is the test split without the logger)."""
    _, meta_root = data
    out, lines = [], []
    for pkg in (jdatasets, tdatasets):
        logger, handler = _logger(f"get_dataset.{pkg.__name__}")
        args = [logger if a is LOG else a for a in call[0]]
        kwargs = {k: logger if v is LOG else v for k, v in call[1].items()}
        out.append(pkg.get_dataset("Synth", IMG, *args, metadata_root=meta_root, **kwargs))
        lines.append(handler.lines)
    jsets, tsets = out
    assert lines[1] == lines[0]
    if isinstance(jsets, dict):
        assert list(tsets) == list(jsets) == list(CLASSES)
        assert bool(lines[1]) == (call[1].get("stage") != "visualize")
        for c in CLASSES:
            assert len(tsets[c]) == len(jsets[c]) == 5
            _same_batches(tsets[c].batches(2), jsets[c].batches(2))
        return
    want_len = 2 * SHOT if call[0][0] == "few_shot" else 10
    for t, j in zip(tsets, jsets):
        assert (len(t), t.text, t.seed) == (len(j), j.text, j.seed)
        assert len(t) == want_len
        _same_batches(t.epoch_batches(1, 3), j.epoch_batches(1, 3))


def test_get_dataset_errors_as_jax(data):
    _, meta_root = data
    for pkg in (jdatasets, tdatasets):
        with pytest.raises(TypeError):
            pkg.get_dataset("Synth", IMG)            # training_mode has no default
        with pytest.raises(KeyError, match="not found"):
            pkg.get_dataset("Nope", IMG, None)
        with pytest.raises(ValueError, match="stage val not found"):
            pkg.get_dataset("Synth", IMG, None, stage="val", metadata_root=meta_root)
        with pytest.raises(ValueError, match="shot should be positive"):
            pkg.get_dataset("Synth", IMG, "few_shot", metadata_root=meta_root)


def _train_pair(data, text):
    _, meta_root = data
    pick = 0 if text else 1
    return (tdatasets.get_dataset("Synth", IMG, "full_shot", metadata_root=meta_root,
                                  seed=4)[pick],
            jdatasets.get_dataset("Synth", IMG, "full_shot", metadata_root=meta_root,
                                  seed=4)[pick])


@pytest.mark.parametrize("text", [True, False], ids=["stage1", "stage2"])
def test_train_getitem_draws_the_sequential_stream(data, text):
    tds, jds = _train_pair(data, text)
    for i in (3, 0, 3, 9):
        got, want = tds[i], jds[i]
        assert got["file_name"] == want["file_name"]
        for key in ("image", "mask", "label"):
            np.testing.assert_array_equal(got[key], want[key])


@pytest.mark.parametrize("n_workers", [1, 3])
@pytest.mark.parametrize("shuffle,drop_last", [(True, False), (False, True)])
def test_train_batches_equal_jax(data, workers, n_workers, shuffle, drop_last):
    """workers = 1 keeps the sequential stream; workers > 1 draws each sample
    from its own counter stream, as JAX's pool does. Two passes, so the
    shuffle generator and the draw counter carry over."""
    workers(n_workers)
    tds, jds = _train_pair(data, text=False)
    for _ in range(2):
        got = list(tds.batches(4, shuffle=shuffle, drop_last=drop_last))
        assert [b["image"].shape[0] for b in got] == ([4, 4] if drop_last else [4, 4, 2])
        _same_batches(got, jds.batches(4, shuffle=shuffle, drop_last=drop_last))
    assert tds._draws == jds._draws == (0 if n_workers == 1 else 16 if drop_last else 20)


def test_pooled_batches_differ_from_the_serial_stream(data, workers):
    tds, _ = _train_pair(data, text=False)
    serial = next(tds.batches(4, shuffle=False))
    workers(3)
    tds, _ = _train_pair(data, text=False)
    pooled = next(tds.batches(4, shuffle=False))
    assert serial["file_name"] == pooled["file_name"]
    assert not np.array_equal(serial["image"], pooled["image"])


@pytest.mark.parametrize("text", [True, False], ids=["stage1", "stage2"])
def test_epoch_batches_equal_for_any_worker_count(data, workers, text):
    streams = {}
    for n in (1, 3):
        workers(n)
        tds, jds = _train_pair(data, text)
        streams[n] = list(tds.epoch_batches(2, 4, start_batch=1))
        _same_batches(streams[n], jds.epoch_batches(2, 4, start_batch=1))
    _same_batches(streams[3], streams[1])


@pytest.mark.parametrize("n_workers", [1, 3])
@pytest.mark.parametrize("normalize", [True, False], ids=["uint8", "float32"])
def test_test_batches_pad_to_batch_equal_jax(data, workers, n_workers, normalize):
    """Order-kept parallel decode and the zero-padded tail."""
    workers(n_workers)
    _, meta_root = data
    tsets = tdatasets.get_dataset("Synth", IMG, None, -1, "test", metadata_root=meta_root,
                                  device_normalize=normalize)
    jsets = jdatasets.get_dataset("Synth", IMG, None, -1, "test", metadata_root=meta_root,
                                  device_normalize=normalize)
    for pad in (True, False):
        got = list(tsets["gadget"].batches(3, pad_to_batch=pad))
        assert [b["image"].shape[0] for b in got] == ([3, 3] if pad else [3, 2])
        assert [b["n_valid"] for b in got] == [3, 2]
        _same_batches(got, jsets["gadget"].batches(3, pad_to_batch=pad))
    padded = list(tsets["gadget"].batches(3, pad_to_batch=True))[-1]
    assert not padded["image"][2:].any() and not padded["mask"][2:].any()
    assert not padded["label"][2:].any() and len(padded["file_name"]) == 2
