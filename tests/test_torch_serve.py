"""The port's HTTP front end (cli.serve) and its single-image and evaluation
CLIs, on the CPU with tiny_test_config(56): the cases of tests/test_serve.py
against a live server on an ephemeral port, and cli.single_image /
cli.evaluate --import_reference --visualize against the JAX package's CLIs
on the same inputs (float32 on both sides; maps to 1e-4 of their largest
value, metric rows to 0.02 points)."""
import base64
import io
import json
import os
import sys
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest
import torch

from aa_clip_iqm_tpu import configs as jconfigs
from aa_clip_iqm_tpu.models import adapters as jadapters
from aa_clip_iqm_tpu.train import checkpoint as jckpt
from aa_clip_iqm_tpu_torch import configs as tconfigs
from aa_clip_iqm_tpu_torch.cli import evaluate as tcli_eval
from aa_clip_iqm_tpu_torch.cli import serve as tcli_serve
from aa_clip_iqm_tpu_torch.cli import single_image as tcli_single
from aa_clip_iqm_tpu_torch.cli.serve import build_parser, make_server, serve_forever_in_thread
from aa_clip_iqm_tpu_torch.evaluation.predict import METRIC_KEYS
from aa_clip_iqm_tpu_torch.models.convert import params_from_jax
from aa_clip_iqm_tpu_torch.serving import AnomalyDetector, MicroBatchingService
from aa_clip_iqm_tpu_torch.train import checkpoint as tckpt
from test_torch_serving import (
    IMG,
    TIMEOUT,
    bridged_trainable,
    close_rel,
    data,  # noqa: F401  (a fixture)
    image_paths,
    write_pt,
)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def server_stack(tmp_path_factory, data):  # noqa: F811
    """A detector from a .pt with the JAX package's initial adapters
    (classes widget and gizmo) -> micro-batcher -> a live HTTP server on an
    ephemeral port; each predict_multi call (one device batch) is
    counted."""
    tpt, _ = write_pt(str(tmp_path_factory.mktemp("servept")))
    from aa_clip_iqm_tpu_torch import loader

    frozen = loader.load_frozen_backbone(tconfigs.tiny_test_config(IMG), tpt,
                                         device="cpu", dtype=torch.float32)
    det = AnomalyDetector(frozen, bridged_trainable(), tconfigs.tiny_test_config(IMG),
                          "Synth", img_size=IMG, adapted_text=False,
                          compute_dtype=torch.float32, batch_buckets=(1, 4, 8),
                          device="cpu")
    batches = []
    predict_multi = det.predict_multi

    def counting(images, names):
        batches.append(len(names))
        return predict_multi(images, names)

    det.predict_multi = counting
    svc = MicroBatchingService(det, max_batch=8, max_latency_ms=50.0)
    server = make_server(svc, IMG, {"source": "test", "dataset": "Synth",
                                    "classes": det.class_names()},
                         host="127.0.0.1", port=0, request_timeout=TIMEOUT)
    thread = serve_forever_in_thread(server)
    try:
        yield "http://%s:%d" % server.server_address, det, data[0], batches
    finally:
        server.shutdown()
        server.server_close()
        svc.close()
        thread.join(timeout=TIMEOUT)


def _get(url):
    with urllib.request.urlopen(url, timeout=TIMEOUT) as r:
        return r.status, json.loads(r.read())


def _post(url, body, content_type):
    req = urllib.request.Request(url, data=body, headers={"Content-Type": content_type})
    try:
        with urllib.request.urlopen(req, timeout=TIMEOUT) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _npy_bytes(arr):
    buf = io.BytesIO()
    np.save(buf, arr)
    return buf.getvalue()


def _decode_map(entry):
    assert entry["encoding"] == "npy"
    return np.load(io.BytesIO(base64.b64decode(entry["b64"])), allow_pickle=False)


def _image(seed):
    return np.random.default_rng(seed).standard_normal((3, IMG, IMG)).astype(np.float32)


def test_health_and_classes(server_stack):
    base, det, _, _ = server_stack
    status, body = _get(base + "/v1/health")
    assert status == 200 and body["status"] == "ok"
    assert body["img_size"] == IMG and body["dataset"] == "Synth"
    assert sorted(body["classes"]) == sorted(det.class_names())
    status, body = _get(base + "/v1/classes")
    assert status == 200 and "widget" in body["classes"]


def test_stats_answers_the_counters(server_stack):
    """GET /v1/stats answers the process's counters: a request adds one to
    the service's requests and to the detector's device rows, and seconds
    to the handler's decode and encode."""
    base, _, _, _ = server_stack
    status, before = _get(base + "/v1/stats")
    assert status == 200 and isinstance(before, dict)
    status, _ = _post(base + "/v1/predict?class_name=widget", _npy_bytes(_image(5)),
                      "application/octet-stream")
    assert status == 200
    status, after = _get(base + "/v1/stats")
    assert status == 200
    assert after["serve.requests"] == before.get("serve.requests", 0) + 1
    assert after["predict.rows"] == before.get("predict.rows", 0) + 1
    for key in ("serve.queue_wait_s", "http.decode_s", "http.encode_s"):
        assert after[key] > before.get(key, 0.0), key


def test_predict_npy_roundtrip(server_stack):
    """The .npy route: the score and map of the detector called directly;
    map=none answers the score alone."""
    base, det, _, _ = server_stack
    image = _image(1)
    status, body = _post(base + "/v1/predict?class_name=widget", _npy_bytes(image),
                         "application/octet-stream")
    assert status == 200
    ref_maps, ref_scores = det.predict(image[None], "widget")
    close_rel(body["score"], ref_scores[0])
    amap = _decode_map(body["map"])
    assert amap.shape == (IMG, IMG)
    close_rel(amap, ref_maps[0])
    status, body = _post(base + "/v1/predict?class_name=widget&map=none",
                         _npy_bytes(image), "application/octet-stream")
    assert status == 200 and "map" not in body
    # The class may come in the X-Class-Name header instead.
    req = urllib.request.Request(base + "/v1/predict", data=_npy_bytes(image), headers={
        "Content-Type": "application/octet-stream", "X-Class-Name": "gizmo"})
    with urllib.request.urlopen(req, timeout=TIMEOUT) as r:
        body = json.loads(r.read())
    close_rel(body["score"], det.predict(image[None], "gizmo")[1][0])


def test_predict_json_image_file(server_stack):
    """JSON with base64 image-file bytes: the server's decode matches
    predict_paths on the same file."""
    base, det, root, _ = server_stack
    path = image_paths(root, 1)[0]
    with open(path, "rb") as f:
        raw = f.read()
    payload = json.dumps({"class_name": "widget",
                          "image_b64": base64.b64encode(raw).decode()}).encode()
    status, body = _post(base + "/v1/predict", payload, "application/json")
    assert status == 200
    ref_maps, ref_scores = det.predict_paths([path], "widget")
    close_rel(body["score"], ref_scores[0])
    close_rel(_decode_map(body["map"]), ref_maps[0])


def test_predict_png_overlay(server_stack):
    cv2 = pytest.importorskip("cv2")
    base, _, _, _ = server_stack
    status, body = _post(base + "/v1/predict?class_name=widget&map=png",
                         _npy_bytes(_image(2)), "application/octet-stream")
    assert status == 200 and body["map"]["encoding"] == "png"
    png = np.frombuffer(base64.b64decode(body["map"]["b64"]), np.uint8)
    assert cv2.imdecode(png, cv2.IMREAD_COLOR).shape == (IMG, IMG, 3)


def test_predict_batch_mixed_classes(server_stack):
    """One batch request of mixed classes; an unknown class fails only its
    own item."""
    base, det, _, _ = server_stack
    images = np.stack([_image(10 + i) for i in range(3)])
    names = ["widget", "gizmo", "widget"]
    reqs = [{"class_name": c, "npy_b64": base64.b64encode(_npy_bytes(images[i])).decode()}
            for i, c in enumerate(names)]
    reqs.append({"class_name": "nope",
                 "npy_b64": base64.b64encode(_npy_bytes(images[0])).decode()})
    status, body = _post(base + "/v1/predict_batch", json.dumps({"requests": reqs}).encode(),
                         "application/json")
    assert status == 200
    results = body["results"]
    assert len(results) == 4
    for i, c in enumerate(names):
        ref_maps, ref_scores = det.predict(images[i:i + 1], c)
        close_rel(results[i]["score"], ref_scores[0])
        close_rel(_decode_map(results[i]["map"]), ref_maps[0])
    assert results[3]["status"] == 404 and "unknown class" in results[3]["error"]


def test_concurrent_requests_coalesce(server_stack):
    """Parallel clients all succeed, and ride fewer device batches than
    there are requests."""
    base, det, _, batches = server_stack
    images = [_image(20 + i) for i in range(8)]
    names = ["widget", "gizmo"] * 4

    def call(i):
        return _post(base + f"/v1/predict?class_name={names[i]}&map=none",
                     _npy_bytes(images[i]), "application/octet-stream")

    before = len(batches)
    with ThreadPoolExecutor(max_workers=8) as ex:
        out = list(ex.map(call, range(8), timeout=TIMEOUT))
    dispatched = batches[before:]
    assert sum(dispatched) == 8 and len(dispatched) < 8, dispatched
    for i, (status, body) in enumerate(out):
        assert status == 200
        close_rel(body["score"], det.predict(images[i][None], names[i])[1][0])


ERRORS = {
    "unknown endpoint": ("/v1/nope", b"x", "application/octet-stream", 404, "no such"),
    "missing class": ("/v1/predict", "npy", "application/octet-stream", 400, "class"),
    "unknown class": ("/v1/predict?class_name=nope", "npy", "application/octet-stream",
                      404, "unknown class"),
    "wrong shape": ("/v1/predict?class_name=widget", "npy_small",
                    "application/octet-stream", 400, "expected"),
    "invalid npy": ("/v1/predict?class_name=widget", b"not an npy",
                    "application/octet-stream", 400, "invalid .npy"),
    "invalid json": ("/v1/predict", b"{broken", "application/json", 400, "invalid JSON"),
    "empty batch": ("/v1/predict_batch", b'{"requests": []}', "application/json", 400,
                    "non-empty"),
    "bad map mode": ("/v1/predict?class_name=widget&map=wat", "npy",
                     "application/octet-stream", 400, "map must be"),
    "bad base64": ("/v1/predict", b'{"class_name": "widget", "image_b64": "@@"}',
                   "application/json", 400, "invalid base64"),
}


@pytest.mark.parametrize("case", ERRORS.values(), ids=ERRORS.keys())
def test_error_mapping(server_stack, case):
    base, _, _, _ = server_stack
    path, body, ctype, want_status, want_text = case
    image = _image(3)
    body = {"npy": _npy_bytes(image), "npy_small": _npy_bytes(image[:, :8])}.get(body, body)
    status, reply = _post(base + path, body, ctype)
    assert status == want_status and want_text in reply["error"], reply


def test_error_closes_keepalive_connection(server_stack):
    """An error answered before the body was read closes the keep-alive
    connection; the server goes on answering."""
    import http.client

    base, _, _, _ = server_stack
    host, port = base.removeprefix("http://").split(":")
    conn = http.client.HTTPConnection(host, int(port), timeout=TIMEOUT)
    try:
        conn.request("POST", "/v1/nope", body=b"x" * 1024,
                     headers={"Content-Type": "application/octet-stream"})
        resp = conn.getresponse()
        assert resp.status == 404
        assert resp.getheader("Connection", "").lower() == "close"
        resp.read()
    finally:
        conn.close()
    status, body = _get(base + "/v1/health")
    assert status == 200 and body["status"] == "ok"


def test_serve_parser_defaults():
    """The server runs on the card unless told otherwise; --exported is a
    model source of its own, exclusive of --save_path, as in the JAX CLI."""
    args = build_parser().parse_args([])
    assert args.device == "cuda" and args.max_batch == 32 and args.port == 8000
    assert args.exported is None
    assert build_parser().parse_args(["--exported", "x"]).exported == "x"
    with pytest.raises(SystemExit):
        tcli_serve.main(["--exported", "x", "--save_path", "y"])


# --------------------------------------------------------------------------
# cli.serve --exported against the JAX CLI's
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def exported_stack(tmp_path_factory, data):  # noqa: F811
    """One .pt's zero-shot detectors of both packages (buckets 1 and 4),
    each exported by its own package; the port's cli.serve model source for
    --exported behind a live HTTP server on an ephemeral port."""
    import jax.numpy as jnp

    from aa_clip_iqm_tpu import serving as jserving
    from aa_clip_iqm_tpu_torch import loader
    from aa_clip_iqm_tpu_torch.serving import export_predictor

    tmp = tmp_path_factory.mktemp("exported")
    tpt, _ = write_pt(str(tmp / "port"))
    jpt, _ = write_pt(str(tmp / "jax"))
    cfg = tconfigs.tiny_test_config(IMG)
    det = AnomalyDetector(loader.load_frozen_backbone(cfg, tpt, device="cpu",
                                                      dtype=torch.float32),
                          bridged_trainable(), cfg, "Synth", img_size=IMG, adapted_text=False,
                          compute_dtype=torch.float32, batch_buckets=(1, 4), device="cpu")
    jdet = jserving.AnomalyDetector.from_checkpoint(
        None, "Synth", img_size=IMG, backbone=jpt, model_name="tiny-test",
        compute_dtype=jnp.float32, use_pallas=False, batch_buckets=(1, 4))
    tout, jout = str(tmp / "port_exported"), str(tmp / "jax_exported")
    export_predictor(det, tout, batch_sizes=(1, 4))
    jserving.export_predictor(jdet, jout, batch_sizes=(1, 4))
    args = build_parser().parse_args(["--exported", tout, "--device", "cpu"])
    pred, meta, img_size = tcli_serve.load_model(args)
    svc = MicroBatchingService(pred, max_batch=4, max_latency_ms=50.0)
    server = make_server(svc, img_size, meta, host="127.0.0.1", port=0,
                         request_timeout=TIMEOUT)
    thread = serve_forever_in_thread(server)
    try:
        yield ("http://%s:%d" % server.server_address, pred, meta,
               jserving.ExportedPredictor(jout), tout)
    finally:
        server.shutdown()
        server.server_close()
        svc.close()
        thread.join(timeout=TIMEOUT)


def test_serve_exported_health_matches_jax_cli(exported_stack):
    """/v1/health reports what the JAX CLI's does for --exported: the
    source, the manifest's dataset and buckets, the artifact's classes."""
    base, pred, meta, jpred, _ = exported_stack
    assert meta == {"source": "exported", "dataset": jpred.manifest["dataset"],
                    "classes": jpred.class_names(),
                    "batch_sizes": jpred.manifest["batch_sizes"]}
    status, body = _get(base + "/v1/health")
    assert status == 200 and body == {"status": "ok", **meta, "img_size": IMG}


def test_serve_exported_predict_matches_jax_artifact(exported_stack):
    """Concurrent .npy requests of two classes through the port's server
    over its artifact give the JAX artifact's maps and scores."""
    base, _, _, jpred, _ = exported_stack
    images = [_image(20 + i) for i in range(3)]
    names = ["widget", "gizmo", "widget"]
    with ThreadPoolExecutor(max_workers=3) as ex:
        replies = list(ex.map(
            lambda i: _post(f"{base}/v1/predict?class_name={names[i]}",
                            _npy_bytes(images[i]), "application/octet-stream"),
            range(3), timeout=TIMEOUT))
    ref_maps, ref_scores = jpred.predict_multi(np.stack(images), names)
    for (status, body), amap, score in zip(replies, ref_maps, ref_scores):
        assert status == 200
        close_rel(_decode_map(body["map"]), amap)
        close_rel(body["score"], score)
    status, body = _post(f"{base}/v1/predict?class_name=nope", _npy_bytes(images[0]),
                         "application/octet-stream")
    assert status == 404 and "unknown class" in body["error"]


def test_serve_exported_refuses_what_the_jax_cli_refuses(exported_stack):
    """--exported with --save_path is a usage error in both CLIs; an
    artifact for the CPU does not load on another device type."""
    from aa_clip_iqm_tpu.cli import serve as jcli_serve

    *_, tout = exported_stack
    for main in (jcli_serve.main, tcli_serve.main):
        with pytest.raises(SystemExit):
            main(["--exported", tout, "--save_path", "y"])
    with pytest.raises(ValueError, match="exported for cpu"):
        tcli_serve.load_model(build_parser().parse_args(["--exported", tout]))


# --------------------------------------------------------------------------
# cli.single_image and cli.evaluate against the JAX CLIs
# --------------------------------------------------------------------------

def _run_jax_cli(module, argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", [module.__name__] + argv)
    module.main()


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """One set of perturbed adapters (JAX initialization + seeded noise),
    saved by each package's own stage-1 and stage-2 writers."""
    cfg = jconfigs.tiny_test_config(IMG)
    jt = jadapters.init_adapter_params(jax.random.PRNGKey(3), cfg)
    rng = np.random.default_rng(9)
    jt = jax.tree.map(lambda x: np.asarray(x) + 0.05 * rng.standard_normal(x.shape)
                      .astype(np.float32), jt)
    root = tmp_path_factory.mktemp("ckpts")
    jpath, tpath = str(root / "jax"), str(root / "port")
    jckpt.save_stage1(jpath, 1, jt["text_adapter"], None)
    jckpt.save_stage2(jpath, 2, jt, None)
    _, tt = params_from_jax(None, jt, tconfigs.tiny_test_config(IMG), device="cpu",
                            dtype=torch.float32)
    tckpt.save_stage1(tpath, 1, tt["text_adapter"], None)
    tckpt.save_stage2(tpath, 2, tt, None)
    return jpath, tpath


@pytest.mark.parametrize("route", ["zero_shot", "checkpoint"])
def test_cli_single_image_matches_jax(tmp_path, data, checkpoints, monkeypatch,  # noqa: F811
                                      capsys, route):
    """Both routes of cli.single_image from the same .pt and image: the
    zero-shot surgery map and the adapted predict program's map, saved as
    .npy, against the JAX CLI's."""
    from aa_clip_iqm_tpu.cli import single_image as jcli_single

    path = image_paths(data[0], 1)[0]
    maps = {}
    for who in ("port", "jax"):
        pt, _ = write_pt(str(tmp_path / who))
        out = str(tmp_path / f"{who}.png")
        argv = ["--model_name", "tiny-test", "--img_size", str(IMG), "--image_path", path,
                "--class_name", "bottle", "--backbone", pt, "--compute_dtype", "float32",
                "--out", out]
        if route == "checkpoint":
            argv += ["--save_path", checkpoints[0 if who == "jax" else 1]]
        if who == "port":
            amap, score = tcli_single.main(argv + ["--device", "cpu"])
        else:
            _run_jax_cli(jcli_single, argv, monkeypatch)
        maps[who] = np.load(str(tmp_path / f"{who}.npy"))
    np.testing.assert_array_equal(maps["port"], amap)
    assert maps["port"].shape == (IMG, IMG) and np.isfinite(maps["port"]).all()
    close_rel(maps["port"], maps["jax"])
    printed = capsys.readouterr().out
    assert printed.count("image anomaly score") == 2
    if route == "zero_shot":
        np.testing.assert_allclose(score, maps["port"].max(), rtol=1e-6)


def test_cli_single_image_visualize(tmp_path, data):  # noqa: F811
    cv2 = pytest.importorskip("cv2")
    pt, _ = write_pt(str(tmp_path))
    out = str(tmp_path / "overlay.png")
    tcli_single.main(["--model_name", "tiny-test", "--img_size", str(IMG),
                      "--image_path", image_paths(data[0], 1)[0], "--backbone", pt,
                      "--compute_dtype", "float32", "--device", "cpu",
                      "--visualize", "--out", out])
    assert cv2.imread(out).shape == (IMG, IMG, 3)


def _reference_pths(directory, relu, seed=11):
    """The reference's text_adapter.pth and image_adapter_{N}.pth for the
    tiny config (torch Linear weights)."""
    cfg = tconfigs.tiny_test_config(IMG)
    rng = np.random.default_rng(seed)
    tw, vw, out_dim = cfg.clip.text.width, cfg.clip.vision.width, cfg.clip.embed_dim

    def w(o, i):
        return torch.from_numpy((0.1 * rng.standard_normal((o, i))).astype(np.float32))

    n = cfg.adapter.text_adapt_until
    proj = "fc.0.weight" if relu else "fc.weight"
    image = {f"layer_adapters.{i}.fc.0.weight": w(vw, vw)
             for i in range(cfg.adapter.image_adapt_until)}
    image.update({f"seg_proj.{i}.{proj}": w(out_dim, vw) for i in range(len(cfg.adapter.levels))})
    image[f"det_proj.{proj}"] = w(out_dim, vw)
    os.makedirs(directory, exist_ok=True)
    torch.save({"text_adapter": {f"{i}.fc.0.weight": w(tw, tw) for i in range(n + 1)}},
               os.path.join(directory, "text_adapter.pth"))
    torch.save({"image_adapter": image}, os.path.join(directory, "image_adapter_2.pth"))


def _parse_table(text):
    """{class name: [4 metrics]} from a printed results table."""
    rows = {}
    for line in text.splitlines():
        parts = line.split()
        if len(parts) == 5 and parts[0] != "class":
            try:
                rows[parts[0]] = [float(v) for v in parts[1:]]
            except ValueError:
                pass
    return rows


@pytest.mark.parametrize("relu", [False, True], ids=["no_relu", "relu"])
def test_cli_evaluate_import_reference_visualize_matches_jax(tmp_path, data, monkeypatch,  # noqa: F811
                                                             capsys, relu):
    """cli.evaluate --import_reference --visualize: the reference .pth
    adapters imported, the metric table and the heatmap files of the JAX
    CLI on the same .pt, data and checkpoint files. The reference never
    saves the IQM family, so it keeps its initialization: the port's CLI
    starts from the JAX CLI's (seed 111) here."""
    cv2 = pytest.importorskip("cv2")
    from aa_clip_iqm_tpu.cli import evaluate as jcli_eval

    monkeypatch.setattr(tcli_eval, "init_trainable", lambda cfg, **kw: bridged_trainable())
    _, meta_root = data
    tables, out_dirs = {}, {}
    for who in ("port", "jax"):
        pt, _ = write_pt(str(tmp_path / who / "weights"))
        save = str(tmp_path / who / "ckpt")
        _reference_pths(save, relu)
        argv = ["--model_name", "tiny-test", "--img_size", str(IMG), "--dataset", "Synth",
                "--backbone", pt, "--import_reference", "--visualize",
                "--image_batch_size", "4", "--metadata_root", meta_root,
                "--save_path", save, "--compute_dtype", "float32"]
        if relu:
            argv.append("--relu")
        if who == "port":
            rows = tcli_eval.main(argv + ["--device", "cpu"])
        else:
            _run_jax_cli(jcli_eval, argv, monkeypatch)
        tables[who] = _parse_table(capsys.readouterr().out)
        out_dirs[who] = os.path.join(save, "visualization", "Synth")
    assert [r["class name"] for r in rows] == ["widget", "gizmo", "Average"]
    assert tables["port"].keys() == tables["jax"].keys() == {"widget", "gizmo", "Average"}
    for name, want in tables["jax"].items():
        np.testing.assert_allclose(tables["port"][name], want, atol=0.02)
        row = next(r for r in rows if r["class name"] == name)
        np.testing.assert_allclose([row[k] for k in METRIC_KEYS], want, atol=0.02)
    for cls in ("widget", "gizmo"):
        names = sorted(os.listdir(os.path.join(out_dirs["jax"], cls)))
        assert len(names) == 6
        assert sorted(os.listdir(os.path.join(out_dirs["port"], cls))) == names
        for n in names:
            a, b = (cv2.imread(os.path.join(out_dirs[w], cls, n)).astype(np.int16)
                    for w in ("port", "jax"))
            assert a.shape == b.shape == (3 * IMG, IMG, 3)
            # The maps agree to float noise, so a pixel's uint8 heat may be
            # one step apart: a JET channel then moves by up to 4, which the
            # 0.5 blend halves (and its truncation may add one).
            assert np.abs(a - b).max() <= 3 and (a != b).mean() < 0.01, (a != b).mean()
