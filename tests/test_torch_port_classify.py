"""The port's classifier serving against the JAX package's, on the tiny
preset on the CPU: `ClassifierEngine` (a two-fold ensemble, f32 and int8),
`from_work_dir` over the files the port's `BestModelTracker` writes,
`POST /predict`, the nested `/stats`, NIfTI bodies, `reset_stats` and
`serve --task classify` from the CLI."""

import gzip
import io
import json
import os
import signal
import subprocess
import sys
import threading
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_port_quant import tiny_vit_tree
from vit_ae_plus_plus_tpu.serving import ClassifierEngine as JaxClassifierEngine
from vit_ae_plus_plus_torch.configs import ViTConfig
from vit_ae_plus_plus_torch.models import VisionTransformer3D
from vit_ae_plus_plus_torch.pipelines.finetune import BestModelTracker
from vit_ae_plus_plus_torch.serving import BatchingQueue, ClassifierEngine, FeatureEngine, make_http_server
from vit_ae_plus_plus_torch.train.checkpoint import params_from_jax
from vit_ae_plus_plus_torch.utils.nifti import write_nifti

REPO = Path(__file__).resolve().parents[1]
TINY = "contr_mae_vit_tiny_patch4"
VOL = 16
KW = dict(model_name=TINY, volume_size=VOL, patch_size=4, batch_size=4, compute_dtype="float32")
PROB_TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _vols(n, seed):
    return np.random.default_rng(seed).standard_normal((n, 1, VOL, VOL, VOL)).astype(np.float32)


@pytest.fixture(scope="module")
def folds():
    return [tiny_vit_tree(10 + k) for k in range(2)]


@pytest.fixture(scope="module")
def work_dir(folds, tmp_path_factory):
    """A finetune-kfold work dir as the port writes it: each fold's best
    models through `BestModelTracker`, and stray files beside them."""
    work = tmp_path_factory.mktemp("ftwork")
    tracker = BestModelTracker(str(work / "checkpoints"))
    model = VisionTransformer3D(ViTConfig(volume_size=VOL, patch_size=4, embed_dim=24, depth=2, num_heads=3))
    for k, tree in enumerate(folds):
        model.load_state_dict(params_from_jax(tree, 4, 1), strict=True)
        tracker.best = dict.fromkeys(tracker.criteria, 0.0)
        tracker.update({"roc_auc_score": 0.5, "specificity": 0.5, "sensitivity": 0.5}, model, fold=k)
    for stray in ("checkpoint-best_ft_model_1.pth.tmp", "checkpoint-best_ft_model_x.pth", "notes.txt"):
        (work / "checkpoints" / stray).write_bytes(b"not a checkpoint")
    return str(work)


@pytest.fixture(scope="module")
def engine(work_dir):
    return ClassifierEngine.from_work_dir(work_dir, device="cpu", **KW)


def test_classifier_engine_matches_jax(folds, engine):
    """f32 against JAX's `ClassifierEngine(None, vit_params_list=...)` within
    1e-5, and the int8 engines against each other within 1e-3; the int8
    fold mean within 0.05 of the f32 one with the same argmax (the JAX
    package's bar, tests/test_serving.py)."""
    vols = _vols(6, seed=7)  # a full slab and a padded one
    want = JaxClassifierEngine(None, vit_params_list=folds, **KW).infer(vols)
    got = ClassifierEngine(vit_params_list=folds, device="cpu", **KW).infer(vols)
    assert got.shape == (6, 2) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=PROB_TOL)
    np.testing.assert_allclose(engine.infer(vols), want, rtol=0, atol=PROB_TOL)  # the .pth files

    q_want = JaxClassifierEngine(None, vit_params_list=folds, quantize="int8", **KW).infer(vols)
    q = ClassifierEngine(vit_params_list=folds, quantize="int8", device="cpu", **KW)
    q_got = q.infer(vols)
    np.testing.assert_allclose(q_got, q_want, rtol=0, atol=1e-3)
    np.testing.assert_allclose(q_got.sum(-1), 1.0, rtol=1e-5)
    assert np.abs(q_got - got).max() < 0.05 and (q_got.argmax(-1) == got.argmax(-1)).all()
    assert q.num_folds == 2


def test_fold_mean_of_single_folds(folds, engine):
    vols = _vols(3, seed=8)
    probs = engine.infer(vols)
    assert engine.num_folds == 2
    singles = [ClassifierEngine(vit_params_list=[t], device="cpu", **KW).infer(vols) for t in folds]
    np.testing.assert_allclose(probs, np.mean(singles, axis=0), rtol=1e-6, atol=1e-7)
    assert np.abs(singles[0] - singles[1]).max() > 1e-3  # the folds differ


def test_from_work_dir_files(work_dir, folds, tmp_path):
    """Only `_<k>.pth` files, in fold order; the unsuffixed file when there
    are none; no match raises."""
    spec = ClassifierEngine.from_work_dir(work_dir, criterion="spec", device="cpu", **KW)
    vols = _vols(2, seed=9)
    np.testing.assert_allclose(spec.infer(vols), ClassifierEngine(vit_params_list=folds, device="cpu", **KW).infer(vols),
                               rtol=1e-6, atol=1e-7)
    single = tmp_path / "single"
    tracker = BestModelTracker(str(single / "checkpoints"))
    model = VisionTransformer3D(ViTConfig(volume_size=VOL, patch_size=4, embed_dim=24, depth=2, num_heads=3))
    model.load_state_dict(params_from_jax(folds[1], 4, 1), strict=True)
    tracker.update({"roc_auc_score": 0.5, "specificity": 0.5, "sensitivity": 0.5}, model)
    eng = ClassifierEngine.from_work_dir(str(single), criterion="sens", device="cpu", **KW)
    assert eng.num_folds == 1
    np.testing.assert_allclose(eng.infer(vols), ClassifierEngine(vit_params_list=folds[1:], device="cpu", **KW).infer(vols),
                               rtol=1e-6, atol=1e-7)
    with pytest.raises(FileNotFoundError):
        ClassifierEngine.from_work_dir(str(tmp_path), device="cpu", **KW)


def _post(port, path, body):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=body, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _get(port, path):
    return json.loads(urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=10).read())


def _npy(arr) -> bytes:
    buf = io.BytesIO()
    np.save(buf, arr)
    return buf.getvalue()


def _nifti(arr, tmp_path, name) -> bytes:
    path = tmp_path / name
    write_nifti(str(path), arr)
    return path.read_bytes()


def _serve(**queues):
    srv = make_http_server(port=0, **queues)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    return srv, thread


def _stop(srv, thread, *queues):
    srv.shutdown()
    for q in queues:
        q.close()
    srv.server_close()
    thread.join(timeout=10)
    assert not thread.is_alive()


def test_http_predict_nifti_and_stats(engine, folds, tmp_path):
    """/predict answers engine.infer; NIfTI bodies (3-D, 4-D, gzipped)
    equal their .npy; /stats nests both queues; reset_stats clears the
    history and keeps the counters."""
    mae = {k: v for k, v in folds[0].items() if k not in ("pos_embed", "head")}
    mae["norm"] = mae.pop("fc_norm")
    features = FeatureEngine(mae_params=mae, device="cpu", **KW)
    fq, cq = BatchingQueue(features, max_wait_ms=5), BatchingQueue(engine, max_wait_ms=5)
    srv, thread = _serve(queue=fq, classifier_queue=cq)
    port = srv.server_address[1]
    try:
        vols = _vols(3, seed=11)
        status, body = _post(port, "/predict", _npy(vols))
        assert status == 200
        out = json.loads(body)
        assert out["num_folds"] == 2
        np.testing.assert_allclose(out["probs"], engine.infer(vols), rtol=1e-6, atol=1e-7)
        assert out["pred"] == np.asarray(out["probs"]).argmax(-1).tolist()

        vol = vols[1, 0]
        status, body = _post(port, "/predict", _nifti(vol, tmp_path, "v.nii.gz"))
        assert status == 200
        np.testing.assert_allclose(json.loads(body)["probs"], engine.infer(vol[None, None]), rtol=1e-6, atol=1e-7)
        status, body = _post(port, "/features", _nifti(vol[..., None], tmp_path, "v4.nii"))  # (x, y, z, t=1)
        assert status == 200
        np.testing.assert_allclose(np.load(io.BytesIO(body)), features.infer(vol[None, None]), rtol=1e-6, atol=1e-7)
        status, body = _post(port, "/predict", gzip.compress(b"neither npy nor nifti"))
        assert status == 400 and b"NIfTI" in body

        stats = _get(port, "/stats")
        assert set(stats) == {"features", "predict"}
        assert stats["predict"]["total_requests"] == 4 and stats["features"]["total_requests"] == 1
        assert stats["predict"]["latency_p50_ms"] > 0
        cq.reset_stats()
        after = _get(port, "/stats")["predict"]
        assert after["latency_p50_ms"] == 0.0 and after["mean_batch_fill"] == 0.0
        assert after["total_requests"] == 4 and after["total_batches"] == stats["predict"]["total_batches"]
    finally:
        _stop(srv, thread, fq, cq)

    cq = BatchingQueue(engine, max_wait_ms=5)
    srv, thread = _serve(classifier_queue=cq)
    try:
        port = srv.server_address[1]
        assert _post(port, "/features", _npy(_vols(1, seed=12)))[0] == 404  # a task not served
        assert set(_get(port, "/stats")) >= {"total_requests", "latency_p50_ms"}  # one queue: flat
    finally:
        _stop(srv, thread, cq)
    srv, thread = _serve()
    try:
        assert _get(srv.server_address[1], "/stats") == {}
    finally:
        _stop(srv, thread)


def test_serve_cli_classify_answers_and_drains_on_sigterm(work_dir, engine):
    cmd = [sys.executable, "-m", "vit_ae_plus_plus_torch.cli", "serve", "--task", "classify",
           "--checkpoint", work_dir, "--ensemble-criterion", "ft", "--model", TINY, "--volume-size", str(VOL),
           "--patch-size", "4", "--batch-size", "2", "--compute-dtype", "float32", "--resize-inputs",
           "--device", "cpu", "--port", "0"]
    env = {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"}
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                            cwd=str(REPO), env=env)
    try:
        port, head = None, []
        for line in proc.stdout:
            head.append(line)
            if "listening on" in line:
                port = int(line.split("http://127.0.0.1:")[1].split()[0])
                break
        assert port is not None, "server never listened: " + "".join(head)
        assert "2-fold ensemble" in "".join(head) and "POST /predict" in head[-1]
        big = np.random.default_rng(13).standard_normal((1, 24, 24, 24)).astype(np.float32)
        status, body = _post(port, "/predict", _npy(big))  # resized to 16^3 by --resize-inputs
        assert status == 200
        want = ClassifierEngine.from_work_dir(work_dir, resize=True, device="cpu", **KW).infer(big[None])
        np.testing.assert_allclose(json.loads(body)["probs"], want, rtol=1e-5, atol=1e-6)
        proc.send_signal(signal.SIGTERM)
        rest = proc.communicate(timeout=60)[0]
        assert proc.returncode == 0 and "server stopped" in rest
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
