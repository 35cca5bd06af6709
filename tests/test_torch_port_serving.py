"""The port's serving front: batching queue, HTTP status codes and the
`serve` CLI, on the tiny preset on the CPU. The answers are held to the
engine's own `infer` (which tests/test_torch_port_vit.py holds to JAX)."""

import http.client
import io
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from vit_ae_plus_plus_torch.serving import BatchingQueue, FeatureEngine, QueueFull, make_http_server

VOL = 16
REPO = Path(__file__).resolve().parents[1]


def _tiny_mae_state_dict(seed=0):
    """A reference-layout MAE state dict with the tiny preset's encoder
    (only the keys the graft reads, plus a decoder key it must skip)."""
    rng = np.random.default_rng(seed)
    d, hidden = 24, 96

    def w(*shape, scale=0.05):
        return torch.from_numpy((scale * rng.standard_normal(shape)).astype(np.float32))

    sd = {
        "patch_embed.proj.weight": w(d, 1, 4, 4, 4),
        "patch_embed.proj.bias": w(d),
        "cls_token": w(1, 1, d),
        "norm.weight": 1 + w(d),
        "norm.bias": w(d),
        "decoder_blocks.0.norm1.weight": w(12),
    }
    for i in range(2):
        p = f"blocks.{i}."
        sd.update({
            p + "norm1.weight": 1 + w(d), p + "norm1.bias": w(d),
            p + "attn.qkv.weight": w(3 * d, d), p + "attn.qkv.bias": w(3 * d),
            p + "attn.proj.weight": w(d, d), p + "attn.proj.bias": w(d),
            p + "norm2.weight": 1 + w(d), p + "norm2.bias": w(d),
            p + "mlp.fc1.weight": w(hidden, d), p + "mlp.fc1.bias": w(hidden),
            p + "mlp.fc2.weight": w(d, hidden), p + "mlp.fc2.bias": w(d),
        })
    return sd


ENGINE_KW = dict(model_name="contr_mae_vit_tiny_patch4", volume_size=VOL, patch_size=4,
                 batch_size=4, compute_dtype="float32", device="cpu")


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("serve") / "mae.pth")
    torch.save(_tiny_mae_state_dict(), path)
    return path


@pytest.fixture(scope="module")
def engine(ckpt):
    return FeatureEngine(ckpt, **ENGINE_KW)


def _vols(n, seed=0):
    return np.random.default_rng(seed).standard_normal((n, 1, VOL, VOL, VOL)).astype(np.float32)


def _npy(arr) -> bytes:
    buf = io.BytesIO()
    np.save(buf, arr)
    return buf.getvalue()


@pytest.fixture
def server(engine):
    queue = BatchingQueue(engine, max_wait_ms=20)
    srv = make_http_server(queue, port=0, max_body_mb=1)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    yield srv, queue
    srv.shutdown()
    queue.close()
    srv.server_close()
    thread.join(timeout=10)
    assert not thread.is_alive()


def _post(port, path, body, headers=None):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=body, method="POST",
                                 headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def test_http_features_status_codes_and_stats(server, engine):
    srv, queue = server
    port = srv.server_address[1]
    vols = _vols(3, seed=1)
    want = engine.infer(vols)

    # concurrent requests of 1 and 2 volumes co-batch and answer correctly
    results = {}

    def send(i, arr):
        results[i] = _post(port, "/features", _npy(arr))

    threads = [threading.Thread(target=send, args=(0, vols[0])),
               threading.Thread(target=send, args=(1, vols[1:]))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert results[0][0] == 200 and results[1][0] == 200
    got = np.concatenate([np.load(io.BytesIO(results[i][1])) for i in (0, 1)])
    assert got.shape == (3, 24) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)

    stats = json.loads(urllib.request.urlopen(f"http://127.0.0.1:{port}/stats", timeout=10).read())
    assert stats["total_requests"] == 3 and stats["total_batches"] >= 1
    assert json.loads(urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=10).read()) == {"status": "ok"}

    assert _post(port, "/predict", _npy(vols[0]))[0] == 404
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(f"http://127.0.0.1:{port}/nope", timeout=10)
    assert e.value.code == 404
    assert _post(port, "/features", b"\x00" * (2 << 20))[0] == 413  # over max_body_mb=1
    nifti_like = b"\x5c\x01\x00\x00" + b"\x00" * 400
    status, body = _post(port, "/features", nifti_like)
    assert status == 400 and b"NIfTI" in body
    assert _post(port, "/features", _npy(np.zeros((1, 8, 8, 8), np.float32)))[0] == 400


def test_http_body_without_content_length_gets_411(server):
    """Refused on the headers alone, before any body byte is read (the
    client here waits for the answer before sending, as with
    `Expect: 100-continue`, so no unread byte can turn the close into a reset)."""
    srv, _ = server
    conn = http.client.HTTPConnection("127.0.0.1", srv.server_address[1], timeout=30)
    conn.putrequest("POST", "/features")
    conn.putheader("Transfer-Encoding", "chunked")
    conn.endheaders()
    assert conn.getresponse().status == 411
    conn.close()
    with socket.create_connection(("127.0.0.1", srv.server_address[1]), timeout=30) as s:
        s.sendall(b"POST /features HTTP/1.1\r\nHost: x\r\n\r\n")
        assert s.recv(64).startswith(b"HTTP/1.0 411")


def test_queue_sheds_load_and_validates_in_the_callers_thread(engine):
    queue = BatchingQueue(engine, max_wait_ms=1, max_depth=2)
    try:
        with pytest.raises(QueueFull):
            queue.submit_many(list(_vols(3)))
        with pytest.raises(ValueError):
            queue.submit(np.zeros((1, 8, 8, 8), np.float32))
        np.testing.assert_allclose(queue.infer_one(_vols(1)[0]), engine.infer(_vols(1))[0],
                                   rtol=1e-5, atol=1e-6)
        assert queue.stats()["total_shed"] == 3
    finally:
        queue.close()


def test_serve_cli_answers_and_drains_on_sigterm(ckpt):
    cmd = [sys.executable, "-m", "vit_ae_plus_plus_torch.cli", "serve", "--checkpoint", ckpt,
           "--model", "contr_mae_vit_tiny_patch4", "--volume-size", str(VOL), "--patch-size", "4",
           "--batch-size", "2", "--compute-dtype", "float32", "--device", "cpu", "--port", "0"]
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                            cwd=str(REPO), env=env)
    try:
        port = None
        for line in proc.stdout:
            if "listening on" in line:
                port = int(line.split("http://127.0.0.1:")[1].split()[0])
                break
        assert port is not None, "server never listened"
        status, body = _post(port, "/features", _npy(_vols(1, seed=3)))
        assert status == 200 and np.load(io.BytesIO(body)).shape == (1, 24)
        proc.send_signal(signal.SIGTERM)
        rest = proc.communicate(timeout=60)[0]
        assert proc.returncode == 0 and "server stopped" in rest
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
