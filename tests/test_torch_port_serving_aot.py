"""The port's precompiled serving engines (serving_aot.py, `compile-engine`
and `serve --engine`) on the tiny preset on the CPU, mirroring the JAX
package's tests/test_serving_aot.py: the feature engine (f32, bf16 and
int8) and the two-fold classifier loaded from an artifact equal the built
engines bitwise, a full and a padded slab; a foreign fingerprint, an
unknown format and a stray member are refused; no member is a pickle; a
mesh engine is refused; `compile-engine` then `serve --engine` over HTTP.
Beyond JAX's: the load runs no graft, no quantiser and no kernel build;
the loaded engine against JAX's `FeatureEngine` on the same weights; the
kernel libraries' checks (missing, other bytes, other sources)."""

import hashlib
import io
import json
import os
import re
import signal
import subprocess
import sys
import urllib.request
import zipfile
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_port_quant import tiny_vit_tree
from test_torch_port_resize import _tiny_mae_tree
from test_torch_port_serving import _tiny_mae_state_dict
from vit_ae_plus_plus_torch import serving_aot
from vit_ae_plus_plus_torch.kernels import _build
from vit_ae_plus_plus_torch.parallel import Mesh
from vit_ae_plus_plus_torch.serving import ClassifierEngine, FeatureEngine
from vit_ae_plus_plus_torch.serving_aot import load_engine, save_engine

REPO = Path(__file__).resolve().parents[1]
VOL, BATCH = 16, 4
COMMON = dict(model_name="contr_mae_vit_tiny_patch4", volume_size=VOL, in_chans=1, patch_size=4, batch_size=BATCH,
              compute_dtype="float32", device="cpu")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("aot") / "mae.pth")
    torch.save(_tiny_mae_state_dict(3), path)
    return path


@pytest.fixture(scope="module")
def folds():
    return [tiny_vit_tree(20 + k) for k in range(2)]


def _vols(n, seed=0):
    return np.random.default_rng(seed).standard_normal((n, 1, VOL, VOL, VOL)).astype(np.float32)


def _rewrite(path, out, meta=None, extra=()):
    """A copy of the artifact `path` at `out` with `meta` for meta.json and
    the members `extra` added."""
    with zipfile.ZipFile(path) as zf:
        items = {n: zf.read(n) for n in zf.namelist()}
    if meta is not None:
        items["meta.json"] = json.dumps(meta).encode()
    items.update(dict(extra))
    with zipfile.ZipFile(out, "w") as zf:
        for n, b in items.items():
            zf.writestr(n, b)
    return str(out)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_feature_engine_roundtrip(ckpt, tmp_path, dtype):
    """Bitwise on one full and one padded slab; in bfloat16 every leaf but
    the LayerNorms' is stored in bfloat16."""
    eng = FeatureEngine(ckpt, **{**COMMON, "compute_dtype": dtype})
    path = str(tmp_path / "eng.vitae")
    meta = save_engine(eng, path)
    assert meta["kind"] == "features" and meta["batch_size"] == BATCH and meta["kernels"] == {}
    stored = {w["name"]: w["dtype"] for w in meta["weights"]}
    assert stored == {n: "float32" if re.search(r"norm\d?\.(weight|bias)$", n) else dtype for n in stored}
    loaded = load_engine(path)
    assert loaded.feature_dim == eng.feature_dim and loaded.volume_shape == eng.volume_shape
    vols = _vols(BATCH + 2, seed=1)
    np.testing.assert_array_equal(loaded.infer(vols), eng.infer(vols))
    assert loaded.warmup() >= 0.0


def test_feature_engine_int8_roundtrip(ckpt, tmp_path):
    eng = FeatureEngine(ckpt, quantize="int8", **COMMON)
    path = str(tmp_path / "eng8.vitae")
    assert save_engine(eng, path)["quantize"] == "int8"
    loaded = load_engine(path)
    vols = _vols(3, seed=2)
    np.testing.assert_array_equal(loaded.infer(vols), eng.infer(vols))


@pytest.mark.parametrize("quantize", ["none", "int8"])
def test_classifier_ensemble_roundtrip(folds, tmp_path, quantize):
    eng = ClassifierEngine(vit_params_list=folds, quantize=quantize, **COMMON)
    path = str(tmp_path / "clf.vitae")
    meta = save_engine(eng, path)
    assert meta["kind"] == "classify" and meta["num_folds"] == 2 and meta["num_classes"] == 2
    loaded = load_engine(path)
    assert loaded.num_folds == 2 and loaded.num_classes == 2
    vols = _vols(BATCH + 1, seed=3)
    got = loaded.infer(vols)
    np.testing.assert_array_equal(got, eng.infer(vols))
    np.testing.assert_allclose(got.sum(-1), 1.0, rtol=1e-5)


def test_fingerprint_mismatch_rejected(ckpt, tmp_path):
    path = str(tmp_path / "eng.vitae")
    meta = save_engine(FeatureEngine(ckpt, **COMMON), path)
    for key, value in (("device_name", "another machine"), ("torch", "0.0"), ("platform", "cuda")):
        bad = dict(meta, fingerprint=dict(meta["fingerprint"], **{key: value}))
        with pytest.raises(RuntimeError, match=f"built for {key}="):
            load_engine(_rewrite(path, tmp_path / f"bad_{key}.vitae", bad), device="cpu")


def test_unknown_format_and_stray_members_rejected(ckpt, tmp_path):
    """Another format version, another format name and a member that is
    not meta.json, weights.npz or a kernel library (a pickle smuggled in)
    are refused before anything is loaded."""
    path = str(tmp_path / "eng.vitae")
    meta = save_engine(FeatureEngine(ckpt, **COMMON), path)
    for bad in (dict(meta, format_version=2), dict(meta, format="vitae")):
        with pytest.raises(RuntimeError, match="unsupported engine format"):
            load_engine(_rewrite(path, tmp_path / "v.vitae", bad))
    with pytest.raises(RuntimeError, match="unexpected members"):
        load_engine(_rewrite(path, tmp_path / "s.vitae", extra=[("state.pkl", b"\x80\x04.")]))
    with pytest.raises(RuntimeError, match="not an engine artifact"):
        load_engine(_rewrite(path, tmp_path / "m.vitae", extra=[("meta.json", b"{not json")]))


def test_artifact_weights_are_not_pickled(ckpt, tmp_path):
    path = str(tmp_path / "eng.vitae")
    save_engine(FeatureEngine(ckpt, quantize="int8", **COMMON), path)
    with zipfile.ZipFile(path) as zf:
        assert set(zf.namelist()) == {"meta.json", "weights.npz"}
        meta = json.loads(zf.read("meta.json"))
        with np.load(io.BytesIO(zf.read("weights.npz")), allow_pickle=False) as z:
            assert len(z.files) == len(meta["weights"]) > 0
            assert all(not z[k].dtype.hasobject for k in z.files)
    assert {w["dtype"] for w in meta["weights"]} == {"int8", "float32"}


def test_mesh_engine_refused(ckpt, tmp_path):
    mesh = Mesh(shape={"data": 4, "model": 1}, coords={"data": 0, "model": 0}, ranks={}, groups={})
    eng = FeatureEngine(ckpt, mesh=mesh, **{**COMMON, "batch_size": 8})
    with pytest.raises(NotImplementedError, match="single-device"):
        save_engine(eng, str(tmp_path / "mesh.vitae"))


def test_load_runs_no_graft_no_quantiser_and_no_build(ckpt, folds, tmp_path, monkeypatch):
    paths = {}
    for name, eng in (("f32", FeatureEngine(ckpt, **COMMON)), ("int8", FeatureEngine(ckpt, quantize="int8", **COMMON)),
                      ("clf", ClassifierEngine(vit_params_list=folds, quantize="int8", **COMMON))):
        paths[name] = (str(tmp_path / f"{name}.vitae"), eng)
        save_engine(eng, paths[name][0])

    def refuse(*_a, **_k):
        raise AssertionError("called while loading an artifact")

    from vit_ae_plus_plus_torch import serving
    from vit_ae_plus_plus_torch.models import quant

    for module, name in ((serving, "build_grafted_vit"), (quant, "quantize_params"), (quant, "quantize_dense"),
                         (serving, "params_from_jax"), (serving, "load_reference_state_dict"), (_build, "build"),
                         (_build, "nvcc_path"), (torch.nn.init, "trunc_normal_")):
        monkeypatch.setattr(module, name, refuse)
    vols = _vols(2, seed=4)
    for path, eng in paths.values():
        np.testing.assert_array_equal(load_engine(path).infer(vols), eng.infer(vols))


def test_loaded_engine_matches_jax_feature_engine(tmp_path):
    from vit_ae_plus_plus_tpu.serving import FeatureEngine as JaxFeatureEngine

    tree = _tiny_mae_tree(5)
    path = str(tmp_path / "eng.vitae")
    save_engine(FeatureEngine(mae_params=tree, **COMMON), path)
    vols = _vols(BATCH + 1, seed=6)
    want = JaxFeatureEngine(None, mae_params=tree, **{k: v for k, v in COMMON.items() if k != "device"}).infer(vols)
    np.testing.assert_allclose(load_engine(path).infer(vols), want, rtol=1e-5, atol=1e-5)


def test_kernel_libraries_are_checked_before_use(tmp_path, monkeypatch):
    """`_install_kernels` on a `cuda` artifact's manifest: a library is
    written under its own sha256 in the build directory; a missing member,
    other bytes and a library of other sources raise."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    data = b"\x7fELF not really a library"
    digest = hashlib.sha256(data).hexdigest()
    member = "kernels/libflash_fwd-0123456789abcdef.so"
    good = {"sources": _build.source_digest("flash_fwd"), "library": member, "sha256": digest}
    cases = {"installed": ({"flash_fwd": good}, {member: data}),
             "is missing": ({"flash_fwd": good}, {}),
             "has sha256": ({"flash_fwd": dict(good, sha256="0" * 64)}, {member: data}),
             "other kernel sources": ({"flash_fwd": dict(good, sources="0" * 64)}, {member: data})}
    for what, (kernels, members) in cases.items():
        art = tmp_path / "k.vitae"
        with zipfile.ZipFile(art, "w") as zf:
            for n, b in members.items():
                zf.writestr(n, b)
        with zipfile.ZipFile(art) as zf:
            if what == "installed":
                out = serving_aot._install_kernels(zf, {"kernels": kernels}, str(art))
                assert out == {"flash_fwd": tmp_path / "build" / "engines" / digest[:16] / Path(member).name}
                assert out["flash_fwd"].read_bytes() == data
            else:
                with pytest.raises(RuntimeError, match=what):
                    serving_aot._install_kernels(zf, {"kernels": kernels}, str(art))


def test_cli_compile_engine_then_serve_engine_over_http(ckpt, tmp_path):
    """`compile-engine` writes the artifact; `serve --engine` answers
    /features as the built engine does, ignoring the other engine flags
    (a batch size and an --n-devices that the checkpoint's flags would
    refuse), and exits 0 on SIGTERM."""
    from vit_ae_plus_plus_torch import cli

    out = str(tmp_path / "cli.vitae")
    flags = ["--checkpoint", ckpt, "--model", "contr_mae_vit_tiny_patch4", "--volume-size", str(VOL),
             "--patch-size", "4", "--batch-size", str(BATCH), "--compute-dtype", "float32", "--device", "cpu"]
    assert cli.main(["compile-engine", "--out", out, *flags]) == 0
    cmd = [sys.executable, "-m", "vit_ae_plus_plus_torch.cli", "serve", "--engine", out, "--port", "0",
           "--batch-size", "3", "--n-devices", "2", "--model", "no_such_model"]
    env = {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"}
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, cwd=str(REPO), env=env)
    try:
        port = None
        for line in proc.stdout:
            if "listening on" in line:
                port = int(line.split("http://127.0.0.1:")[1].split()[0])
                break
        assert port is not None, "server never listened"
        vols = _vols(2, seed=5)
        buf = io.BytesIO()
        np.save(buf, vols, allow_pickle=False)
        req = urllib.request.Request(f"http://127.0.0.1:{port}/features", data=buf.getvalue(), method="POST")
        with urllib.request.urlopen(req, timeout=60) as r:
            feats = np.load(io.BytesIO(r.read()), allow_pickle=False)
        np.testing.assert_array_equal(feats, FeatureEngine(ckpt, **COMMON).infer(vols))
        proc.send_signal(signal.SIGTERM)
        rest = proc.communicate(timeout=60)[0]
        assert proc.returncode == 0 and "server stopped" in rest, rest
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
