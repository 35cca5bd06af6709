"""The port's serving mesh (serving.py `mesh=`, `serve --n-devices`) and
the MoCo and contrastive steps on (D, M > 1) meshes, on the CPU.

In this process:
- a serving mesh whose data axis does not divide the batch raises
  "divide" (batch 6 on data 8, JAX tests/test_serving.py:413), and one
  with a model axis is refused, before any collective;
- `serve --n-devices 2 --device cpu` as a subprocess: two gloo ranks, its
  `/features` answer equal to the one-process engine's within rtol 1e-5 /
  atol 1e-6, and after SIGTERM to the command (which passes it on to rank
  0) it exits 0 within 60 s with every rank gone; `--batch-size 3` on 2
  devices is refused before any spawn.

The helpers below the line run in the one world of 8 gloo ranks of
tests/test_torch_port_ring_flash.py (rank side) and in its pytest process
(the JAX side), which holds them to each other there:
- the f32 feature engine, the int8 engine and the two-fold classifier on
  (2, 1), (4, 1) and (8, 1) meshes, rank 0 serving 11 volumes (one full
  slab of 8 and one padded) while the others follow: against JAX's engines
  on `make_mesh(data=8)` within rtol 1e-5 / atol 1e-6 (the int8 features
  within tests/test_torch_port_quant.py's 1e-3 of the largest feature, as
  the one-process int8 engines are held to each other), and against the
  port's one-process engine within rtol 1e-5 / atol 1e-6; the followers ran
  both slabs; a control whose ranks all take the slab's first rows misses;
- the MoCo step (both trunks) and the contrastive step on (2, 2) and
  (2, 4) against JAX's jitted steps on the same meshes (f64, the data-mesh
  cases' `MOCO_TOL`), the parameters after the step bitwise equal on every
  rank; the controls that must miss: the keys gathered over the whole mesh
  instead of its 'data' group (each data coordinate's keys M times), and
  the gradients all-reduced over the whole mesh (M times the mean);
- on (2, 2), replicas moved apart after the data mean (model coordinate
  1's gradients by 1e-6) end bitwise equal on all 4 ranks through
  `agree_over_model`, and stay apart without it;
- the MoCo ViT FSDP step on (2, 2), where the FSDP placement extends the
  TP rule (the trunk's heads cut over 'model'), against JAX's
  `shard_moco_state_fsdp` step on the same mesh.

JAX is imported inside the functions that run it: the ranks import this
module by name and need none of it.
"""

import contextlib
import io
import os
import signal
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from vit_ae_plus_plus_torch.parallel import Mesh

import test_torch_port_moco_ddp as md

REPO = Path(__file__).resolve().parents[1]
TINY = "contr_mae_vit_tiny_patch4"
VOL, SLAB = 16, 8
SERVE_MESHES = (2, 4, 8)
SERVE_KINDS = ("features", "int8", "classify")
SERVE_TOL = dict(rtol=1e-5, atol=1e-6)
INT8_JAX_TOL = 1e-3  # of the largest feature: tests/test_torch_port_quant.py FEAT_TOL
KW = dict(model_name=TINY, volume_size=VOL, patch_size=4, batch_size=SLAB, compute_dtype="float32")
STEP_MESHES = ((2, 2), (2, 4))
STEP_CONTROLS = ("world_keys", "world_grads")
REPLICA_CASES = ("apart", "apart_unsynced")
# the FSDP MoCo case on (2, 2): 4 heads, which the model axis divides (the
# data-mesh cases' trunk has 3), and the attention a TP trunk takes
# ('xla' in JAX: md._jax_moco_model)
FSDP_VIT = dict(md.VIT, embed_dim=32, num_heads=4, attn_impl="plain")


def serving_volumes() -> np.ndarray:
    """11 volumes: one full slab of 8 and one padded."""
    return np.random.default_rng(61).standard_normal((11, 1, VOL, VOL, VOL)).astype(np.float32)


def serving_weights() -> dict:
    """Seeded numpy trees in the JAX layout: a tiny MAE encoder and two
    classifier folds."""
    from test_torch_port_quant import tiny_vit_tree
    from test_torch_port_resize import _tiny_mae_tree

    return {"mae": _tiny_mae_tree(62), "folds": [tiny_vit_tree(63 + k) for k in range(2)]}


def _port_engine(kind: str, weights: dict, mesh=None):
    from vit_ae_plus_plus_torch.serving import ClassifierEngine, FeatureEngine

    if kind == "classify":
        return ClassifierEngine(vit_params_list=weights["folds"], device="cpu", mesh=mesh, **KW)
    return FeatureEngine(mae_params=weights["mae"], quantize="int8" if kind == "int8" else "none", device="cpu",
                         mesh=mesh, **KW)


def one_process_serving(weights: dict) -> dict:
    """{kind: the port's one-process engine's answers}."""
    return {kind: _port_engine(kind, weights).infer(serving_volumes()) for kind in SERVE_KINDS}


def jax_serving(weights: dict) -> dict:
    """{kind: JAX's engine's answers on `make_mesh(data=8)`}."""
    from vit_ae_plus_plus_tpu.parallel import make_mesh as jax_mesh
    from vit_ae_plus_plus_tpu.serving import ClassifierEngine, FeatureEngine

    mesh = jax_mesh(data=8)
    vols = serving_volumes()
    out = {}
    for kind in SERVE_KINDS:
        if kind == "classify":
            engine = ClassifierEngine(None, vit_params_list=weights["folds"], mesh=mesh, **KW)
        else:
            engine = FeatureEngine(None, mae_params=weights["mae"], quantize="int8" if kind == "int8" else "none",
                                   mesh=mesh, **KW)
        out[kind] = engine.infer(vols)
    return out


@contextlib.contextmanager
def _first_rows():
    """The control: every rank runs the slab's first rows (the scatter
    replaced by a broadcast of rank 0's first block)."""
    from unittest import mock

    from vit_ae_plus_plus_torch import serving
    from vit_ae_plus_plus_torch.parallel.mesh import broadcast_from

    def first(slab, mesh, shape, dtype, device, axis="data"):
        rows = shape[0] // mesh.size(axis)
        like = slab[:rows] if slab is not None else torch.empty((rows, *shape[1:]), dtype=dtype)
        return broadcast_from(like.contiguous(), mesh, axis, 0).to(device)

    with mock.patch.object(serving, "scatter_batch", first):
        yield


def run_serving(mesh, kind: str, weights: dict, control: bool = False):
    """Rank 0 of `mesh`: the engine's answers to `serving_volumes()`; the
    others: the slabs they followed."""
    engine = _port_engine(kind, weights, mesh)
    with _first_rows() if control else contextlib.nullcontext():
        if mesh.coords["data"] != 0:
            return engine.follow()
        try:
            return engine.infer(serving_volumes())
        finally:
            engine.stop_followers()


def _whole(mesh, group) -> Mesh:
    """A one-axis mesh whose 'data' group is `group`, every rank of
    `mesh`: the controls' wrong group."""
    import torch.distributed as dist

    ranks = list(range(mesh.size("data") * mesh.size("model")))
    return Mesh(shape={"data": len(ranks)}, coords={"data": dist.get_rank()}, ranks={"data": ranks},
                groups={"data": group})


def step_control(name, mesh, group):
    """'world_keys': the MoCo keys gathered over every rank of the mesh;
    'world_grads': the gradients summed over every rank of the mesh (the
    step still divides by D); 'apart': the gradients of the ranks at model
    coordinate 1 moved by 1e-6 after the data mean, as a kernel that sums
    in no fixed order moves a replica's; 'apart_unsynced': the same
    without `agree_over_model`."""
    from unittest import mock

    from vit_ae_plus_plus_torch.models import moco
    from vit_ae_plus_plus_torch.parallel import mesh as transport
    from vit_ae_plus_plus_torch.pipelines import moco_kfold
    from vit_ae_plus_plus_torch.train import step

    if name in REPLICA_CASES:
        real = moco_kfold.average_grads

        def moved(params, shard_axes=None):
            real(params, shard_axes)
            if mesh.coords["model"] == 1:
                for p in params:
                    p.grad.add_(1e-6)

        stack = contextlib.ExitStack()
        stack.enter_context(mock.patch.object(moco_kfold, "average_grads", moved))
        if name == "apart_unsynced":
            stack.enter_context(mock.patch.object(moco_kfold, "agree_over_model", lambda params, shard_axes=None: None))
        return stack

    if name == "world_keys":
        return mock.patch.object(moco, "all_gather_batch",
                                 lambda t, _mesh, axis="data": transport.all_gather_batch(t, _whole(mesh, group)))
    if name == "world_grads":
        return mock.patch.object(step, "all_reduce_flat",
                                 lambda ts, _mesh, axis="data": transport.all_reduce_flat(ts, _whole(mesh, group)))
    return contextlib.nullcontext()


def run_mesh_moco(mesh, arch, weights, control=None, group=None):
    """`md.run_ddp_moco` on a (D, M) mesh, under `control`."""
    with step_control(control, mesh, group):
        return md.run_ddp_moco(mesh, arch, weights)


def run_mesh_contrastive(mesh, weights, control=None, group=None):
    with step_control(control, mesh, group):
        return md.run_ddp_contrastive(mesh, weights)


def fsdp_moco_weights():
    """The base and momentum encoders of the (2, 2) FSDP case's MoCo
    (`FSDP_VIT`), as `md.jax_moco_weights`."""
    return md.jax_moco_weights("vit", vit=FSDP_VIT)


# ------------------------------------------------------------ in this process

def test_serving_mesh_refusals_come_before_any_collective():
    """batch 6 on data 8 raises "divide"; a mesh with a model axis is
    refused (no process group is touched: the mesh is a stand-in)."""
    from vit_ae_plus_plus_torch.serving import FeatureEngine

    from test_torch_port_resize import _tiny_mae_tree

    weights = {"mae": _tiny_mae_tree(62)}
    data8 = Mesh(shape={"data": 8, "model": 1}, coords={"data": 0, "model": 0}, ranks={}, groups={})
    with pytest.raises(ValueError, match="divide"):
        FeatureEngine(mae_params=weights["mae"], mesh=data8, device="cpu", **{**KW, "batch_size": 6})
    dm = Mesh(shape={"data": 2, "model": 2}, coords={"data": 0, "model": 0}, ranks={}, groups={})
    with pytest.raises(ValueError, match="'data' only"):
        FeatureEngine(mae_params=weights["mae"], mesh=dm, device="cpu", **KW)


def _children(pid: int) -> set:
    """The pids whose parent is `pid` (Linux /proc)."""
    out = set()
    for entry in os.listdir("/proc"):
        if entry.isdigit():
            try:
                with open(f"/proc/{entry}/stat") as f:
                    fields = f.read().rsplit(")", 1)[1].split()
            except OSError:
                continue
            if int(fields[1]) == pid:
                out.add(int(entry))
    return out


def _alive(pid: int) -> bool:
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except OSError:
        return False


def test_serve_n_devices_answers_and_stops_every_rank_on_sigterm(tmp_path):
    from vit_ae_plus_plus_torch.serving import FeatureEngine

    import test_torch_port_serving as ts

    ckpt = str(tmp_path / "mae.pth")
    torch.save(ts._tiny_mae_state_dict(), ckpt)
    cmd = [sys.executable, "-m", "vit_ae_plus_plus_torch.cli", "serve", "--checkpoint", ckpt, "--model", TINY,
           "--volume-size", str(VOL), "--patch-size", "4", "--batch-size", "2", "--compute-dtype", "float32",
           "--device", "cpu", "--port", "0", "--n-devices", "2"]
    env = {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"}
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, cwd=str(REPO), env=env)
    ranks = set()
    try:
        port = None
        for line in proc.stdout:
            if "listening on" in line:
                port = int(line.split("http://127.0.0.1:")[1].split()[0])
                break
        assert port is not None, "server never listened"
        vols = np.random.default_rng(64).standard_normal((3, 1, VOL, VOL, VOL)).astype(np.float32)
        buf = io.BytesIO()
        np.save(buf, vols)
        req = urllib.request.Request(f"http://127.0.0.1:{port}/features", data=buf.getvalue(), method="POST")
        with urllib.request.urlopen(req, timeout=60) as r:
            got = np.load(io.BytesIO(r.read()))
        want = FeatureEngine(ckpt, device="cpu", **{**KW, "batch_size": 2}).infer(vols)
        np.testing.assert_allclose(got, want, **SERVE_TOL)
        ranks = _children(proc.pid)
        assert len(ranks) >= 2, ranks  # the two ranks (and the spawn's resource tracker)
        t0 = time.monotonic()
        proc.send_signal(signal.SIGTERM)
        rest = proc.communicate(timeout=60)[0]
        assert proc.returncode == 0 and "server stopped" in rest, rest
        assert time.monotonic() - t0 < 60
        deadline = time.monotonic() + 10
        while any(_alive(p) for p in ranks) and time.monotonic() < deadline:
            time.sleep(0.1)
        assert not [p for p in ranks if _alive(p)], "a rank outlived the server"
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        for p in ranks:
            if _alive(p):
                os.kill(p, signal.SIGKILL)


def test_serve_n_devices_refuses_a_batch_it_does_not_split_before_any_spawn(monkeypatch):
    from vit_ae_plus_plus_torch import cli

    monkeypatch.setattr("vit_ae_plus_plus_torch.parallel.run_ranks", lambda *a, **k: pytest.fail("spawned"))
    argv = ["serve", "--checkpoint", "none.pth", "--batch-size", "3", "--n-devices", "2", "--device", "cpu"]
    with pytest.raises(ValueError, match="does not split into 2"):
        cli.main(argv)
    assert cli.run(argv) == 2
