"""`export-torch` of the port's own checkpoints against the JAX package's
`export_mae_torch_state_dict`, on the CPU at the tiny preset: the exported
state dict equals JAX's key for key and bitwise (dtype, shape, values) for
a resume `checkpoint.pth` built from `params_from_jax(P)`, for that file
through a `file://` URL, for JAX's own export and for the port's min-loss
`.pth`; GPipe stage files merge into the whole model (the stage files
written by a real pipelined run are held in the 8-rank world of
tests/test_torch_port_ring_flash.py); an orbax directory, a missing or
doubled stage, stages at different epochs and another patch size are
refused."""

import json
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from vit_ae_plus_plus_tpu.models import MODEL_ZOO as JAX_ZOO
from vit_ae_plus_plus_tpu.models import build_model as jax_build_model
from vit_ae_plus_plus_tpu.train.checkpoint import export_mae_torch_state_dict, save_params
from vit_ae_plus_plus_torch import cli
from vit_ae_plus_plus_torch.models import MODEL_ZOO, build_model
from vit_ae_plus_plus_torch.train import create_train_state, make_adamw
from vit_ae_plus_plus_torch.train.checkpoint import (
    CheckpointManager,
    export_torch,
    load_exported_mae,
    params_from_jax,
    save_state_dict,
)

TINY, VOL = "contr_mae_vit_tiny_patch4", 16
PP = "contr_mae_vit_tiny_pp_patch4"  # both block stacks 2 deep: 2 GPipe stages
FLAGS = ["--volume-size", str(VOL)]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_params(name):
    """P: a tiny MAE's JAX params, every leaf random -> (P, JAX's export)."""
    model = jax_build_model(JAX_ZOO[name](volume_size=VOL))
    x = jnp.zeros((1, 1, VOL, VOL, VOL))
    shapes = jax.eval_shape(model.init, {"params": jax.random.PRNGKey(0), "mask": jax.random.PRNGKey(1)}, x, x)
    rng = np.random.default_rng(8)
    params = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(np.float32), shapes["params"])
    return params, export_mae_torch_state_dict(params, JAX_ZOO[name](volume_size=VOL))


@pytest.fixture(scope="module")
def jax_params():
    return _jax_params(TINY)


def _port_model(params, name=TINY):
    model = build_model(MODEL_ZOO[name](volume_size=VOL))
    sd = model.state_dict()
    sd.update(params_from_jax(params, 4))
    model.load_state_dict(sd, strict=True)
    return model


def _assert_equals_jax(got, want):
    assert list(sorted(got)) == list(sorted(want))
    for k, w in want.items():
        g = got[k].numpy()
        assert g.dtype == np.asarray(w).dtype and g.shape == np.shape(w), k
        np.testing.assert_array_equal(g, w, err_msg=k)


def _export(tmp_path, checkpoint, model=TINY, name="out.pth"):
    out = tmp_path / name
    assert cli.main(["export-torch", "--checkpoint", str(checkpoint), "--out", str(out), "--model", model,
                     *FLAGS]) == 0
    return torch.load(out, map_location="cpu", weights_only=True)


@pytest.fixture(scope="module")
def resume_dir(tmp_path_factory, jax_params):
    """A fold's resume directory, written by `CheckpointManager` from a
    train state over `params_from_jax(P)`."""
    model = _port_model(jax_params[0])
    state = create_train_state(model, make_adamw(1e-3, weight_decay=0.05), seed=0)
    directory = tmp_path_factory.mktemp("fold_0") / "resume"
    CheckpointManager(str(directory)).save(state, epoch=3, min_loss=0.5)
    return directory


def test_export_of_a_resume_checkpoint_equals_jax(tmp_path, jax_params, resume_dir, capsys, monkeypatch):
    want = jax_params[1]
    for checkpoint in (resume_dir, resume_dir / "checkpoint.pth"):
        _assert_equals_jax(_export(tmp_path, checkpoint), want)
        assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == {
            "out": str(tmp_path / "out.pth"), "tensors": len(want)}
    monkeypatch.setenv("HOME", str(tmp_path))  # the URL's cache
    _assert_equals_jax(_export(tmp_path, (resume_dir / "checkpoint.pth").as_uri(), name="url.pth"), want)


def test_export_of_reference_layout_files_equals_jax(tmp_path, jax_params):
    params, want = jax_params
    jax_pth = tmp_path / "jax.pth"
    torch.save({k: torch.from_numpy(np.array(v)) for k, v in want.items()}, jax_pth)
    _assert_equals_jax(_export(tmp_path, jax_pth), want)
    min_loss = tmp_path / "checkpoint-min_loss.pth"
    save_state_dict(str(min_loss), _port_model(params).state_dict())  # no fixed tables, as pretrain-kfold writes it
    _assert_equals_jax(_export(tmp_path, min_loss), want)


def test_exported_dict_loads_strictly_into_the_mae(jax_params):
    params, want = jax_params
    sd = {k: torch.from_numpy(np.array(v)) for k, v in want.items()}
    model = build_model(MODEL_ZOO[TINY](volume_size=VOL))
    load_exported_mae(model, sd)
    for k, v in model.state_dict().items():
        assert torch.equal(v, sd[k]), k
    other = build_model(MODEL_ZOO[TINY](volume_size=2 * VOL))
    with pytest.raises(ValueError, match="pos_embed differs"):
        load_exported_mae(other, sd)
    with pytest.raises(ValueError, match="keys the MAE does not have"):
        load_exported_mae(model, {**sd, "head.weight": torch.zeros(1)})


def _stage_files(directory, whole, stages=2, epochs=(3, 3), blocks_of=None):
    """Per-stage resume payloads as a GPipe run writes them: each stage's
    blocks under their global index, the other leaves on every stage."""
    directory.mkdir(parents=True, exist_ok=True)
    cfg = MODEL_ZOO[PP](volume_size=VOL)
    for p in range(stages):
        mine = blocks_of(p) if blocks_of else p

        def kept(name):
            stack = name.split(".", 1)[0]
            if stack not in ("blocks", "decoder_blocks"):
                return True
            depth = cfg.depth if stack == "blocks" else cfg.decoder_depth
            per = depth // stages
            return mine * per <= int(name.split(".")[1]) < (mine + 1) * per

        torch.save({"model": {k: v for k, v in whole.items() if kept(k)}, "epoch": epochs[p]},
                   directory / f"checkpoint-stage{p}.pth")
    with open(directory / "layout.json", "w") as f:
        json.dump({"pipe": stages}, f)


def test_gpipe_stage_files_merge_and_refusals(tmp_path):
    params, want = _jax_params(PP)
    whole = _port_model(params, PP).state_dict()
    cfg = MODEL_ZOO[PP](volume_size=VOL)
    _stage_files(tmp_path / "ok", whole)
    _assert_equals_jax(_export(tmp_path, tmp_path / "ok", PP), want)
    _stage_files(tmp_path / "missing", whole)
    os.remove(tmp_path / "missing" / "checkpoint-stage1.pth")
    with pytest.raises(ValueError, match=r"lack stage\(s\) \[1\]"):
        export_torch(str(tmp_path / "missing"), cfg)
    _stage_files(tmp_path / "twice", whole, blocks_of=lambda p: 0)
    with pytest.raises(ValueError, match="a stage appears twice"):
        export_torch(str(tmp_path / "twice"), cfg)
    _stage_files(tmp_path / "epochs", whole, epochs=(3, 2))
    with pytest.raises(ValueError, match="different epochs"):
        export_torch(str(tmp_path / "epochs"), cfg)


def test_export_refuses_orbax_and_another_preset(tmp_path, jax_params, resume_dir, capsys):
    params, _ = jax_params
    orbax_dir = tmp_path / "checkpoint-min_loss"
    save_params(str(orbax_dir), params)  # the JAX package's orbax file
    out = tmp_path / "x.pth"
    assert cli.run(["export-torch", "--checkpoint", str(orbax_dir), "--out", str(out), "--model", TINY, *FLAGS]) == 2
    err = capsys.readouterr().err
    assert "orbax checkpoint" in err and "vit_ae_plus_plus_tpu.cli export-torch" in err and not out.exists()
    with pytest.raises(ValueError, match="shapes differ from the preset's"):
        export_torch(str(resume_dir), MODEL_ZOO[TINY](volume_size=VOL, patch_size=8))
    (tmp_path / "fold_0").mkdir()
    with pytest.raises(FileNotFoundError):
        export_torch(str(tmp_path / "fold_0"), MODEL_ZOO[TINY](volume_size=VOL))
