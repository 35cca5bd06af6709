"""The port's sanity-viz module and commands against the JAX package, on the
CPU at the tiny preset.

- `reconstruct` with JAX's weights (`params_from_jax`) and JAX's masking
  noise (recovered from JAX's forward as the rank of each token in its
  ids_restore, which argsorts to the same permutation): the five volumes
  within 1e-5 (absolute and relative) in f32, the same f32 arithmetic in
  another summation order;
- `plot_one_slice`: bitwise, the same numpy draws through the same host
  transforms;
- `op_check_images`: the event file's PNG bitwise;
- `nonzero_fractions`, `check_patchify_roundtrip`, `save_nifti`, and the
  `sanity-viz` / `explore-data` commands (with and without matplotlib).
"""

import glob
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from vit_ae_plus_plus_tpu.models import MODEL_ZOO as JAX_ZOO
from vit_ae_plus_plus_tpu.models import build_model as jax_build_model
from vit_ae_plus_plus_tpu.pipelines import sanity_viz as jax_viz
from vit_ae_plus_plus_tpu.train.checkpoint import export_mae_torch_state_dict
from vit_ae_plus_plus_torch import cli
from vit_ae_plus_plus_torch.models import MODEL_ZOO, build_model
from vit_ae_plus_plus_torch.pipelines import sanity_viz
from vit_ae_plus_plus_torch.train.checkpoint import params_from_jax
from vit_ae_plus_plus_torch.utils.nifti import read_nifti

TINY, VOL = "contr_mae_vit_tiny_patch4", 16
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def jax_mae():
    """JAX's tiny MAE with randomised weights -> (model, params)."""
    cfg = JAX_ZOO[TINY](volume_size=VOL, dtype="float32")
    model = jax_build_model(cfg)
    x = jnp.zeros((1, 1, VOL, VOL, VOL))
    shapes = jax.eval_shape(model.init, {"params": jax.random.PRNGKey(0), "mask": jax.random.PRNGKey(1)}, x, x)
    rng = np.random.default_rng(3)

    def leaf(path, a):
        if jax.tree_util.keystr(path).endswith("['scale']"):
            return (1.0 + 0.1 * rng.standard_normal(a.shape)).astype(np.float32)
        return (0.05 * rng.standard_normal(a.shape)).astype(np.float32)

    return model, jax.tree_util.tree_map_with_path(leaf, shapes["params"])


def _port_model(params, dtype="float32"):
    """The port's tiny MAE with JAX's weights (fresh BatchNorm statistics)."""
    model = build_model(MODEL_ZOO[TINY](volume_size=VOL, dtype=dtype))
    sd = model.state_dict()
    sd.update(params_from_jax(params, 4))
    model.load_state_dict(sd, strict=True)
    return model


def _volumes(n, seed=0):
    return np.random.default_rng(seed).standard_normal((n, 1, VOL, VOL, VOL)).astype(np.float32)


class _Jitted:
    """A JAX model whose `apply` is compiled once (JAX's `reconstruct`
    calls `model.apply` eagerly, which compiles op by op)."""

    def __init__(self, model):
        self.cfg = model.cfg
        self.apply = jax.jit(model.apply, static_argnames=("mask_ratio", "train"))


def test_reconstruct_matches_jax(jax_mae):
    model, params = _Jitted(jax_mae[0]), jax_mae[1]
    vols = _volumes(2)
    want = jax_viz.reconstruct(model, {"params": params}, vols, seed=5)
    ids = model.apply({"params": params}, jnp.asarray(vols), None, mask_ratio=0.75,
                      rngs={"mask": jax.random.PRNGKey(5)}, train=False)["ids_restore"]
    noise = np.asarray(ids, np.float32) / ids.shape[1]  # ranks: argsort gives JAX's ids_shuffle
    port = _port_model(params)
    got = sanity_viz.reconstruct(port, vols, noise=torch.from_numpy(noise))
    assert set(got) == set(want) == {"original", "reconstruction", "masked", "paste", "mask"}
    for k in want:
        assert got[k].shape == want[k].shape and got[k].dtype == np.float32, k
        np.testing.assert_allclose(got[k], np.asarray(want[k], np.float32), err_msg=k, **TOL)
    assert got["mask"].mean() == 0.75
    assert sanity_viz.nonzero_fractions(got) == jax_viz.nonzero_fractions(want)
    # without noise: a seeded generator on the model's device, the same draws for the same seed
    a, b = sanity_viz.reconstruct(port, vols, seed=1), sanity_viz.reconstruct(port, vols, seed=1)
    assert all(np.array_equal(a[k], b[k]) for k in a)
    assert not np.array_equal(a["mask"], sanity_viz.reconstruct(port, vols, seed=2)["mask"])


def test_patchify_roundtrip_and_nifti(tmp_path, jax_mae):
    vols = _volumes(1, seed=1)
    assert sanity_viz.check_patchify_roundtrip(vols, 4) and jax_viz.check_patchify_roundtrip(vols, 4)
    port = _port_model(jax_mae[1])
    recon = sanity_viz.reconstruct(port, vols)
    assert sanity_viz.save_nifti(recon, str(tmp_path), sample_idx=0)
    for name in ("original", "masked", "reconstruction", "paste"):
        np.testing.assert_array_equal(read_nifti(str(tmp_path / f"{name}_0.nii.gz")), recon[name][0, 0])


def test_plot_one_slice_equals_jax(tmp_path):
    data = np.random.default_rng(4).standard_normal((3, VOL, VOL, VOL, 1)).astype(np.float32)
    path = str(tmp_path / "flair_all.npy")
    np.save(path, data)
    got = sanity_viz.plot_one_slice(path, out_path=str(tmp_path / "port" / "slice.png"), sample_idx=2, seed=7)
    want = jax_viz.plot_one_slice(path, out_path=str(tmp_path / "jax" / "slice.png"), sample_idx=2, seed=7)
    np.testing.assert_array_equal(got, want)
    assert got.shape == (VOL, VOL) and os.path.getsize(tmp_path / "port" / "slice.png") > 0


def _png_of(log_dir):
    data = open(glob.glob(os.path.join(log_dir, "events.out.tfevents.*"))[0], "rb").read()
    start = data.index(b"\x89PNG")
    return data[start:data.index(b"IEND", start) + 8]


def test_op_check_images_write_jax_png(tmp_path):
    vol = _volumes(1, seed=2)[0]
    sanity_viz.op_check_images(vol, str(tmp_path / "port"))
    jax_viz.op_check_images(vol, str(tmp_path / "jax"))
    assert _png_of(str(tmp_path / "port")) == _png_of(str(tmp_path / "jax"))


@pytest.fixture()
def split_and_checkpoint(tmp_path, jax_mae):
    """A BraTS test split of three 16^3 volumes, and JAX's export of the
    weights (`export-torch`'s .pth)."""
    data = tmp_path / "splits"
    data.mkdir()
    np.save(data / "x_test_ssl.npy", np.random.default_rng(6).random((3, VOL, VOL, VOL, 1)).astype(np.float32))
    np.save(data / "y_test_ssl.npy", np.array([0, 1, 0]))
    sd = export_mae_torch_state_dict(jax_mae[1], JAX_ZOO[TINY](volume_size=VOL))
    ckpt = tmp_path / "mae.pth"
    torch.save({k: torch.from_numpy(np.array(v)) for k, v in sd.items()}, ckpt)
    return data, ckpt


def test_sanity_viz_command(tmp_path, split_and_checkpoint, capsys, monkeypatch):
    """Two samples at the default bf16: the fractions of `reconstruct` with
    seed i, the PNGs of the last sample written as sample 0 (the JAX
    command's quirk)."""
    import json

    from vit_ae_plus_plus_torch.data import get_dataset
    from vit_ae_plus_plus_torch.configs import DataConfig
    from vit_ae_plus_plus_torch.train.checkpoint import load_exported_mae, load_reference_state_dict

    data, ckpt = split_and_checkpoint
    monkeypatch.setenv("HOME", str(tmp_path))  # the URL's cache: ~/.cache/vit_ae_plus_plus_torch/checkpoints
    work = tmp_path / "viz"
    argv = ["sanity-viz", "--data-path", str(data), "--work-dir", str(work), "--checkpoint", ckpt.as_uri(),
            "--model", TINY, "--volume-size", str(VOL), "--device", "cpu"]
    assert cli.main(argv) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    model = build_model(MODEL_ZOO[TINY](volume_size=VOL, dtype="bfloat16"))
    load_exported_mae(model, load_reference_state_dict(str(ckpt)))
    ds = get_dataset("brats", "test", DataConfig(base_path=str(data)), transforms=None, use_z_score=True)
    recons = [sanity_viz.reconstruct(model, ds[i][1][None], seed=i) for i in range(2)]
    assert got == {str(i): sanity_viz.nonzero_fractions(r) for i, r in enumerate(recons)}
    assert sorted(os.listdir(work)) == ["sample0_slice000.png", "sample0_slice008.png"]
    assert len(os.listdir(tmp_path / ".cache" / "vit_ae_plus_plus_torch" / "checkpoints")) == 1


def test_sanity_viz_and_explore_data_need_matplotlib(tmp_path, split_and_checkpoint, monkeypatch, capsys):
    """Without matplotlib the commands exit 2 naming it, before any model
    is built."""
    import sys

    import vit_ae_plus_plus_torch.models as models

    data, ckpt = split_and_checkpoint
    np.save(tmp_path / "flair_all.npy", np.zeros((1, VOL, VOL, VOL, 1), np.float32))
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    monkeypatch.setattr(models, "build_model", lambda cfg: pytest.fail("a model was built"))
    for argv in (["sanity-viz", "--data-path", str(data), "--checkpoint", str(ckpt), "--model", TINY,
                  "--device", "cpu"],
                 ["explore-data", "--volumes", str(tmp_path / "flair_all.npy"), "--out", str(tmp_path / "s.png")]):
        assert cli.run(argv) == 2
        assert "matplotlib is needed" in capsys.readouterr().err
    with pytest.raises(ImportError, match="matplotlib"):
        sanity_viz.save_slice_pngs({}, str(tmp_path))
