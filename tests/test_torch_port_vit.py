"""The port's ViT and feature engine against the JAX package, on the same
numpy weights and volumes, in f32 on the CPU.

Tolerance 1e-5 (absolute and relative): both sides run the same f32
arithmetic; only the order of summation inside matmuls and reductions
differs."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from vit_ae_plus_plus_tpu.configs import ViTConfig as JaxViTConfig
from vit_ae_plus_plus_tpu.models import MODEL_ZOO as JAX_ZOO
from vit_ae_plus_plus_tpu.models import build_model as jax_build_model
from vit_ae_plus_plus_tpu.pipelines.probe_kfold import _mae_params_template
from vit_ae_plus_plus_tpu.serving import FeatureEngine as JaxFeatureEngine
from vit_ae_plus_plus_tpu.train.checkpoint import export_mae_torch_state_dict
from vit_ae_plus_plus_torch.configs import ViTConfig
from vit_ae_plus_plus_torch.models import MODEL_ZOO, VisionTransformer3D, build_model
from vit_ae_plus_plus_torch.pipelines.transfer import mae_params_to_vit
from vit_ae_plus_plus_torch.serving import FeatureEngine
from vit_ae_plus_plus_torch.train.checkpoint import load_reference_state_dict, params_from_jax
from vit_ae_plus_plus_torch.train.step import feature_step

TOL = dict(rtol=1e-5, atol=1e-5)
TINY = "contr_mae_vit_tiny_patch4"
VOL = 16


def _randomize(tree, seed):
    """Numpy weights for every leaf: LayerNorm scales near 1, the rest small."""
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        if jax.tree_util.keystr(path).endswith("['scale']"):
            return (1.0 + 0.1 * rng.standard_normal(x.shape)).astype(np.float32)
        return (0.05 * rng.standard_normal(x.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, tree)


def _vols(n, size=VOL, seed=0):
    return np.random.default_rng(seed).standard_normal((n, 1, size, size, size)).astype(np.float32)


def _jax_vit(cfg, seed):
    model = jax_build_model(cfg)
    s = cfg.volume_size
    params = model.init(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, cfg.in_chans, s, s, s))
    )["params"]
    return model, _randomize(jax.tree.map(np.asarray, params), seed)


def _port_vit(cfg_kw, jax_params):
    model = VisionTransformer3D(ViTConfig(**cfg_kw))
    model.load_state_dict(params_from_jax(jax_params, cfg_kw["patch_size"]), strict=True)
    return model.eval()


@pytest.mark.parametrize("global_pool", [True, False])
def test_vit_forward_features_matches_jax(global_pool):
    """Tiny preset (16^3, patch 4, width 24, 3 heads), weights through
    params_from_jax; features and the classifier head's logits."""
    jax_cfg = JAX_ZOO[TINY](volume_size=VOL).encoder_vit_config(2, global_pool)
    cfg_kw = dict(
        volume_size=VOL, patch_size=4, embed_dim=24, depth=2, num_heads=3,
        num_classes=2, global_pool=global_pool,
    )
    assert MODEL_ZOO[TINY](volume_size=VOL).encoder_vit_config(2, global_pool) == ViTConfig(**cfg_kw)
    jmodel, params = _jax_vit(jax_cfg, seed=1)
    x = _vols(3, seed=2)
    want = np.asarray(jmodel.apply({"params": params}, jnp.asarray(x), method=jmodel.forward_features))
    want_logits = np.asarray(jmodel.apply({"params": params}, jnp.asarray(x)))
    port = _port_vit(cfg_kw, params)
    np.testing.assert_allclose(feature_step(port, torch.from_numpy(x)).numpy(), want, **TOL)
    with torch.inference_mode():
        np.testing.assert_allclose(port(torch.from_numpy(x)).numpy(), want_logits, **TOL)


@pytest.mark.parametrize("impl", ["auto", "flash", "plain"])
def test_vit_slice_matches_jax_through_the_pallas_packed_kernel(impl):
    """Width 128, 2 heads of 64, 32^3 with patch 4 (513 tokens), depth 1: the
    JAX side runs its packed Pallas kernel in interpret mode; every attn_impl
    of the port (all plain on the CPU) agrees with it."""
    cfg_kw = dict(volume_size=32, patch_size=4, embed_dim=128, depth=1, num_heads=2)
    jmodel, params = _jax_vit(JaxViTConfig(**cfg_kw, attn_impl="flash_packed"), seed=3)
    x = _vols(2, size=32, seed=4)
    want = np.asarray(jmodel.apply({"params": params}, jnp.asarray(x), method=jmodel.forward_features))
    port = _port_vit({**cfg_kw, "attn_impl": impl}, params)
    np.testing.assert_allclose(feature_step(port, torch.from_numpy(x)).numpy(), want, **TOL)


@pytest.fixture(scope="module")
def mae_params():
    template = _mae_params_template(JAX_ZOO[TINY](volume_size=VOL), 0)
    return _randomize(jax.tree.map(np.asarray, template), seed=3)


ENGINE_KW = dict(model_name=TINY, volume_size=VOL, patch_size=4, batch_size=4,
                 compute_dtype="float32")


@pytest.mark.parametrize("normalize", ["none", "zscore"])
def test_feature_engine_matches_jax_engine(mae_params, normalize):
    """Five volumes: a full slab and a padded one."""
    vols = _vols(5, seed=5) * 3.0 + 1.0
    want = JaxFeatureEngine(None, mae_params=mae_params, normalize=normalize, **ENGINE_KW).infer(vols)
    engine = FeatureEngine(mae_params=mae_params, normalize=normalize, device="cpu", **ENGINE_KW)
    got = engine.infer(vols)
    assert got.shape == (5, 24) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(engine.infer(vols[:2]), got[:2], **TOL)  # padding leaks nothing


def test_feature_engine_from_exported_pth_matches_jax(mae_params, tmp_path):
    """The `.pth` the JAX package's export-torch writes loads into the port."""
    cfg = JAX_ZOO[TINY](volume_size=VOL)
    sd = export_mae_torch_state_dict(mae_params, cfg)
    path = str(tmp_path / "mae.pth")
    torch.save({k: torch.from_numpy(v.copy()) for k, v in sd.items()}, path)
    assert set(load_reference_state_dict(path)) == set(sd)
    vols = _vols(3, seed=6)
    want = JaxFeatureEngine(None, mae_params=mae_params, **ENGINE_KW).infer(vols)
    got = FeatureEngine(path, device="cpu", **ENGINE_KW).infer(vols)
    np.testing.assert_allclose(got, want, **TOL)


def test_params_from_jax_matches_export_layout(mae_params):
    """The port's bridge emits the same keys and values as the JAX export
    (less the fixed pos-embed tables and BN statistics the export adds)."""
    cfg = JAX_ZOO[TINY](volume_size=VOL)
    ref = export_mae_torch_state_dict(mae_params, cfg)
    got = params_from_jax(mae_params, cfg.patch_size, cfg.in_chans)
    extra = {"pos_embed", "decoder_pos_embed"} | {k for k in ref if "running" in k or "num_batches" in k}
    assert set(got) == set(ref) - extra
    for k, v in got.items():
        np.testing.assert_array_equal(v.numpy(), ref[k], err_msg=k)


def test_graft_checks_fresh_keys_and_grid(mae_params):
    cfg = MODEL_ZOO[TINY](volume_size=VOL)
    vit_cfg = cfg.encoder_vit_config()
    mae_sd = params_from_jax(mae_params, 4)
    with torch.device("meta"):
        vit_sd = build_model(vit_cfg).state_dict()
    sd = mae_params_to_vit(mae_sd, vit_sd, cfg, vit_cfg)
    assert set(sd) == set(vit_sd)
    np.testing.assert_array_equal(sd["fc_norm.weight"].numpy(), np.ones(24, np.float32))
    # an MAE of another patch grid: its table resized to the ViT's grid
    # (tests/test_torch_port_resize.py holds the table to JAX's)
    other = MODEL_ZOO[TINY](volume_size=2 * VOL)
    resized = mae_params_to_vit(mae_sd, vit_sd, other, vit_cfg)
    assert resized["pos_embed"].shape == vit_sd["pos_embed"].shape
    assert not torch.equal(resized["pos_embed"], sd["pos_embed"])
    del mae_sd["cls_token"]
    with pytest.raises(AssertionError, match="fresh"):
        mae_params_to_vit(mae_sd, vit_sd, cfg, vit_cfg)
    assert type(build_model(cfg)).__name__ == "MaskedAutoencoderViT3D"  # the MAE is ported
