"""The port's trilinear resize, pos-embed interpolation and the serving
engine's `resize` against the JAX package, on the CPU.

`resize_trilinear` is held to `jax.image.resize(..., "trilinear")` (its
default antialias) at 1e-6 of the largest magnitude in f32: the same
weights, contracted in another summation order."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import torch.nn.functional as F

from vit_ae_plus_plus_tpu.ops import get_3d_sincos_pos_embed as jax_sincos
from vit_ae_plus_plus_tpu.ops import interpolate_pos_embed as jax_interpolate_pos_embed
from vit_ae_plus_plus_tpu.models import MODEL_ZOO as JAX_ZOO
from vit_ae_plus_plus_tpu.pipelines.transfer import mae_params_to_vit as jax_mae_params_to_vit
from vit_ae_plus_plus_torch.models import MODEL_ZOO, build_model
from vit_ae_plus_plus_torch.ops import get_3d_sincos_pos_embed, interpolate_pos_embed, resize_trilinear
from vit_ae_plus_plus_torch.pipelines.transfer import mae_params_to_vit
from vit_ae_plus_plus_torch.serving import BatchingQueue, FeatureEngine
from vit_ae_plus_plus_torch.train.checkpoint import params_from_jax

TOL = 1e-6  # of the largest magnitude
TINY = "contr_mae_vit_tiny_patch4"
VOL = 16


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= tol, err


@pytest.mark.parametrize("src, dst", [
    ((2, 1, 24, 24, 24), (2, 1, 16, 16, 16)),  # downsample: the widened, renormalised kernel
    ((1, 1, 12, 12, 12), (1, 1, 16, 16, 16)),  # upsample
    ((1, 1, 31, 29, 20), (1, 1, 16, 16, 16)),  # non-cubic, odd sizes
    ((1, 2, 16, 24, 13), (1, 2, 16, 16, 16)),  # an unchanged axis, two channels
])
def test_resize_trilinear_matches_jax(src, dst):
    x = np.random.default_rng(sum(src)).standard_normal(src).astype(np.float32)
    want = jax.image.resize(jnp.asarray(x), dst, method="trilinear")
    got = resize_trilinear(torch.from_numpy(x), dst)
    assert got.dtype == torch.float32
    _close(got.numpy(), want)


def test_resize_trilinear_is_not_interpolate_when_downsampling():
    """F.interpolate agrees when upsampling and differs when downsampling
    (no antialias, no renormalisation): why the resize is written by hand."""
    rng = np.random.default_rng(1)
    up = torch.from_numpy(rng.standard_normal((1, 1, 12, 12, 12)).astype(np.float32))
    ref = F.interpolate(up, size=(16, 16, 16), mode="trilinear", align_corners=False)
    _close(resize_trilinear(up, (1, 1, 16, 16, 16)), ref, tol=1e-5)
    down = torch.from_numpy(rng.standard_normal((1, 1, 24, 24, 24)).astype(np.float32))
    ref = F.interpolate(down, size=(16, 16, 16), mode="trilinear", align_corners=False)
    assert (resize_trilinear(down, (1, 1, 16, 16, 16)) - ref).abs().max() > 0.1
    with pytest.raises(ValueError, match="sizes"):
        resize_trilinear(down, (16, 16, 16))


@pytest.mark.parametrize("orig, new", [(4, 6), (8, 4), (4, 4)])
def test_interpolate_pos_embed_matches_jax(orig, new):
    table = np.random.default_rng(orig * new).standard_normal((1, orig**3 + 1, 24)).astype(np.float32)
    want = jax_interpolate_pos_embed(jnp.asarray(table), new**3)
    got = interpolate_pos_embed(torch.from_numpy(table), new**3)
    _close(got.numpy(), want)
    np.testing.assert_array_equal(got[:, :1].numpy(), table[:, :1])  # the cls token is kept
    with pytest.raises(ValueError, match="cube"):
        interpolate_pos_embed(torch.from_numpy(table), new**3 + 1)


def _tiny_mae_tree(seed: int) -> dict:
    """The encoder leaves of a tiny JAX MAE param tree (what the graft reads)."""
    rng = np.random.default_rng(seed)
    d = 24

    def dense(i, o):
        return {"kernel": (0.05 * rng.standard_normal((i, o))).astype(np.float32),
                "bias": (0.05 * rng.standard_normal(o)).astype(np.float32)}

    def ln():
        return {"scale": (1 + 0.1 * rng.standard_normal(d)).astype(np.float32),
                "bias": (0.05 * rng.standard_normal(d)).astype(np.float32)}

    tree = {"patch_embed": {"proj": dense(64, d)}, "cls_token": (0.05 * rng.standard_normal((1, 1, d))).astype(np.float32),
            "norm": ln()}
    for i in range(2):
        tree[f"blocks_{i}"] = {"norm1": ln(), "norm2": ln(),
                               "attn": {"qkv": dense(d, 3 * d), "proj": dense(d, d)},
                               "mlp": {"Dense_0": dense(d, 4 * d), "Dense_1": dense(4 * d, d)}}
    return tree


@pytest.mark.parametrize("mae_vol, vit_vol", [(16, 24), (32, 16)])
def test_mae_params_to_vit_across_patch_counts(mae_vol, vit_vol):
    """An MAE of one patch grid grafted into a ViT of another: the resized
    table against JAX transfer.py's, the copied blocks equal."""
    tree = _tiny_mae_tree(mae_vol)
    jax_mae = JAX_ZOO[TINY](volume_size=mae_vol)
    jax_vit = JAX_ZOO[TINY](volume_size=vit_vol).encoder_vit_config(2, True)
    d, n = 24, jax_vit.num_patches
    vit_tree = {"pos_embed": np.zeros((1, n + 1, d), np.float32), "head": {}, "fc_norm": {},
                **{k: tree[k] for k in ("patch_embed", "cls_token", "blocks_0", "blocks_1")}}
    want = jax_mae_params_to_vit(tree, vit_tree, jax_mae, jax_vit)

    mae_cfg = MODEL_ZOO[TINY](volume_size=mae_vol)
    vit_cfg = MODEL_ZOO[TINY](volume_size=vit_vol).encoder_vit_config(2, True)
    with torch.device("meta"):
        vit_sd = build_model(vit_cfg).state_dict()
    got = mae_params_to_vit(params_from_jax(tree, 4), vit_sd, mae_cfg, vit_cfg)
    assert got["pos_embed"].shape == vit_sd["pos_embed"].shape == (1, n + 1, d)
    _close(got["pos_embed"].numpy(), want["pos_embed"])
    np.testing.assert_array_equal(got["blocks.1.mlp.fc2.weight"].numpy(), tree["blocks_1"]["mlp"]["Dense_1"]["kernel"].T)
    # the table resized is the MAE's own sincos table
    grid = round(mae_cfg.num_patches ** (1 / 3))
    np.testing.assert_array_equal(get_3d_sincos_pos_embed(d, grid, True), jax_sincos(d, grid, True))


def test_engine_resize_inputs():
    """`resize=True` resamples mismatched spatial sizes before the slab (the
    JAX engine's `jax.image.resize` input), leaves the model's size alone,
    co-batches requests of mixed sizes, and still refuses a channel
    mismatch; without it, a mismatched volume is refused."""
    tree = _tiny_mae_tree(0)
    kw = dict(model_name=TINY, volume_size=VOL, patch_size=4, batch_size=4, compute_dtype="float32",
              mae_params=tree, device="cpu")
    plain, eng = FeatureEngine(**kw), FeatureEngine(resize=True, **kw)
    big = np.random.default_rng(9).standard_normal((2, 1, 24, 24, 24)).astype(np.float32)
    want_in = np.array(jax.image.resize(jnp.asarray(big), (2, 1, VOL, VOL, VOL), method="trilinear"))
    np.testing.assert_allclose(eng.infer(big), plain.infer(want_in), rtol=1e-5, atol=1e-6)
    same = np.random.default_rng(10).standard_normal((2, 1, VOL, VOL, VOL)).astype(np.float32)
    np.testing.assert_array_equal(eng.infer(same), plain.infer(same))
    with pytest.raises(ValueError, match="channel"):
        eng.infer(np.zeros((1, 2, 24, 24, 24), np.float32))
    with pytest.raises(ValueError, match="expected"):
        plain.infer(big)

    queue = BatchingQueue(eng, max_wait_ms=200)
    try:
        pendings = queue.submit_many([big[0], same[0], big[1]])
        for p in pendings:
            assert p.event.wait(60) and p.error is None
        got = np.stack([p.result for p in pendings])
        assert queue.stats()["total_batches"] == 1
    finally:
        queue.close()
    np.testing.assert_allclose(got, plain.infer(np.stack([want_in[0], same[0], want_in[1]])), rtol=1e-5, atol=1e-6)
