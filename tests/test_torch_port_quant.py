"""The port's int8 engine (models/quant.py) against the JAX package's, on the
tiny preset on the CPU: the quantised weights and the int32 accumulators
bitwise, the f32-compute features within 1e-3 of the largest feature (a
token's int8 rounding may flip where the two sides' f32 activations differ
in the last bit), the unquantised wiring within 1e-6 of the port's own
`forward_features` (the same operations), and the JAX package's int8
feature-quality contract."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from test_torch_port_resize import _tiny_mae_tree
from vit_ae_plus_plus_tpu.configs import ViTConfig as JaxViTConfig
from vit_ae_plus_plus_tpu.models import quant as jq
from vit_ae_plus_plus_torch.configs import ViTConfig
from vit_ae_plus_plus_torch.models import MODEL_ZOO, VisionTransformer3D
from vit_ae_plus_plus_torch.models import quant
from vit_ae_plus_plus_torch.pipelines.transfer import build_grafted_vit
from vit_ae_plus_plus_torch.serving import FeatureEngine
from vit_ae_plus_plus_torch.train.checkpoint import params_from_jax

CFG_KW = dict(volume_size=16, patch_size=4, in_chans=1, embed_dim=24, depth=2, num_heads=3,
              num_classes=2, global_pool=True, dtype="float32")
JAX_CFG = JaxViTConfig(attn_impl="xla", **CFG_KW)
CFG = ViTConfig(**CFG_KW)
FEAT_TOL = 1e-3  # of the largest feature
DENSE = ("attn.qkv", "attn.proj", "mlp.fc1", "mlp.fc2")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny_vit_tree(seed: int) -> dict:
    """A tiny JAX ViT param tree (classifier head of 2) of seeded numpy
    weights: the MAE encoder leaves of the resize tests, its `norm` as
    `fc_norm`, a learned pos_embed and a head."""
    rng = np.random.default_rng(seed + 100)
    tree = _tiny_mae_tree(seed)
    tree["fc_norm"] = tree.pop("norm")
    tree["pos_embed"] = (0.05 * rng.standard_normal((1, 65, 24))).astype(np.float32)
    tree["head"] = {"kernel": (0.3 * rng.standard_normal((24, 2))).astype(np.float32),
                    "bias": (0.1 * rng.standard_normal(2)).astype(np.float32)}
    return tree


@pytest.fixture(scope="module")
def vit():
    """A tiny ViT tree, the port's state dict of it and four seeded volumes."""
    params = tiny_vit_tree(3)
    x = np.random.default_rng(0).standard_normal((4, 1, 16, 16, 16)).astype(np.float32)
    return params, params_from_jax(params, 4, 1), x


def _rel(a, b) -> float:
    return float(np.abs(np.asarray(a) - np.asarray(b)).max() / np.abs(np.asarray(b)).max())


def test_quantize_params_bitwise(vit):
    params, sd, _ = vit
    want, got = jq.quantize_params(params), quant.quantize_params(sd)
    pairs = [("patch_embed.proj.weight", want["patch_embed"]["proj"]["kernel"])]
    names = dict(zip(DENSE, (("attn", "qkv"), ("attn", "proj"), ("mlp", "Dense_0"), ("mlp", "Dense_1"))))
    for i in range(2):
        for layer, (a, b) in names.items():
            pairs.append((f"blocks.{i}.{layer}.weight", want[f"blocks_{i}"][a][b]["kernel"]))
    for key, w in pairs:
        assert got[key]["w8"].dtype == torch.int8 and got[key]["scale"].dtype == torch.float32
        np.testing.assert_array_equal(got[key]["w8"].numpy().T, np.asarray(w["w8"]), err_msg=key)
        np.testing.assert_array_equal(got[key]["scale"].numpy(), np.asarray(w["scale"]), err_msg=key)
    quantized = {key for key, _ in pairs}
    assert {k for k, v in got.items() if isinstance(v, dict)} == quantized
    assert all(got[k] is sd[k] for k in sd if k not in quantized)  # the rest passes through


def test_int8_accumulator_bitwise(vit):
    """The per-token quantisation and the int32 product of `_qdot`, on the
    same f32 activations and int8 weight as JAX's."""
    _, sd, _ = vit
    x = np.random.default_rng(5).standard_normal((4, 65, 24)).astype(np.float32) * 3
    w = quant.quantize_params(sd)["blocks.0.mlp.fc1.weight"]
    xf = jnp.asarray(x)
    amax = jnp.maximum(jnp.max(jnp.abs(xf), axis=-1, keepdims=True), 1e-12)
    want_scale = amax / 127.0
    want_x8 = jnp.clip(jnp.round(xf / want_scale), -127, 127).astype(jnp.int8)
    want = jax.lax.dot_general(want_x8, jnp.asarray(w["w8"].numpy().T), (((2,), (0,)), ((), ())),
                               preferred_element_type=jnp.int32)
    x8, xscale = quant.quantize_tokens(torch.from_numpy(x))
    np.testing.assert_array_equal(x8.numpy(), np.asarray(want_x8))
    np.testing.assert_array_equal(xscale.numpy(), np.asarray(want_scale))
    acc = quant.int8_matmul(x8.reshape(-1, 24), w["w8"])
    assert acc.dtype == torch.int32
    np.testing.assert_array_equal(acc.view(4, 65, -1).numpy(), np.asarray(want))
    for rows, k in ((16, 24), (32, 20)):  # what the card's int8 GEMM refuses raises on every device
        with pytest.raises(ValueError, match="refused"):
            quant.int8_matmul(torch.zeros(rows, k, dtype=torch.int8), torch.zeros(8, k, dtype=torch.int8))


def test_quant_forward_features_matches_jax(vit):
    params, sd, x = vit
    want = jax.jit(lambda q, v: jq.quant_forward_features(q, JAX_CFG, v))(jq.quantize_params(params), x)
    got = quant.quant_forward_features(quant.quantize_params(sd), CFG, torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (4, 24)
    assert _rel(got.numpy(), want) <= FEAT_TOL


def test_unquantized_is_forward_features_and_int8_tracks_it(vit):
    """quantized=False over the raw state dict is the trunk (the JAX
    package's wiring check); int8 keeps the cosine above 0.99 and every
    volume's nearest neighbour (tests/test_quant_extract.py's contract)."""
    _, sd, x = vit
    model = VisionTransformer3D(CFG)
    model.load_state_dict(sd, strict=True)
    with torch.inference_mode():
        want = model.eval().forward_features(torch.from_numpy(x)).numpy()
    wired = quant.quant_forward_features(sd, CFG, torch.from_numpy(x), quantized=False).numpy()
    assert _rel(wired, want) <= 1e-6
    got = quant.QuantizedViT(sd, CFG).forward_features(torch.from_numpy(x)).numpy()
    cos = np.sum(got * want, -1) / (np.linalg.norm(got, axis=-1) * np.linalg.norm(want, axis=-1))
    assert cos.min() > 0.99, cos
    d_f32 = np.linalg.norm(want[:, None] - want[None], axis=-1)
    d_int8 = np.linalg.norm(got[:, None] - got[None], axis=-1)
    assert (np.argsort(d_f32, -1)[:, 1] == np.argsort(d_int8, -1)[:, 1]).all()


def test_feature_engine_int8(vit):
    """FeatureEngine(quantize='int8') from an MAE tree is the int8 trunk
    over the grafted weights (the graft is held to JAX in
    test_torch_port_vit.py), a padded partial slab included; another
    `quantize` raises."""
    _, _, x = vit
    mae = _tiny_mae_tree(7)
    kw = dict(model_name="contr_mae_vit_tiny_patch4", volume_size=16, patch_size=4, batch_size=4,
              compute_dtype="float32", mae_params=mae, device="cpu")
    got = FeatureEngine(quantize="int8", **kw).infer(x[:3])
    mae_cfg = MODEL_ZOO["contr_mae_vit_tiny_patch4"](volume_size=16, dtype="float32")
    vit_cfg = mae_cfg.encoder_vit_config(num_classes=2, global_pool=True)
    grafted = build_grafted_vit(params_from_jax(mae, 4, 1), mae_cfg, vit_cfg, torch.device("cpu"))
    want = quant.QuantizedViT(grafted.state_dict(), vit_cfg).forward_features(torch.from_numpy(x))
    assert got.shape == (3, 24)
    np.testing.assert_array_equal(got, want[:3].numpy())
    with pytest.raises(ValueError, match="quantize"):
        FeatureEngine(quantize="int4", **kw)
