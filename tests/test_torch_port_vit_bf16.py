"""The port's bf16 ViT against the JAX package's bf16 ViT compiled with XLA's
excess precision off (`xla_allow_excess_precision`: with it on, XLA drops
the bf16 roundings that flax declares), on the CPU.

- Every Dense layer of the ViT (the patch embed, qkv, proj, fc1 and fc2 of a
  block) at the tiny ViT's shapes, against flax's `nn.Dense(dtype=
  bfloat16)`, which rounds the product to bf16 and then adds the bias (two
  roundings): the outputs equal but for a share `MISMATCH_SHARE` that the
  order of a sum flips, the patch embed's bitwise; the input's, kernel's
  and bias's gradients within `DENSE_GRAD_TOL`. Control: the bias added
  inside the product (one rounding, what the port's `_linear` did before)
  must exceed that share.
- The whole bf16 trunk (depth 2, width 48, 16^3 at patch 4, batch 4),
  forward and backward through a weighted sum of its features, within
  `VIT_BF16_TOL`. At this level the Dense rounding is not what the reading
  shows: JAX's bf16 GELU (each erf step rounded to bf16) and its plain
  attention (scores rounded to bf16; the port keeps them in f32, as its
  kernels do) differ from the port by about one bf16 spacing anyway, and the
  model in f32 reads the same distance from JAX's bf16 model, so the limits
  hold only faults larger than bf16 noise (ROADMAP Queue 3).
"""

import jax
import jax.numpy as jnp
import flax.linen as nn
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from vit_ae_plus_plus_tpu.configs import ViTConfig as JViTConfig
from vit_ae_plus_plus_tpu.models.vit import PatchEmbed3D as JPatchEmbed3D
from vit_ae_plus_plus_tpu.models.vit import VisionTransformer3D as JViT
from vit_ae_plus_plus_torch.configs import ViTConfig
from vit_ae_plus_plus_torch.models import VisionTransformer3D
from vit_ae_plus_plus_torch.models import vit as tv
from vit_ae_plus_plus_torch.train.checkpoint import params_from_jax

B, VOL, PATCH, WIDTH = 4, 16, 4, 48
KW = dict(volume_size=VOL, patch_size=PATCH, embed_dim=WIDTH, depth=2, num_heads=3, num_classes=0,
          global_pool=False, dtype="bfloat16")
NO_EXCESS = {"xla_allow_excess_precision": False}
ROWS = B * ((VOL // PATCH) ** 3 + 1)
# the Dense forward: outputs that differ from flax's at all, as a share of
# the outputs. The port reads at most 2.7e-5 (1 of 37,440 at qkv, where the
# order of an f32 sum flips a bf16 rounding), the one-rounding control 0.28
MISMATCH_SHARE = 1e-3
# the Dense gradients over their largest magnitude: the port reads at most
# 4.0e-6 on the kernel's and 3.2e-6 on the input's (sums in another order),
# and 1.1e-2 on the bias's, a sum over 260 rows that XLA without excess
# precision accumulates in bf16 and the port in f32
DENSE_GRAD_TOL = {"weight": 1e-4, "x": 1e-4, "bias": 3e-2}
# the whole trunk: the port reads features 7.4e-3, gradients median 9.2e-3
# and worst 4.7e-2; the f32 model reads 5.4e-3, 1.0e-2, 4.6e-2
VIT_BF16_TOL = {"features": 2e-2, "grads_median": 3e-2, "grads": 0.1}


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(got, want) -> float:
    got = got.detach().double().numpy()
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _bf16(a: np.ndarray) -> np.ndarray:
    """`a` rounded to bf16, as f32: an input both sides see exactly."""
    return torch.from_numpy(a).bfloat16().float().numpy()


@pytest.mark.parametrize("fan_in, fan_out", [(WIDTH, 3 * WIDTH), (WIDTH, WIDTH), (WIDTH, 4 * WIDTH),
                                             (4 * WIDTH, WIDTH)], ids=["qkv", "proj", "fc1", "fc2"])
def test_dense_bf16_rounds_as_flax(fan_in, fan_out):
    rng = np.random.default_rng(fan_in + fan_out)
    x = _bf16(rng.standard_normal((ROWS, fan_in)).astype(np.float32))
    kernel = (rng.standard_normal((fan_in, fan_out)) / np.sqrt(fan_in)).astype(np.float32)
    bias = rng.standard_normal(fan_out).astype(np.float32)
    dy = rng.standard_normal((ROWS, fan_out)).astype(np.float32)
    dense = nn.Dense(fan_out, dtype=jnp.bfloat16)
    params = {"params": {"kernel": kernel, "bias": bias}}

    def jax_fn(params, x):
        y, vjp = jax.vjp(lambda p, x: dense.apply(p, x.astype(jnp.bfloat16)), params, x)
        gp, gx = vjp(dy.astype(jnp.bfloat16))
        return y.astype(jnp.float32), gp["params"]["kernel"], gp["params"]["bias"], gx

    y, gk, gb, gx = jax.device_get(jax.jit(jax_fn).lower(params, x).compile(NO_EXCESS)(params, x))

    layer = torch.nn.Linear(fan_in, fan_out)
    with torch.no_grad():
        layer.weight.copy_(torch.from_numpy(kernel.T))
        layer.bias.copy_(torch.from_numpy(bias))
    xt = torch.from_numpy(x).bfloat16().requires_grad_()
    out = tv._linear(xt, layer)
    out.backward(torch.from_numpy(dy).bfloat16())
    assert out.dtype == torch.bfloat16
    errs = {"weight": _rel(layer.weight.grad, gk.T), "bias": _rel(layer.bias.grad, gb), "x": _rel(xt.grad, gx)}
    with torch.no_grad():
        one = F.linear(xt, layer.weight.bfloat16(), layer.bias.bfloat16())
    shares = [float((z.float() != torch.from_numpy(y)).float().mean()) for z in (out, one)]
    assert shares[0] <= MISMATCH_SHARE < shares[1], shares
    assert all(errs[k] <= DENSE_GRAD_TOL[k] for k in errs), errs


def test_patch_embed_bf16_rounds_as_flax():
    """The patch embed's Dense over (dz, dy, dx, c) rows, its kernel unfolded
    into the Conv3d layout: bitwise the JAX package's bf16 patch embed."""
    jmod = JPatchEmbed3D(PATCH, WIDTH, dtype=jnp.bfloat16)
    vol = np.random.default_rng(5).standard_normal((B, 1, VOL, VOL, VOL)).astype(np.float32)
    variables = jax.jit(jmod.init)({"params": jax.random.PRNGKey(0)}, vol)
    variables = jax.tree.map(lambda a: np.asarray(a) + 0.1, variables)  # a nonzero bias
    want = np.asarray(jax.jit(jmod.apply).lower(variables, vol).compile(NO_EXCESS)(variables, vol), np.float32)
    sd = params_from_jax({"patch_embed": variables["params"]}, PATCH, 1)
    port = tv.PatchEmbed3D(PATCH, 1, WIDTH)
    port.load_state_dict({k.split(".", 1)[1]: v for k, v in sd.items()}, strict=True)
    with torch.no_grad():
        got = port(torch.from_numpy(vol), torch.bfloat16)
    assert torch.equal(got.float(), torch.from_numpy(want))


def test_vit_bf16_forward_backward_against_jax():
    jm = JViT(JViTConfig(**KW))
    x = np.random.default_rng(2).standard_normal((B, 1, VOL, VOL, VOL)).astype(np.float32)
    params = jax.jit(jm.init)({"params": jax.random.PRNGKey(0)}, x)["params"]
    rng = np.random.default_rng(1)
    params = jax.tree_util.tree_map_with_path(
        lambda p, leaf: ((1 + 0.1 * rng.standard_normal(leaf.shape)) if p[-1].key == "scale"
                         else 0.05 * rng.standard_normal(leaf.shape)).astype(np.float32), params)
    weight = np.random.default_rng(3).standard_normal((B, WIDTH)).astype(np.float32)

    def jax_fn(p, x):
        def loss(p):
            y = jm.apply({"params": p}, x, method=jm.forward_features)
            return jnp.sum(y.astype(jnp.float32) * weight), y

        (_, y), g = jax.value_and_grad(loss, has_aux=True)(p)
        return y.astype(jnp.float32), g

    y, grads = jax.device_get(jax.jit(jax_fn).lower(params, x).compile(NO_EXCESS)(params, x))
    want = params_from_jax(grads, PATCH)
    model = VisionTransformer3D(ViTConfig(**KW))
    model.load_state_dict(params_from_jax(params, PATCH), strict=True)
    feats = model.forward_features(torch.from_numpy(x))
    assert feats.dtype == torch.bfloat16
    (feats.float() * torch.from_numpy(weight)).sum().backward()
    errs = [_rel(p.grad, want[n]) for n, p in model.named_parameters()]
    got = {"features": _rel(feats.float(), y), "grads_median": float(np.median(errs)), "grads": max(errs)}
    assert all(got[k] <= VIT_BF16_TOL[k] for k in VIT_BF16_TOL), got
