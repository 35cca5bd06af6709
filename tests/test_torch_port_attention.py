"""The port's attention against the JAX package's Pallas kernels.

The plain versions (the port's CPU path and the reference its CUDA kernel is
held to on the card) are compared with the TPU kernels run in Pallas
interpret mode, as tests/test_flash_attention.py runs them, on the same
numpy inputs in f32. Tolerance 1e-5: both sides compute f32 softmax
attention; only the summation order differs."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from vit_ae_plus_plus_tpu.kernels.packed_flash import packed_flash_attention as jax_packed
from vit_ae_plus_plus_tpu.kernels.pallas_flash import flash_attention as jax_flash
from vit_ae_plus_plus_torch.kernels import (
    attention_plain,
    flash_attention,
    kernel_tolerance,
    multihead_attention,
    packed_attention_plain,
    packed_flash_attention,
)

TOL = dict(rtol=1e-5, atol=1e-5)


def _qkv(b, n, c, seed=0):
    return np.random.default_rng(seed).standard_normal((b, n, 3 * c)).astype(np.float32)


@pytest.mark.parametrize("d", [32, 64])
def test_plain_packed_matches_pallas_packed_kernel(d):
    """B=2, N=400 (a ragged tail in the TPU kernel's 128-row blocks), C=128."""
    qkv = _qkv(2, 400, 128, seed=d)
    scale = d**-0.5
    want = np.asarray(jax_packed(jnp.asarray(qkv), d, scale, True))
    got = packed_attention_plain(torch.from_numpy(qkv), d, scale)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("n", [200, 700])
def test_plain_per_head_matches_pallas_flash(n):
    """N=200 runs the grouped multi-head tier, N=700 the single-key-block tier."""
    rng = np.random.default_rng(n)
    q, k, v = (rng.standard_normal((2, 4, n, 64)).astype(np.float32) for _ in range(3))
    want = np.asarray(
        jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 0.125, interpret=True)
    )
    got = attention_plain(*(torch.from_numpy(x) for x in (q, k, v)), 0.125)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_plain_lse_is_logsumexp_and_packed_agrees_with_per_head():
    qkv = torch.from_numpy(_qkv(2, 97, 64, seed=5))
    o_p, lse_p = packed_attention_plain(qkv, 32, 0.2, return_lse=True)
    q, k, v = qkv.view(2, 97, 3, 2, 32).permute(2, 0, 3, 1, 4).unbind(0)
    o_h, lse_h = attention_plain(q, k, v, 0.2, return_lse=True)
    np.testing.assert_allclose(o_p.numpy(), o_h.transpose(1, 2).reshape(2, 97, 64).numpy(), **TOL)
    want = torch.logsumexp(q @ k.transpose(-1, -2) * 0.2, dim=-1)
    np.testing.assert_allclose(lse_p.numpy(), want.numpy(), **TOL)
    np.testing.assert_allclose(lse_h.numpy(), want.numpy(), **TOL)


def test_wrappers_take_the_plain_path_on_cpu_and_count_no_launch():
    packed_flash_attention.launches = 0
    flash_attention.launches = 0
    qkv = torch.from_numpy(_qkv(1, 50, 128, seed=2))
    got = packed_flash_attention(qkv, 64)
    np.testing.assert_array_equal(got.numpy(), packed_attention_plain(qkv, 64, 0.125).numpy())
    q, k, v = qkv.view(1, 50, 3, 2, 64).permute(2, 0, 3, 1, 4).unbind(0)
    o, lse = flash_attention(q, k, v, return_lse=True)
    want_o, want_lse = attention_plain(q, k, v, 0.125, return_lse=True)
    np.testing.assert_array_equal(o.numpy(), want_o.numpy())
    np.testing.assert_array_equal(lse.numpy(), want_lse.numpy())
    for impl in ("flash", "plain"):
        np.testing.assert_array_equal(multihead_attention(q, k, v, impl).numpy(), want_o.numpy())
    assert packed_flash_attention.launches == 0
    assert flash_attention.launches == 0


def test_wrappers_reject_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="head_dim"):
        packed_flash_attention(torch.zeros(1, 8, 3 * 48), 48)
    with pytest.raises(ValueError, match="multiple of head_dim"):
        packed_flash_attention(torch.zeros(1, 8, 3 * 96), 64)
    with pytest.raises(ValueError, match="dtype"):
        packed_flash_attention(torch.zeros(1, 8, 3 * 64, dtype=torch.float16), 64)
    q = torch.zeros(1, 2, 8, 64)
    with pytest.raises(ValueError, match="match"):
        flash_attention(q, torch.zeros(1, 2, 9, 64), q)
    for impl in ("xla", "auto"):  # 'auto' is the model's choice (models/vit.py), not this one's
        with pytest.raises(ValueError, match="impl"):
            multihead_attention(q, q, q, impl)


@pytest.mark.parametrize(
    "top, want", [(0.3, 2 * 2.0**-9), (0.25, 2 * 2.0**-9), (0.2, 2 * 2.0**-10), (3.0, 2 * 2.0**-6)]
)
def test_kernel_tolerance_is_two_bf16_spacings_at_the_largest_output(top, want):
    o = torch.tensor([0.01, -top, top / 2]).to(torch.bfloat16)
    tol_o, tol_lse = kernel_tolerance(o)
    assert tol_o == want
    assert tol_lse == 1e-4
    assert kernel_tolerance(o.float()) == (1e-5, 1e-4)
