"""The port's attention backward on the CPU: the plain backward (the CPU
path of both kernel wrappers, and the reference the CUDA backward kernel is
held to on the card) against autograd and against the JAX package's
backward TPU kernels run in Pallas interpret mode; and the autograd
Functions around the kernels, which on the CPU run the plain versions.

Tolerances: against autograd in f64, 1e-10 (the same formulas up to the
order of f64 sums; delta = rowsum(dO * O) replaces autograd's
rowsum(P * dP), equal in exact arithmetic). Against the Pallas kernels in
f32, 1e-5 relative to the largest gradient with a 1e-6 floor: both sides
compute f32 products and an f32 softmax; only summation order differs."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from vit_ae_plus_plus_tpu.kernels.packed_flash import packed_flash_attention as jax_packed
from vit_ae_plus_plus_tpu.kernels.pallas_flash import flash_attention as jax_flash
from vit_ae_plus_plus_torch.kernels import (
    attention_bwd_plain,
    attention_plain,
    flash_attention,
    flash_attention_bwd,
    packed_attention_bwd_plain,
    packed_attention_plain,
    packed_flash_attention,
    packed_flash_attention_bwd,
    reset_launch_counts,
)
from vit_ae_plus_plus_torch.models.vit import Attention


def _np(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _assert_rel(got, want, rel=1e-5, floor=1e-6, name=""):
    tol = max(rel * float(np.abs(want).max()), floor)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol, err_msg=name)


@pytest.mark.parametrize("n", [1, 65, 130])
def test_plain_backward_matches_autograd(n):
    q, k, v, do = (torch.from_numpy(_np((2, 3, n, 32), s)).double() for s in range(4))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    o, lse = attention_plain(*leaves, 0.3, return_lse=True)
    assert o.dtype == lse.dtype == torch.float64  # f64 is not cut to f32
    o.backward(do)
    got = attention_bwd_plain(q, k, v, o.detach(), lse.detach(), do, 0.3)
    for g, leaf, name in zip(got, leaves, "qkv"):
        torch.testing.assert_close(g, leaf.grad, rtol=1e-10, atol=1e-10, msg=f"d{name}")


@pytest.mark.parametrize("d", [32, 64])
def test_packed_plain_backward_matches_pallas_packed_kernel(d):
    """B=1, N=200 (a ragged tail in the TPU kernel's 128-row blocks), C=128:
    the gradient of qkv through JAX's custom_vjp (`_pk_bwd_kernel`)."""
    qkv, do = _np((1, 200, 3 * 128), d), _np((1, 200, 128), d + 1)
    scale = d**-0.5
    _, vjp = jax.vjp(lambda x: jax_packed(x, d, scale, True), jnp.asarray(qkv))
    (want,) = vjp(jnp.asarray(do))
    t = torch.from_numpy(qkv)
    o, lse = packed_attention_plain(t, d, scale, return_lse=True)
    got = packed_attention_bwd_plain(t, o, lse, torch.from_numpy(do), d, scale)
    assert got.shape == qkv.shape
    _assert_rel(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("n", [200, 600])
def test_plain_backward_matches_pallas_flash(n):
    """N=200 runs the grouped multi-head tier (`_mh_bwd_kernel`), N=600 the
    single-key-block tier (`_fused_bwd_kernel`)."""
    q, k, v, do = (_np((2, 4, n, 64), n + s) for s in range(4))
    _, vjp = jax.vjp(lambda a, b, c: jax_flash(a, b, c, 0.125, interpret=True),
                     *(jnp.asarray(x) for x in (q, k, v)))
    want = vjp(jnp.asarray(do))
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    o, lse = attention_plain(tq, tk, tv, 0.125, return_lse=True)
    got = attention_bwd_plain(tq, tk, tv, o, lse, torch.from_numpy(do), 0.125)
    for g, w, name in zip(got, want, "qkv"):
        _assert_rel(g.numpy(), np.asarray(w), name=f"d{name}")


def test_autograd_functions_run_the_plain_versions_on_cpu():
    """The outputs carry the Functions' grad_fn, backward gives the plain
    backward's gradients, and no kernel launch is counted."""
    reset_launch_counts()
    qkv = torch.from_numpy(_np((2, 50, 3 * 128), 5)).requires_grad_()
    do = torch.from_numpy(_np((2, 50, 128), 6))
    o, lse = packed_flash_attention(qkv, 64, return_lse=True)
    assert type(o.grad_fn).__name__ == "_PackedFlashAttentionBackward" and lse.grad_fn is None
    o.backward(do)
    want = packed_attention_bwd_plain(qkv.detach(), o.detach(), lse, do, 64, 0.125)
    torch.testing.assert_close(qkv.grad, want, rtol=0, atol=0)

    q, k, v = (x.detach().clone().requires_grad_() for x in torch.from_numpy(_np((3, 2, 2, 50, 64), 7)))
    o, lse = flash_attention(q, k, v, return_lse=True)
    assert type(o.grad_fn).__name__ == "_FlashAttentionBackward"
    o.backward(do.view(2, 50, 2, 64).transpose(1, 2))
    want = attention_bwd_plain(q.detach(), k.detach(), v.detach(), o.detach(), lse,
                               do.view(2, 50, 2, 64).transpose(1, 2), 0.125)
    for leaf, w in zip((q, k, v), want):
        torch.testing.assert_close(leaf.grad, w, rtol=0, atol=0)
    counts = [(fn.launches, fn.launches_by_shape) for fn in (flash_attention, flash_attention_bwd,
                                                             packed_flash_attention, packed_flash_attention_bwd)]
    assert counts == [(0, {})] * 4


@pytest.mark.parametrize("impl", ["flash", "auto"])
def test_attention_layer_gradients_reach_the_qkv_projection(impl):
    """Every attn_impl of the layer is differentiable down to the qkv
    projection and agrees with 'plain' (all plain arithmetic on the CPU)."""
    torch.manual_seed(0)
    x = torch.randn(2, 33, 128)
    plain = Attention(128, 2, attn_impl="plain")
    layer = Attention(128, 2, attn_impl=impl)
    layer.load_state_dict(plain.state_dict())
    for m in (plain, layer):
        m(x).square().sum().backward()
    assert float(layer.qkv.weight.grad.abs().max()) > 0
    torch.testing.assert_close(layer.qkv.weight.grad, plain.qkv.weight.grad, rtol=1e-5, atol=1e-6)
