"""The CUDA attention kernels (kernels/csrc/flash_fwd.cu, flash_bwd.cu)
against their plain PyTorch versions, on the card. Every test here needs an NVIDIA GPU and nvcc
and skips without them; this file imports no JAX, so it runs on a GPU
machine with

    python -m pytest --noconftest -m cuda tests/test_torch_port_kernels_cuda.py

Tolerances: `kernel_tolerance` (kernels/flash_attention.py): for o, two bf16
spacings at the plain output's largest magnitude in bf16 (both sides round o
to bf16; the kernel also rounds P for the P V product), 1e-5 in f32; for the
f32 lse, 1e-4. `kernel_mutants.py` shows that these catch a kernel that
drops its last key tile, leaves the ragged key tail unmasked, or is off in
its scale by 1%.

Backward: `bwd_tolerance` (kernels/flash_attention.py): eight bf16 spacings
at the plain gradient's largest magnitude in bf16 (the kernel rounds P and
dS to bf16 before their products, the plain version keeps them in f32, and
both round the result), 1e-5 relative to the largest magnitude in f32.
`kernel_mutants.py` shows that these catch a backward that drops its last
query tile, leaves delta out, or forgets the scale on dk."""

import pytest
import torch

from vit_ae_plus_plus_torch.kernels import (
    attention_bwd_plain,
    attention_plain,
    bwd_tolerance,
    flash_attention,
    flash_attention_bwd,
    kernel_tolerance,
    packed_attention_bwd_plain,
    packed_attention_plain,
    packed_flash_attention,
    packed_flash_attention_bwd,
)
from vit_ae_plus_plus_torch.models.vit import Attention

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU build)")
    return torch.device("cuda")


def _assert_close(o, lse, want_o, want_lse):
    tol_o, tol_lse = kernel_tolerance(want_o)
    torch.testing.assert_close(o.float(), want_o.float(), rtol=0, atol=tol_o)
    torch.testing.assert_close(lse, want_lse, rtol=0, atol=tol_lse)


def _rand(shape, dtype, device, seed):
    g = torch.Generator(device="cpu").manual_seed(seed)
    return torch.randn(shape, generator=g).to(device=device, dtype=dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("n", [1, 63, 64, 65, 200])
def test_per_head_kernel_matches_plain(cuda, dtype, d, n):
    q, k, v = (_rand((2, 3, n, d), dtype, cuda, s) for s in range(3))
    before = flash_attention.launches
    o, lse = flash_attention(q, k, v, return_lse=True)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    want_o, want_lse = attention_plain(q, k, v, d**-0.5, return_lse=True)
    assert o.dtype == dtype and o.shape == q.shape
    _assert_close(o, lse, want_o, want_lse)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", [32, 64, 128])
def test_packed_kernel_matches_plain(cuda, dtype, d):
    qkv = _rand((2, 150, 3 * 384), dtype, cuda, seed=d)  # 3, 6 or 12 heads
    before = packed_flash_attention.launches
    o, lse = packed_flash_attention(qkv, d, return_lse=True)
    torch.cuda.synchronize()
    assert packed_flash_attention.launches == before + 1
    want_o, want_lse = packed_attention_plain(qkv, d, d**-0.5, return_lse=True)
    _assert_close(o, lse, want_o, want_lse)


def test_per_head_kernel_reads_strided_views(cuda):
    """q, k, v as non-contiguous views of one packed projection."""
    qkv = _rand((2, 77, 3 * 128), torch.bfloat16, cuda, seed=7)
    q, k, v = qkv.view(2, 77, 3, 2, 64).permute(2, 0, 3, 1, 4).unbind(0)
    assert not q.is_contiguous()
    got = flash_attention(q, k, v)
    want = packed_flash_attention(qkv, 64).view(2, 77, 2, 64).transpose(1, 2)
    torch.testing.assert_close(got, want, rtol=0, atol=0)  # one kernel, two stride sets


def test_kernel_rejects_misaligned_operands(cuda):
    base = torch.zeros(1, 2, 8, 65, dtype=torch.bfloat16, device=cuda)
    q = base[..., 1:]  # head_dim 64, but rows start off the 16-byte grid
    with pytest.raises(ValueError, match="multiples"):
        flash_attention(q, q, q)


def _assert_grads_close(got, want):
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert bool(torch.isfinite(g).all()), name
        torch.testing.assert_close(g.float(), w.float(), rtol=0, atol=bwd_tolerance(w), msg=name)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("n", [1, 63, 65, 200])
def test_per_head_bwd_kernel_matches_plain(cuda, dtype, d, n):
    """The backward kernel and the plain backward from the same forward
    (o, lse) and output gradient, at ragged lengths."""
    q, k, v, do = (_rand((2, 3, n, d), dtype, cuda, s) for s in range(4))
    o, lse = flash_attention(q, k, v, return_lse=True)
    before = flash_attention_bwd.launches
    got = flash_attention_bwd(q, k, v, o, lse, do, d**-0.5)
    torch.cuda.synchronize()
    assert flash_attention_bwd.launches == before + 1
    _assert_grads_close(got, attention_bwd_plain(q, k, v, o, lse, do, d**-0.5))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", [32, 64, 128])
def test_packed_bwd_kernel_matches_plain(cuda, dtype, d):
    qkv = _rand((2, 150, 3 * 384), dtype, cuda, seed=d)
    do = _rand((2, 150, 384), dtype, cuda, seed=d + 1)
    o, lse = packed_flash_attention(qkv, d, return_lse=True)
    before = packed_flash_attention_bwd.launches
    got = packed_flash_attention_bwd(qkv, o, lse, do, d, d**-0.5)
    torch.cuda.synchronize()
    assert packed_flash_attention_bwd.launches == before + 1
    want = packed_attention_bwd_plain(qkv, o, lse, do, d, d**-0.5)
    assert got.shape == qkv.shape
    _assert_grads_close(got.chunk(3, dim=-1), want.chunk(3, dim=-1))


@pytest.mark.parametrize("layout", ["packed", "per_head"])
def test_autograd_goes_through_the_backward_kernel(cuda, layout):
    """Under autograd on the card each wrapper's output carries a grad_fn,
    and backward() launches the backward kernel once: gradients reach qkv
    (and from there the projection) instead of stopping at the kernel."""
    dtype, d = torch.bfloat16, 64
    qkv = _rand((2, 97, 3 * 128), dtype, cuda, seed=3).requires_grad_()
    w = _rand((2, 97, 128), dtype, cuda, seed=4)
    wrappers = (packed_flash_attention, packed_flash_attention_bwd) if layout == "packed" \
        else (flash_attention, flash_attention_bwd)
    key = (2, 2, 97, d, "bfloat16")  # (B, H, N, d, dtype)
    fwd0, bwd0 = (fn.launches_by_shape.get(key, 0) for fn in wrappers)
    if layout == "packed":
        o, lse = packed_flash_attention(qkv, d, return_lse=True)
    else:
        q, k, v = qkv.view(2, 97, 3, 2, d).permute(2, 0, 3, 1, 4).unbind(0)
        o, lse = flash_attention(q, k, v, return_lse=True)
        o = o.transpose(1, 2).reshape(2, 97, 128)  # the gradient reaches the kernel transposed
    assert o.grad_fn is not None and lse.grad_fn is None
    (o.float() * w.float()).sum().backward()
    torch.cuda.synchronize()
    fwd1, bwd1 = (fn.launches_by_shape.get(key, 0) for fn in wrappers)
    assert (fwd1 - fwd0, bwd1 - bwd0) == (1, 1)
    want = packed_attention_bwd_plain(qkv.detach(), o.detach(), lse, w, d, d**-0.5)
    _assert_grads_close(qkv.grad.chunk(3, dim=-1), want.chunk(3, dim=-1))


def test_auto_attention_raises_where_no_kernel_is_built(cuda):
    """attn_impl='auto' on the card runs the packed kernels or raises: a head
    dim or a dtype they are not built for does not fall back to plain."""
    with pytest.raises(ValueError, match="head_dim"):
        Attention(48, 6).to(cuda)(_rand((1, 10, 48), torch.float32, cuda, seed=5))  # d = 8
    with pytest.raises(ValueError, match="dtype"):
        Attention(128, 2).to(cuda, torch.float64)(_rand((1, 10, 128), torch.float64, cuda, seed=6))
