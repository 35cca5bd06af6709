"""The CUDA attention kernel (kernels/csrc/flash_fwd.cu) against its plain
PyTorch version, on the card. Every test here needs an NVIDIA GPU and nvcc
and skips without them; this file imports no JAX, so it runs on a GPU
machine with

    python -m pytest --noconftest -m cuda tests/test_torch_port_kernels_cuda.py

Tolerances: `kernel_tolerance` (kernels/flash_attention.py): for o, two bf16
spacings at the plain output's largest magnitude in bf16 (both sides round o
to bf16; the kernel also rounds P for the P V product), 1e-5 in f32; for the
f32 lse, 1e-4. `kernel_mutants.py` shows that these catch a kernel that
drops its last key tile, leaves the ragged key tail unmasked, or is off in
its scale by 1%."""

import pytest
import torch

from vit_ae_plus_plus_torch.kernels import (
    attention_plain,
    flash_attention,
    kernel_tolerance,
    packed_attention_plain,
    packed_flash_attention,
)

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
