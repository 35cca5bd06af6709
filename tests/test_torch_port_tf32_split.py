"""The error budget of the f32 attention kernel's 3xTF32 arithmetic, on the CPU.

csrc/flash_fwd.cu runs f32 attention on the TF32 tensor cores: each f32
operand x is split into hi = tf32(x) and lo = tf32(x - hi) (round to
nearest, ties away), and a product a * b becomes a.hi * b.hi + a.hi * b.lo +
a.lo * b.hi summed in f32, a.lo * b.lo dropped (flash_common.cuh). The card
is not here, so this file emulates that arithmetic in torch (TF32 rounding
by masking the 13 low mantissa bits; products of two TF32 values are exact
in f32) and shows, at small ragged shapes, that the emulation stays within
`kernel_tolerance` of `attention_plain` while plain TF32 (hi * hi alone)
does not: the 1e-5 on o sees the low terms. On the card the CUDA tests and
`kernel_mutants.py` (the low terms dropped) check the kernel itself.
"""

import numpy as np
import pytest
import torch

from vit_ae_plus_plus_torch.kernels import attention_plain, kernel_tolerance


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 -> the nearest TF32 value (10 explicit mantissa bits), ties away
    from zero: cvt.rna.tf32.f32."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split(x: torch.Tensor):
    hi = to_tf32(x)
    return hi, to_tf32(x - hi)


def mm_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as the kernel's mma_1688_3xtf32: the small terms, then hi * hi."""
    (a_hi, a_lo), (b_hi, b_lo) = split(a), split(b)
    return a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi


def mm_tf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b with the operands rounded to TF32 once: plain TF32."""
    return to_tf32(a) @ to_tf32(b)


def attention_emulated(q, k, v, scale, mm, bias=None):
    """The kernel's forward with its products taken by `mm`: S = Q K^T
    scaled, the key bias added, P = exp(S - max) in f32, O = (P V) / sum(P),
    lse = max + log(sum(P))."""
    s = mm(q, k.transpose(-1, -2)) * scale
    if bias is not None:
        s = s + bias
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    return mm(p, v) / l, (m + torch.log(l)).squeeze(-1)


def _operands(d, nq, nk, seed, with_bias):
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 3, n, d)).astype(np.float32)) for n in (nq, nk, nk))
    bias = None
    if with_bias:  # a ring block with its last keys padded
        bias = torch.zeros(nk)
        bias[nk - max(1, nk // 8):] = -1e30
    return q, k, v, bias


SHAPES = [(d, nq, nk) for d in (32, 64, 128) for nq, nk in ((65, 65), (40, 200), (130, 63))]


def test_tf32_split_is_exact_to_about_2_pow_minus_22():
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(10_000).astype(np.float32))
    hi, lo = split(x)
    assert bool(((hi.view(torch.int32) & 0x1FFF) == 0).all()) and bool(((lo.view(torch.int32) & 0x1FFF) == 0).all())
    assert float(((x - hi).abs() / x.abs()).max()) <= 2.0**-11
    assert float(((x.double() - hi.double() - lo.double()).abs() / x.abs().double()).max()) <= 2.0**-21


@pytest.mark.parametrize("d,nq,nk", SHAPES)
@pytest.mark.parametrize("with_bias", [False, True])
def test_3xtf32_attention_is_within_kernel_tolerance(d, nq, nk, with_bias):
    q, k, v, bias = _operands(d, nq, nk, seed=d + nq + nk, with_bias=with_bias)
    want_o, want_lse = attention_plain(q, k, v, d**-0.5, return_lse=True, bias=bias)
    o, lse = attention_emulated(q, k, v, d**-0.5, mm_3xtf32, bias)
    tol_o, tol_lse = kernel_tolerance(want_o)
    assert float((o - want_o).abs().max()) <= tol_o / 4  # with room for the card's summation order
    assert float((lse - want_lse).abs().max()) <= tol_lse / 4


@pytest.mark.parametrize("d,nq,nk", SHAPES)
def test_plain_tf32_attention_is_outside_kernel_tolerance(d, nq, nk):
    """Dropping the low terms (a mutant of kernel_mutants.py) moves o by
    more than `kernel_tolerance` allows."""
    q, k, v, _ = _operands(d, nq, nk, seed=d + nq + nk, with_bias=False)
    want_o = attention_plain(q, k, v, d**-0.5)
    o, _ = attention_emulated(q, k, v, d**-0.5, mm_tf32)
    tol_o, _ = kernel_tolerance(want_o)
    assert float((o - want_o).abs().max()) > 2 * tol_o
