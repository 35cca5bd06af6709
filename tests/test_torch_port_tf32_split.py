"""The error budget of the f32 kernels' 3xTF32 arithmetic, on the CPU.

csrc/flash_fwd.cu runs f32 attention on the TF32 tensor cores: each f32
operand x is split into hi = tf32(x) and lo = tf32(x - hi) (round to
nearest, ties away), and a product a * b becomes a.hi * b.hi + a.hi * b.lo +
a.lo * b.hi summed in f32, a.lo * b.lo dropped (flash_common.cuh). The card
is not here, so this file emulates that arithmetic in torch (TF32 rounding
by masking the 13 low mantissa bits; products of two TF32 values are exact
in f32) and shows, at small ragged shapes, that the emulation stays within
`kernel_tolerance` of `attention_plain` while plain TF32 (hi * hi alone)
does not: the 1e-5 on o sees the low terms. The same holds for the f32
LayerNorm+Dense products of csrc/ln_dense.cu (the second half of this
file), in their own chunked order. On the card the CUDA tests and
`kernel_mutants.py` (the low terms dropped) check the kernels themselves.
"""

import numpy as np
import pytest
import torch

from vit_ae_plus_plus_torch.kernels import attention_plain, kernel_tolerance
from vit_ae_plus_plus_torch.kernels.fused_ln import row_tolerance
from vit_ae_plus_plus_torch.kernels.fused_ln_dense import dln_tolerance, ln_dense_bwd_plain, ln_dense_plain


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


# ---------------------------------------------------------------- LayerNorm+Dense
# csrc/ln_dense.cu's f32 bodies run both products, y = LN(x) W^T + b and
# dln = dY W, as 3xTF32 on wgmma m64n128k8: W is split into hi and lo by a
# pre-pass that permutes each 32-wide depth group (`tf32_perm`), A (the
# normalised rows or dY) is split in registers, and each 32-deep chunk of
# the depth is summed in a fresh tensor-core accumulator (12 products,
# each an 8-term dot) that is then added to an f32 sum. The emulation below
# takes each 8-term dot exactly and adds it to the accumulator rounded
# toward zero (the tensor cores' f32 sums truncate), the chunk sums to
# nearest.

STAGE = 32  # kTfStageK: the depth of a stage and of a fresh accumulator


def tf32_perm(p: int) -> int:
    """csrc/ln_dense.cu `tf32_perm`: the depth stored at physical column p
    of a 32-wide group of the split W."""
    return 8 * (p & 3) + 2 * (p >> 3) + ((p >> 2) & 1)


PERM = [tf32_perm(p) for p in range(STAGE)]


def _add_toward_zero(acc: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """acc (f32) + x (f64), rounded toward zero to f32."""
    exact = acc.double() + x
    r = exact.float()
    return torch.where(r.double().abs() > exact.abs(), torch.nextafter(r, torch.zeros_like(r)), r)


def mm_tf32_chunked(a: torch.Tensor, b: torch.Tensor, lo_terms: bool = True, chunk: int = STAGE) -> torch.Tensor:
    """a (M, K) @ b (K, N) in the f32 kernel's order: per `chunk`-deep
    chunk (the kernel's: 32) a fresh accumulator; in each 32-deep stage four
    k8 steps, step kk over the depth the permuted columns 8kk .. 8kk + 7
    hold; per step a.lo b.hi, a.hi b.lo and a.hi b.hi (`lo_terms` False:
    a.hi b.hi alone, plain TF32)."""
    (a_hi, a_lo), (b_hi, b_lo) = split(a), split(b)
    pairs = ((a_lo, b_hi), (a_hi, b_lo), (a_hi, b_hi)) if lo_terms else ((a_hi, b_hi),)
    total = torch.zeros(a.shape[0], b.shape[1])
    acc = torch.zeros_like(total)
    for c0 in range(0, a.shape[1], STAGE):
        for kk in range(STAGE // 8):
            depth = [c0 + PERM[8 * kk + j] for j in range(8)]
            for x, y in pairs:
                acc = _add_toward_zero(acc, x[:, depth].double() @ y[depth].double())
        if (c0 + STAGE) % chunk == 0:
            total, acc = total + acc, torch.zeros_like(total)
    return total


def _lnd_operands(r, c, f, seed):
    """chip_smoke.ln_operands' spreads: x mean 1 spread 2, gamma near 1,
    beta, w (F, C) of spread C^-1/2, b of spread 0.1, dy (R, F)."""
    rng = np.random.default_rng(seed)
    rand = lambda *shape: torch.from_numpy(rng.standard_normal(shape).astype(np.float32))  # noqa: E731
    return 2 * rand(r, c) + 1, 1 + 0.1 * rand(c), 0.1 * rand(c), c**-0.5 * rand(f, c), 0.1 * rand(f), rand(r, f)


def lnd_emulated(product, r, c, f, seed, lo_terms=True, chunk=STAGE):
    """(got, want, tolerance) of one product at (R, C, F): the emulation
    against `ln_dense_plain` (y, `row_tolerance`) or `ln_dense_bwd_plain`
    (dln, `dln_tolerance`). The forward normalises as the kernel does, with
    the plain statistics."""
    x, gamma, beta, w, b, dy = _lnd_operands(r, c, f, seed)
    want_y, mu, rstd = ln_dense_plain(x, gamma, beta, w, b, 1e-6)
    if product == "fwd":
        ln = ((x - mu[:, None]) * rstd[:, None]) * gamma + beta
        return mm_tf32_chunked(ln, w.t(), lo_terms, chunk) + b, want_y, row_tolerance(want_y)
    _, want_dln = ln_dense_bwd_plain(x, gamma, w, dy, mu, rstd)
    return mm_tf32_chunked(dy, w, lo_terms, chunk), want_dln, dln_tolerance(want_dln, torch.float32)


# (product, R, C, F): the forward at the model's widths C 512 and 768 (F
# small: the depth is C), the dln product at the depths F 1,536 and 3,072
LND_CASES = [("fwd", 37, 512, 96), ("fwd", 37, 768, 96), ("dln", 19, 512, 1536), ("dln", 19, 768, 3072)]


def test_tf32_perm_gives_each_lane_eight_contiguous_depths():
    """The permutation is one of the 32 depths, and lane t's fragments of
    the four k8 steps (physical columns 8kk + t and 8kk + t + 4) hold depth
    8t .. 8t + 7: the kernel's two 16-byte loads per row."""
    assert sorted(PERM) == list(range(STAGE))
    for t in range(4):
        assert sorted(PERM[8 * kk + 4 * h + t] for kk in range(4) for h in range(2)) == list(range(8 * t, 8 * t + 8))


@pytest.mark.parametrize("product,r,c,f", LND_CASES)
def test_3xtf32_ln_dense_is_within_tolerance(product, r, c, f):
    """The f32 kernels' order, truncating accumulators and all, within a
    quarter of the tolerance the card's checks use."""
    got, want, tol = lnd_emulated(product, r, c, f, seed=c + f)
    assert float((got - want).abs().max()) <= tol / 4


@pytest.mark.parametrize("product,r,c,f", LND_CASES)
def test_plain_tf32_ln_dense_is_outside_tolerance(product, r, c, f):
    """Dropping the low terms (kernel_mutants.py's f32 LayerNorm+Dense
    mutants) moves y and dln by more than the tolerance allows."""
    got, want, tol = lnd_emulated(product, r, c, f, seed=c + f, lo_terms=False)
    assert float((got - want).abs().max()) > 2 * tol


@pytest.mark.parametrize("product,r,c,f", [case for case in LND_CASES if case[0] == "dln"])
def test_one_accumulator_dln_is_outside_tolerance(product, r, c, f):
    """Why the chunks: the same products summed in one truncating
    accumulator over all of F drift past `dln_tolerance`."""
    got, want, tol = lnd_emulated(product, r, c, f, seed=c + f, chunk=f)
    assert float((got - want).abs().max()) > tol
