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
LayerNorm+Dense products of csrc/ln_dense.cu (the second part of this
file), in their own chunked order, for the f32 attention backward of
csrc/flash_bwd.cu (the third part), whose permuted transposed copies are
emulated too, and for the f32 forward's own order on tf32 wgmma (the last
part: truncating score accumulators, a fresh P V accumulator a key stage,
V's permuted transposed copy). On the card the CUDA tests and
`kernel_mutants.py` (the low terms dropped, the copies unpermuted, a
stage's accumulator carried over, O left unscaled) check the kernels
themselves.
"""

import numpy as np
import pytest
import torch

from vit_ae_plus_plus_torch.kernels import attention_bwd_plain, attention_plain, bwd_tolerance, kernel_tolerance
from vit_ae_plus_plus_torch.kernels.fused_ln import row_tolerance
from vit_ae_plus_plus_torch.kernels.fused_ln_dense import dln_tolerance, ln_dense_bwd_plain, ln_dense_plain


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The emulation runs many small products: with torch's threads on
    every core beside the other test workers, the file took 15 times as
    long as on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 -> the nearest TF32 value (10 explicit mantissa bits), ties away
    from zero: cvt.rna.tf32.f32."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split(x: torch.Tensor):
    hi = to_tf32(x)
    return hi, to_tf32(x - hi)


def mm_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as 3xTF32 with f32 sums: the small terms, then hi * hi."""
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


# ------------------------------------------------------------ attention backward
# csrc/flash_bwd.cu's f32 backward runs its products as 3xTF32 on tf32
# wgmma. A pre-pass splits Q, K, V and dO into hi and lo copies, and writes
# transposed hi and lo copies of Q, dO and K (d x tokens) whose token axis
# is permuted within each 8-token group: position t holds token 2t and
# position t + 4 token 2t + 1 (`FRAG`). That is the order in which a wgmma
# accumulator's columns land in a register A fragment, so P^T, dS^T and dS
# go from the S^T / dP^T / S / dP accumulators straight into the A operand
# of dV += P^T dO, dK += dS^T Q and dQ += dS K, split into hi and lo in
# registers. Each stage's partial dK, dV or dQ is summed in a fresh
# truncating accumulator (per k8 step three products) and then added to an
# f32 sum rounded to nearest; S^T, dP^T, S and dP sum d in one truncating
# accumulator per 64 dims. At d = 32 and 64 one dK/dV kernel streams
# 32-query stages and the dQ kernel 32-key stages. At d = 128 a dV kernel
# (32-query stages, S^T and dV), a dK kernel (16-query stages, S^T once
# more, dP^T and dK) and the dQ kernel (16-key stages) share the
# pre-passes: the chunk depths of `bwd_chunks`.

FRAG = [0, 2, 4, 6, 1, 3, 5, 7]  # A-fragment depth position p -> the accumulator column (token) it holds
LOG2E = 1.4426950408889634


def bwd_chunks(d):
    """The depth of a fresh accumulator in the dV, dK and dQ products: the
    stage's rows (csrc/flash_bwd.cu `Tf32KvRing`, `Tf32QRing`)."""
    return {"dv": 32, "dk": 16, "dq": 16} if d == 128 else {"dv": 32, "dk": 32, "dq": 32}


def _truncating_dots(acc, steps):
    """acc plus each (a, b) of `steps` in turn, a @ b taken exactly and
    added rounding toward zero: one k8 product of the tensor cores."""
    for a, b in steps:
        acc = _add_toward_zero(acc, a.double() @ b.double())
    return acc


def _split_pairs(a, b, lo_terms):
    """The three products of a 3xTF32 k8 step in the kernel's order (a.lo
    b.hi, a.hi b.lo, a.hi b.hi), or hi * hi alone (plain TF32)."""
    (a_hi, a_lo), (b_hi, b_lo) = split(a), split(b)
    return ((a_lo, b_hi), (a_hi, b_lo), (a_hi, b_hi)) if lo_terms else ((a_hi, b_hi),)


def scores_tf32(a, b, lo_terms=True):
    """a (.., M, d) @ b (.., N, d)^T with both operands K-major: d in k8
    steps in order, one truncating accumulator per 64 dims (S^T, dP^T, S,
    dP; at d = 128 two, added to nearest: csrc/flash_bwd.cu
    `scores_split`)."""
    total = torch.zeros(*a.shape[:-1], b.shape[-2])
    for h0 in range(0, a.shape[-1], 64):
        acc = torch.zeros_like(total)
        for c0 in range(h0, min(h0 + 64, a.shape[-1]), 8):
            pairs = _split_pairs(a[..., c0:c0 + 8], b[..., c0:c0 + 8].transpose(-1, -2), lo_terms)
            acc = _truncating_dots(acc, pairs)
        total = total + acc
    return total


def chunked_tf32(x, y, lo_terms=True, copy_order=FRAG, chunk=32):
    """x (.., M, T) @ y (.., T, N) over T in the kernels' order: per
    `chunk`-deep stage a fresh truncating accumulator, added to the f32 sum.
    In k8 step kk of a stage, A position p holds x's column 8kk + FRAG[p]
    (the accumulator reinterpreted as an A fragment) and the transposed
    copy's position p holds y's row 8kk + copy_order[p]: right only when the
    two agree."""
    t_pad = -(-x.shape[-1] // chunk) * chunk
    x = torch.nn.functional.pad(x, (0, t_pad - x.shape[-1]))
    y = torch.nn.functional.pad(y, (0, 0, 0, t_pad - y.shape[-2]))
    total = torch.zeros(*x.shape[:-1], y.shape[-1])
    for c0 in range(0, t_pad, chunk):
        acc = torch.zeros_like(total)
        for s0 in range(c0, c0 + chunk, 8):
            cols = [s0 + i for i in FRAG]
            rows = [s0 + i for i in copy_order]
            acc = _truncating_dots(acc, _split_pairs(x[..., cols], y[..., rows, :], lo_terms))
        total = total + acc
    return total


def attention_bwd_tf32(q, k, v, o, lse, do, scale, bias=None, lo_terms=("dkdv", "dq"), copy_order=FRAG,
                       chunks=None, with_dq=True):
    """(dq, dk, dv) in the f32 backward kernels' order. `lo_terms` names the
    kernels that keep 3xTF32 ("dkdv": the dK/dV side, at d = 128 both its
    kernels; "dq"), the others run plain TF32; `copy_order` is the
    transposed copies' token order within each 8-token group; `chunks` the
    depth of a fresh accumulator in each product (default `bwd_chunks`).
    Without `with_dq`, the dK/dV side alone: dq is None."""
    chunks = bwd_chunks(q.shape[-1]) if chunks is None else chunks
    kb = torch.zeros(k.shape[-2]) if bias is None else bias * LOG2E
    lse2 = lse[..., None] * LOG2E
    delta = (do * o).sum(-1, keepdim=True)
    # the dK/dV side: key rows, query columns
    dkdv = "dkdv" in lo_terms

    # at d = 128 the dK kernel computes S^T once more, over d in the dV
    # kernel's order: the same values, so one P^T serves both products
    pt = torch.exp2(scores_tf32(k, q, dkdv) * (scale * LOG2E) + kb[:, None] - lse2.transpose(-1, -2))
    dv = chunked_tf32(pt, do, dkdv, copy_order, chunks["dv"])
    dst = pt * (scores_tf32(v, do, dkdv) - delta.transpose(-1, -2))
    dk = chunked_tf32(dst, q, dkdv, copy_order, chunks["dk"]) * scale
    if not with_dq:
        return None, dk, dv
    # the dQ kernel: query rows, key columns
    s = scores_tf32(q, k, "dq" in lo_terms)
    dp = scores_tf32(do, v, "dq" in lo_terms)
    ds = torch.exp2(s * (scale * LOG2E) + kb - lse2) * (dp - delta)
    dq = chunked_tf32(ds, k, "dq" in lo_terms, copy_order, chunks["dq"]) * scale
    return dq, dk, dv


def _bwd_operands(d, nq, nk, seed, with_bias):
    """q, k, v, do and the forward's o and lse, as `attention_bwd_plain`
    takes them; with the bias, the block's last keys padded (a ring step)."""
    q, k, v, bias = _operands(d, nq, nk, seed, with_bias)
    do = torch.from_numpy(np.random.default_rng(seed + 1).standard_normal(q.shape).astype(np.float32))
    o, lse = attention_plain(q, k, v, d**-0.5, return_lse=True, bias=bias)
    return q, k, v, o, lse, do, bias


def _bwd_errors(grads, want):
    """(max abs error, bwd_tolerance) of dq, dk and dv."""
    return [(float((g - w).abs().max()), bwd_tolerance(w)) for g, w in zip(grads, want)]


BWD_SHAPES = [(d, nq, nk) for d in (32, 64, 128) for nq, nk in ((65, 65), (40, 200), (130, 63))]


def test_transposed_copies_hold_the_a_fragments_token_order():
    """Position t of each 8-token group holds token 2t and position t + 4
    token 2t + 1, and that is where an m64nNk8 accumulator's columns land
    when read as a tf32 A fragment: a thread holds columns 2t and 2t + 1 of
    each 8-column group (acc[4j], acc[4j + 1] on row g), and A fragment
    registers a0 and a2 are depth t and t + 4."""
    assert sorted(FRAG) == list(range(8))
    for t in range(4):
        assert (FRAG[t], FRAG[t + 4]) == (2 * t, 2 * t + 1)
        acc_columns = (2 * t, 2 * t + 1)  # acc[4j + 0], acc[4j + 1]: the thread's two columns
        a_depths = (t, t + 4)  # the A fragment registers the kernel moves them into: a0, a2
        assert tuple(FRAG[p] for p in a_depths) == acc_columns


@pytest.mark.parametrize("d,nq,nk", BWD_SHAPES)
@pytest.mark.parametrize("with_bias", [False, True])
def test_3xtf32_attention_bwd_is_within_bwd_tolerance(d, nq, nk, with_bias):
    """The kernels' order, with 32-deep truncating chunks and the permuted
    transposed copies, within half of `bwd_tolerance` (room for the card's
    order). Most of the error is the score accumulators' truncation over d:
    summed to nearest they would read a tenth of the tolerance."""
    q, k, v, o, lse, do, bias = _bwd_operands(d, nq, nk, d + nq + nk, with_bias)
    want = attention_bwd_plain(q, k, v, o, lse, do, d**-0.5, bias)
    got = attention_bwd_tf32(q, k, v, o, lse, do, d**-0.5, bias)
    for err, tol in _bwd_errors(got, want):
        assert err <= tol / 2


@pytest.mark.parametrize("d,nq,nk", BWD_SHAPES)
@pytest.mark.parametrize("plain_in", ["dkdv", "dq"])
def test_plain_tf32_attention_bwd_is_outside_bwd_tolerance(d, nq, nk, plain_in):
    """Dropping the low terms in the dK/dV kernel (dk, dv move) or in the
    dQ kernel (dq moves), as kernel_mutants.py's f32 backward mutants do,
    moves a gradient past `bwd_tolerance`."""
    q, k, v, o, lse, do, bias = _bwd_operands(d, nq, nk, d + nq + nk, False)
    want = attention_bwd_plain(q, k, v, o, lse, do, d**-0.5, bias)
    kept = tuple(name for name in ("dkdv", "dq") if name != plain_in)
    errs = _bwd_errors(attention_bwd_tf32(q, k, v, o, lse, do, d**-0.5, bias, lo_terms=kept), want)
    moved = errs[:1] if plain_in == "dq" else errs[1:]
    assert all(err > 2 * tol for err, tol in moved)


@pytest.mark.parametrize("d,nq,nk", BWD_SHAPES)
def test_unpermuted_transposed_copies_are_outside_bwd_tolerance(d, nq, nk):
    """Copies in token order pair P's column 2t with dO's row t: every
    gradient lands far outside `bwd_tolerance`."""
    q, k, v, o, lse, do, bias = _bwd_operands(d, nq, nk, d + nq + nk, False)
    want = attention_bwd_plain(q, k, v, o, lse, do, d**-0.5, bias)
    got = attention_bwd_tf32(q, k, v, o, lse, do, d**-0.5, bias, copy_order=list(range(8)))
    assert all(err > 2 * tol for err, tol in _bwd_errors(got, want))


def test_one_accumulator_attention_bwd_at_d128_is_outside_bwd_tolerance():
    """Why a fresh accumulator per stage at d = 128 as well: dV and dK summed
    over all queries in one truncating accumulator drift past
    `bwd_tolerance`. The truncation is a bias that grows with the partial
    sums, so it shows where they grow one way: here over the decoder's
    1,729 rows, one head, with the output gradient offset by 1 (every dV
    term then adds with the same sign). Zero-mean dO reads about 0.6 of the
    tolerance there; the kernels' 16- and 32-deep chunks read under 0.2."""
    n, d = 1729, 128
    rng = np.random.default_rng(n)
    q, k, v, do = (torch.from_numpy(rng.standard_normal((1, 1, n, d)).astype(np.float32)) for _ in range(4))
    do = do + 1
    o, lse = attention_plain(q, k, v, d**-0.5, return_lse=True)
    want = attention_bwd_plain(q, k, v, o, lse, do, d**-0.5)
    whole = -(-n // 8) * 8
    got = attention_bwd_tf32(q, k, v, o, lse, do, d**-0.5, chunks=dict.fromkeys(("dv", "dk", "dq"), whole),
                             with_dq=False)
    errs = _bwd_errors(got[1:], want[1:])
    assert all(err > tol for err, tol in errs)  # dk, dv


# ------------------------------------------------------------- attention forward
# csrc/flash_fwd.cu's f32 forward runs both products as 3xTF32 on tf32 wgmma.
# Q and K are split into hi and lo copies (K by a pre-pass, Q in shared
# memory), and the pre-pass writes a transposed hi and lo copy of V (d x
# tokens) whose token axis is permuted within each 8-token group (FRAG), so
# that P goes from the S accumulator straight into the A operand of P V. Per stage of keys (`fwd_stage`): S = Q K^T sums d in
# one truncating accumulator (at d = 128 two of 64 dims, added to nearest),
# the online softmax in the log2 domain gives P and alpha, and P V sums the
# stage's keys in a fresh truncating accumulator, which is added to O to
# nearest after O is scaled by alpha.

LN2 = 0.6931471805599453


def fwd_stage(d):
    """Keys a stage of the f32 forward: the depth of a fresh P V accumulator
    (csrc/flash_fwd.cu `Tf32Fwd`)."""
    return 32 if d == 128 else 64


def split_alu(x: torch.Tensor):
    """csrc/flash_common.cuh `split_tf32_alu`, P's split: hi as `to_tf32`,
    lo = x - hi unrounded, which the tensor core truncates to TF32."""
    hi = to_tf32(x)
    return hi, ((x - hi).contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def pv_tf32(p, v, acc, copy_order=FRAG):
    """acc plus p (.., M, T) @ v (.., T, D) in k8 steps, each taken exactly
    and added rounding toward zero, a.lo b.hi, a.hi b.lo, a.hi b.hi: A
    position j holds p's column 8kk + FRAG[j] (split by `split_alu`), the
    transposed copy's position j v's row 8kk + copy_order[j]."""
    t_pad = -(-p.shape[-1] // 8) * 8
    p = torch.nn.functional.pad(p, (0, t_pad - p.shape[-1]))
    v = torch.nn.functional.pad(v, (0, 0, 0, t_pad - v.shape[-2]))
    for s0 in range(0, t_pad, 8):
        a_hi, a_lo = split_alu(p[..., [s0 + i for i in FRAG]])
        b_hi, b_lo = split(v[..., [s0 + i for i in copy_order], :])
        acc = _truncating_dots(acc, ((a_lo, b_hi), (a_hi, b_lo), (a_hi, b_hi)))
    return acc


def attention_fwd_tf32(q, k, v, scale, bias=None, copy_order=FRAG, one_accumulator=False):
    """(o, lse) in the f32 forward kernel's order. `copy_order` is V^T's
    token order within each 8-token group; `one_accumulator` sums P V over
    every stage in one truncating accumulator that O's alpha scale rewrites
    in place (the bf16 body's way), instead of a fresh one a stage."""
    nk, stage = k.shape[-2], fwd_stage(q.shape[-1])
    kb = torch.zeros(nk) if bias is None else bias * LOG2E
    scale2 = torch.tensor(scale * LOG2E, dtype=torch.float32)
    m = torch.full((*q.shape[:-1], 1), -float("inf"))
    l = torch.zeros_like(m)
    o = torch.zeros(q.shape)
    for k0 in range(0, nk, stage):
        x = scores_tf32(q, k[..., k0:k0 + stage, :]) * scale2 + kb[k0:k0 + stage]
        mx = torch.maximum(m, x.amax(dim=-1, keepdim=True))
        alpha = torch.exp2(m - mx)
        p = torch.exp2(x - mx)
        m, l = mx, l * alpha + p.sum(dim=-1, keepdim=True)
        vs = v[..., k0:k0 + stage, :]
        if one_accumulator:
            o = pv_tf32(p, vs, o * alpha, copy_order)
        else:
            o = o * alpha + pv_tf32(p, vs, torch.zeros(o.shape), copy_order)
    return o / l, ((m + torch.log2(l)) * LN2).squeeze(-1)


@pytest.mark.parametrize("d,nq,nk", SHAPES)
@pytest.mark.parametrize("with_bias", [False, True])
def test_3xtf32_attention_fwd_in_kernel_order_is_within_kernel_tolerance(d, nq, nk, with_bias):
    """The f32 forward's order, truncating score and P V accumulators, a
    fresh one a key stage and the permuted V^T, within half of
    `kernel_tolerance` (room for the card's order), ragged stages and the
    ring's padded keys included."""
    q, k, v, bias = _operands(d, nq, nk, seed=d + nq + nk, with_bias=with_bias)
    want_o, want_lse = attention_plain(q, k, v, d**-0.5, return_lse=True, bias=bias)
    o, lse = attention_fwd_tf32(q, k, v, d**-0.5, bias)
    tol_o, tol_lse = kernel_tolerance(want_o)
    assert float((o - want_o).abs().max()) <= tol_o / 2
    assert float((lse - want_lse).abs().max()) <= tol_lse / 2


@pytest.mark.parametrize("d,nq,nk", SHAPES)
def test_unpermuted_v_copy_is_outside_kernel_tolerance(d, nq, nk):
    """V^T in token order pairs P's column 2t with V's row t: o lands far
    outside `kernel_tolerance` (kernel_mutants.py's unpermuted copy)."""
    q, k, v, _ = _operands(d, nq, nk, seed=d + nq + nk, with_bias=False)
    want_o = attention_plain(q, k, v, d**-0.5)
    o, _ = attention_fwd_tf32(q, k, v, d**-0.5, copy_order=list(range(8)))
    assert float((o - want_o).abs().max()) > 2 * kernel_tolerance(want_o)[0]


@pytest.mark.parametrize("d", [32, 64, 128])
def test_one_accumulator_attention_fwd_is_outside_kernel_tolerance(d):
    """Why a fresh P V accumulator a stage: a warpgroup's 64 query rows
    against the decoder's 1,729 keys, P V summed in one truncating
    accumulator, drift past `kernel_tolerance` (about 1.8 times it). The
    truncation is a bias that grows with the sum, so it shows where the
    terms add one way: V offset by 1 (o near 1). The kernel's order reads
    about a tenth of the tolerance on the same inputs."""
    n = 1729
    rng = np.random.default_rng(n + d)
    q = torch.from_numpy(rng.standard_normal((1, 1, 64, d)).astype(np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((1, 1, n, d)).astype(np.float32)) for _ in range(2))
    v = v + 1
    want_o = attention_plain(q, k, v, d**-0.5)
    tol_o = kernel_tolerance(want_o)[0]
    o, _ = attention_fwd_tf32(q, k, v, d**-0.5)
    drifted, _ = attention_fwd_tf32(q, k, v, d**-0.5, one_accumulator=True)
    assert float((o - want_o).abs().max()) <= tol_o / 2
    assert float((drifted - want_o).abs().max()) > tol_o
