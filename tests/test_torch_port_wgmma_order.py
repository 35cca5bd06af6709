"""The arithmetic order of the wgmma kernels, emulated on the CPU.

csrc/flash_fwd.cu's bf16 forward, csrc/flash_bwd.cu's bf16 backward and
csrc/ln_dense.cu's bf16 dln product run only on the card. This file repeats
their order in torch at small ragged shapes and holds it to the plain
versions within the tolerances the card's checks use (`kernel_tolerance`,
`bwd_tolerance`, `dln_tolerance`, `fused_ln.compare`):

- attention forward: 64-key tiles walked last to first (the ragged one,
  keys past kv_len masked to -inf, first); per tile S in f32, x = S scale
  log2(e) + bias log2(e), the running max m, alpha = exp2(m_old - m_new),
  P = exp2(x - m) in f32 summed into l, O += P V with P rounded to bf16
  for the tile before, then O scaled by alpha; o = O / l, lse = (m +
  log2 l) ln 2.

- attention: delta = rowsum(dO * O) in f32; the dK/dV kernel walks 64-query
  tiles (zero-filled past seq_len, where lse reads +inf and delta 0), forms
  P^T = exp2(S^T scale log2(e) + bias log2(e) - lse log2(e)) and dS^T = P^T
  (dP^T - delta) in f32, rounds both to bf16, and adds each tile's f32
  products P^T dO and dS^T Q to dV and dK in tile order; the dQ kernel walks
  64-key tiles (keys past kv_len masked to P = 0) and adds dS K. bf16
  products are exact in f32, so each tile's f32 matmul stands for the
  tensor cores' sums.
- #7b: dln = dY W summed over 64-deep stages of F in order, each stage's
  f32 product added to one f32 accumulator; then the LayerNorm row pass.

A deliberately wrong order falls outside: a dropped tile or stage, and in
the forward O left unscaled when the running max grows.
"""

import math

import numpy as np
import pytest
import torch

from vit_ae_plus_plus_torch.kernels import attention_bwd_plain, attention_plain, bwd_tolerance, kernel_tolerance
from vit_ae_plus_plus_torch.kernels.fused_ln import compare, layernorm_bwd_plain, row_stats_plain
from vit_ae_plus_plus_torch.kernels.fused_ln_dense import dln_tolerance, ln_dense_bwd_plain

TILE = 64
LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453
NEG_INF = -1e30


def _bf16(x: torch.Tensor) -> torch.Tensor:
    """Round to bf16 and back to f32 (the kernels' __floats2bfloat162_rn)."""
    return x.to(torch.bfloat16).float()


def attention_fwd_tiled(q, k, v, scale, bias=None, rescale=True, drop_last_tile=False):
    """(o, lse) in the bf16 forward kernel's order over bf16 q (B, H, N, D)
    and k, v (B, H, Nk, D); `rescale=False` leaves O unscaled when the
    running max grows and `drop_last_tile` skips the last key tile (wrong
    orders for the tests)."""
    qf, kf, vf = (t.float() for t in (q, k, v))
    nk = k.shape[2]
    ktiles = math.ceil(nk / TILE)
    kp, vp = (torch.nn.functional.pad(t, (0, 0, 0, ktiles * TILE - nk)) for t in (kf, vf))
    kb = torch.zeros(ktiles * TILE)
    if bias is not None:
        kb[:nk] = bias.float() * LOG2E
    live = torch.arange(ktiles * TILE) < nk
    m = torch.full(q.shape[:3], -math.inf)
    l = torch.zeros(q.shape[:3])
    o = torch.zeros(qf.shape)
    p_prev = v_prev = None
    for kt in reversed(range(ktiles - 1 if drop_last_tile else ktiles)):  # the ragged last tile first
        keys = slice(kt * TILE, (kt + 1) * TILE)
        x = torch.where(live[keys], qf @ kp[:, :, keys].transpose(-1, -2) * (scale * LOG2E) + kb[keys], -math.inf)
        m_new = torch.maximum(m, x.amax(-1))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(x - m_new[..., None])
        l = l * alpha + p.sum(-1)
        if p_prev is not None:
            o = o + p_prev @ v_prev  # the tile before's P V, P in bf16
        if rescale:
            o = o * alpha[..., None]
        m, p_prev, v_prev = m_new, _bf16(p), vp[:, :, keys]
    o = o + p_prev @ v_prev
    return (o / l[..., None]).to(q.dtype), (m + torch.log2(l)) * LN2


def _fwd_operands(d, nq, nk, with_bias, seed):
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.standard_normal((2, 2, nq, d)).astype(np.float32)).bfloat16()
    k, v = (torch.from_numpy(rng.standard_normal((2, 2, nk, d)).astype(np.float32)).bfloat16() for _ in range(2))
    bias = None
    if with_bias:  # a ring block with its last keys padded
        bias = torch.zeros(nk)
        bias[nk - nk // 5:] = NEG_INF
    return q, k, v, bias


def _fwd_within(got, want):
    tol_o, tol_lse = kernel_tolerance(want[0])
    return (float((got[0].float() - want[0].float()).abs().max()) <= tol_o
            and float((got[1] - want[1]).abs().max()) <= tol_lse)


FWD_SHAPES = [(65, 129), (130, 200), (200, 63), (64, 700)]


@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("nq,nk", FWD_SHAPES)
def test_tiled_bf16_forward_is_within_kernel_tolerance(d, with_bias, nq, nk):
    q, k, v, bias = _fwd_operands(d, nq, nk, with_bias, seed=d + nq + nk)
    want = attention_plain(q, k, v, d**-0.5, return_lse=True, bias=bias)
    got = attention_fwd_tiled(q, k, v, d**-0.5, bias)
    tol_o, tol_lse = kernel_tolerance(want[0])
    assert float((got[0].float() - want[0].float()).abs().max()) <= tol_o / 2  # room for the card's order
    assert float((got[1] - want[1]).abs().max()) <= tol_lse / 2


@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("wrong", ["no_rescale", "drop_last_tile"])
def test_a_wrong_forward_order_is_outside_kernel_tolerance(d, wrong):
    """O not scaled by alpha (kernel_mutants.py's `fwd_no_rescale`), or the
    last key tile skipped (`drop_last_key_tile`), over eleven key tiles."""
    q, k, v, _ = _fwd_operands(d, 64, 700, False, seed=d)
    want = attention_plain(q, k, v, d**-0.5, return_lse=True)
    wrong_order = {"rescale": False} if wrong == "no_rescale" else {"drop_last_tile": True}
    assert not _fwd_within(attention_fwd_tiled(q, k, v, d**-0.5, **wrong_order), want)


def attention_bwd_tiled(q, k, v, o, lse, do, scale, bias=None, drop_query_tile=None, drop_key_tile=None):
    """(dq, dk, dv) in the bf16 kernels' order over bf16 q, k, v, o, do
    (B, H, N or Nk, D) and f32 lse (B, H, N); `drop_*_tile` leaves one tile
    out (a wrong order for the tests)."""
    qf, kf, vf, of, dof = (t.float() for t in (q, k, v, o, do))
    n, nk = q.shape[2], k.shape[2]
    nq_pad, nk_pad = TILE * math.ceil(n / TILE), TILE * math.ceil(nk / TILE)
    delta = (dof * of).sum(-1)
    # ragged tails as the kernels see them: zero rows, lse +inf and delta 0
    qp, dop = (torch.nn.functional.pad(t, (0, 0, 0, nq_pad - n)) for t in (qf, dof))
    kp, vp = (torch.nn.functional.pad(t, (0, 0, 0, nk_pad - nk)) for t in (kf, vf))
    lse2 = torch.nn.functional.pad(lse.float() * LOG2E, (0, nq_pad - n), value=math.inf)
    delta = torch.nn.functional.pad(delta, (0, nq_pad - n))
    kb = torch.zeros(nk_pad) if bias is None else torch.nn.functional.pad(bias.float() * LOG2E, (0, nk_pad - nk))
    scale2 = scale * LOG2E
    live_key = torch.arange(nk_pad) < nk

    dk = torch.zeros_like(kp)
    dv = torch.zeros_like(vp)
    for qt in range(nq_pad // TILE):  # the dK/dV kernel's query tiles, in order
        if qt == drop_query_tile:
            continue
        rows = slice(qt * TILE, (qt + 1) * TILE)
        st = kp @ qp[:, :, rows].transpose(-1, -2)    # S^T: keys x queries
        dpt = vp @ dop[:, :, rows].transpose(-1, -2)  # dP^T
        pt = torch.exp2(st * scale2 + kb[:, None] - lse2[:, :, None, rows])
        dst = pt * (dpt - delta[:, :, None, rows])
        dv = dv + _bf16(pt) @ dop[:, :, rows]
        dk = dk + _bf16(dst) @ qp[:, :, rows]

    dq = torch.zeros_like(qp)
    for kt in range(nk_pad // TILE):  # the dQ kernel's key tiles, in order
        if kt == drop_key_tile:
            continue
        keys = slice(kt * TILE, (kt + 1) * TILE)
        s = qp @ kp[:, :, keys].transpose(-1, -2)
        dp = dop @ vp[:, :, keys].transpose(-1, -2)
        p = torch.exp2(s * scale2 + kb[keys] - lse2[..., None])
        p = torch.where(live_key[keys], p, torch.zeros_like(p))
        ds = p * (dp - delta[..., None])
        dq = dq + _bf16(ds) @ kp[:, :, keys]
    return ((dq[:, :, :n] * scale).to(q.dtype), (dk[:, :, :nk] * scale).to(k.dtype), dv[:, :, :nk].to(v.dtype))


def _attention_operands(d, nq, nk, with_bias, seed):
    rng = np.random.default_rng(seed)
    q, do = (torch.from_numpy(rng.standard_normal((2, 2, nq, d)).astype(np.float32)).bfloat16() for _ in range(2))
    k, v = (torch.from_numpy(rng.standard_normal((2, 2, nk, d)).astype(np.float32)).bfloat16() for _ in range(2))
    bias = None
    if with_bias:  # a ring block with its last keys padded
        bias = torch.zeros(nk)
        bias[nk - max(1, nk // 8):] = NEG_INF
        # the merged row's o and lse: this block beside another, all valid
        k2, v2 = k.flip(2), v.flip(2)
        o, lse = attention_plain(q, torch.cat([k2, k], 2), torch.cat([v2, v], 2), d**-0.5, return_lse=True,
                                 bias=torch.cat([torch.zeros(nk), bias]))
    else:
        o, lse = attention_plain(q, k, v, d**-0.5, return_lse=True)
    return q, k, v, o, lse.float(), do, bias


ATTN_SHAPES = [(65, 65), (130, 200), (200, 63)]


def _within(got, want):
    return all(float((g.float() - w.float()).abs().max()) <= bwd_tolerance(w) for g, w in zip(got, want))


@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("nq,nk", ATTN_SHAPES)
def test_tiled_bf16_backward_is_within_bwd_tolerance(d, with_bias, nq, nk):
    q, k, v, o, lse, do, bias = _attention_operands(d, nq, nk, with_bias, seed=d + nq + nk)
    scale = d**-0.5
    want = attention_bwd_plain(q, k, v, o, lse, do, scale, bias)
    got = attention_bwd_tiled(q, k, v, o, lse, do, scale, bias)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        err = float((g.float() - w.float()).abs().max())
        assert err <= bwd_tolerance(w) / 2, (name, err, bwd_tolerance(w))  # room for the card's order


@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("side", ["query_tile", "key_tile"])
def test_a_dropped_tile_is_outside_bwd_tolerance(d, side):
    """The dK/dV kernel skipping its last query tile, or the dQ kernel its
    last key tile (kernel_mutants.py breaks the card's kernel so)."""
    nq, nk = 130, 200
    q, k, v, o, lse, do, _ = _attention_operands(d, nq, nk, False, seed=d)
    want = attention_bwd_plain(q, k, v, o, lse, do, d**-0.5)
    drop = {"drop_query_tile": 2} if side == "query_tile" else {"drop_key_tile": 3}
    got = attention_bwd_tiled(q, k, v, o, lse, do, d**-0.5, **drop)
    assert not _within(got, want)


def test_dropping_the_delta_subtraction_is_outside_bwd_tolerance():
    """dS = P dP without delta (kernel_mutants.py's `bwd_no_delta`): the
    emulation with delta set to 0 by a zero o."""
    q, k, v, o, lse, do, _ = _attention_operands(64, 130, 130, False, seed=3)
    want = attention_bwd_plain(q, k, v, o, lse, do, 0.125)
    got = attention_bwd_tiled(q, k, v, torch.zeros_like(o), lse, do, 0.125)
    assert not _within(got[:2], want[:2])


def dln_staged(dy, w, stage=64, drop_stage=None):
    """dln = dY W over 64-deep stages of F in order, f32 accumulator."""
    f = dy.shape[1]
    acc = torch.zeros((dy.shape[0], w.shape[1]))
    for i, f0 in enumerate(range(0, f, stage)):
        if i != drop_stage:
            acc = acc + dy[:, f0:f0 + stage].float() @ w[f0:f0 + stage].float()
    return acc


def _lnd_operands(r, c, f, seed):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy((2 * rng.standard_normal((r, c)) + 1).astype(np.float32)).bfloat16()
    gamma = torch.from_numpy((1 + 0.1 * rng.standard_normal(c)).astype(np.float32))
    w = torch.from_numpy((c**-0.5 * rng.standard_normal((f, c))).astype(np.float32)).bfloat16()
    dy = torch.from_numpy(rng.standard_normal((r, f)).astype(np.float32)).bfloat16()
    mu, rstd = row_stats_plain(x, 1e-6)
    return x, gamma, w, dy, mu, rstd


@pytest.mark.parametrize("c", [512, 768])
@pytest.mark.parametrize("r,f", [(100, 96), (130, 544)])
def test_staged_dln_and_row_pass_match_plain(c, r, f):
    x, gamma, w, dy, mu, rstd = _lnd_operands(r, c, f, seed=c + r + f)
    want_dx, want_dln = ln_dense_bwd_plain(x, gamma, w, dy, mu, rstd)
    dln = dln_staged(dy, w)
    assert float((dln - want_dln).abs().max()) <= dln_tolerance(want_dln, torch.bfloat16) / 4
    res = compare(layernorm_bwd_plain(x, gamma, mu, rstd, dln), want_dx)
    assert res["ok"], res


@pytest.mark.parametrize("c", [512, 768])
def test_a_dropped_dln_stage_is_outside_dln_tolerance(c):
    x, gamma, w, dy, mu, rstd = _lnd_operands(130, c, 544, seed=c)
    _, want_dln = ln_dense_bwd_plain(x, gamma, w, dy, mu, rstd)
    dln = dln_staged(dy, w, drop_stage=8)  # the last stage: 32 of F's 544
    assert float((dln - want_dln).abs().max()) > dln_tolerance(want_dln, torch.bfloat16)
