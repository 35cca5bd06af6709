"""The CUDA kernels (kernels/csrc/flash_fwd.cu, flash_bwd.cu, layernorm.cu,
ln_dense.cu) against their plain PyTorch versions, on the card. Every test
here needs an NVIDIA GPU and nvcc and skips without them; this file
imports no JAX, so it runs on a GPU machine with

    python -m pytest --noconftest -m cuda tests/test_torch_port_kernels_cuda.py

Tolerances: `kernel_tolerance` (kernels/flash_attention.py): for o, two bf16
spacings at the plain output's largest magnitude in bf16 (both sides round o
to bf16; the kernel also rounds P for the P V product), 1e-5 in f32; for the
f32 lse, 1e-4. `kernel_mutants.py` shows that these catch a bf16 kernel
that drops its last key tile, leaves the ragged key tail unmasked, is off
in its scale by 1%, leaves O unscaled when the running max grows or reads
V's MN-major tile as K-major, and an f32 kernel that drops its last key
tile or the 3xTF32 low terms (plain TF32; tests/test_torch_port_tf32_split.py
shows the same on the CPU). The bf16 forward runs on wgmma with K and V
streamed by TMA; its cases walk more key tiles than its ring has stages,
and two calls must give bitwise equal o and lse.

Backward: `bwd_tolerance` (kernels/flash_attention.py): eight bf16 spacings
at the plain gradient's largest magnitude in bf16 (the kernel rounds P and
dS to bf16 before their products, the plain version keeps them in f32, and
both round the result), 1e-5 relative to the largest magnitude in f32.
`kernel_mutants.py` shows that these catch a bf16 backward whose dK/dV or
dQ ring skips its last stage, that leaves delta out, forgets the scale on
dk, clears dV's transpose flag or does not reset S^T between query tiles.
The bf16 backward runs on wgmma: `wgmma_tile` holds one tile of its
helpers (B MN-major through the transpose flag, A from shared memory or
registers) to `torch.matmul`; two calls must give bitwise equal
gradients (no atomics). The f32 backward at d = 32 and 64 runs 3xTF32 on
tf32 wgmma: every instance (d, key bias on and off, kv_len equal to or
apart from seq_len, up to 17 tiles of 32 rows) against the plain version,
two calls bitwise equal, and one tf32 tile of its helpers (both forms, N
32, 64 and 128) against `torch.matmul` in f64. `kernel_mutants.py` shows
that `bwd_tolerance` catches an f32 backward that drops the low terms in
the dK/dV or the dQ kernel, skips the last query or key stage, carries a
stage's accumulator into the next, writes its transposed copies
unpermuted, or leaves delta out.

The ring's partial kernels (the same sources with a key bias, 0 or -1e30)
and the per-head kernels with fewer or more keys than queries (the
sequence-sharded path's kv_len) are held to the plain versions by the same
tolerances; a fully padded block's lse (about -1e30 on both sides) by 1e-6
relative. `kernel_mutants.py` shows that these catch a forward that drops
the bias from S, a dK/dV kernel that drops it, and a forward that reads
kv_len as seq_len.

LayerNorm (csrc/layernorm.cu) and LayerNorm+Dense (csrc/ln_dense.cu):
`compare` (kernels/fused_ln.py) for y and dx: two bf16 spacings at the
plain output's largest magnitude and at most 2% of elements different at
all in bf16 (both sides round the same f32 values; only summation order
differs), 1e-5 relative in f32; mu and rstd 1e-5 relative (f32 on both
sides); dln `dln_tolerance` (kernels/fused_ln_dense.py): 1e-4 relative for
bf16 operands, 1e-5 for f32. `kernel_mutants.py` shows that these catch a
forward that adds the bias before rounding, drops the last 16-deep step of
each W stage or the store of rstd, a dln product that skips its last stage
of F, clears its transpose flag or carries its sums into the next tile, and
a row pass without the mean(g * xhat) term; and f32 bodies (3xTF32 on
wgmma) that drop the low terms in the forward or in dln, skip the last
32-deep chunk, or do not start each chunk's accumulator afresh. The four #7
edge tests named bf16 take both dtypes."""

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
    ring_partial_bwd,
    ring_partial_fwd,
)
from vit_ae_plus_plus_torch.kernels.flash_attention import flash_attention_fwd, wgmma_tile
from vit_ae_plus_plus_torch.kernels.ring_flash import NEG_INF
from vit_ae_plus_plus_torch.kernels.fused_ln import (
    LN_WIDTHS,
    compare,
    fused_layernorm,
    layernorm_bwd,
    layernorm_bwd_plain,
    layernorm_fwd,
    layernorm_plain,
)
from vit_ae_plus_plus_torch.kernels.fused_ln_dense import (
    dln_tolerance,
    fused_ln_dense,
    ln_dense_bwd,
    ln_dense_bwd_plain,
    ln_dense_fwd,
    ln_dense_plain,
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


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_kernel_rejects_misaligned_operands(cuda, dtype):
    base = torch.zeros(1, 2, 8, 65, dtype=dtype, device=cuda)
    q = base[..., 1:]  # head_dim 64, but rows start off the 16-byte grid
    with pytest.raises(ValueError, match="multiples"):
        flash_attention(q, q, q)


@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("nq,nk", [(1, 1), (64, 129), (130, 64), (200, 333)])
def test_f32_forward_kernel_matches_plain(cuda, d, with_bias, nq, nk):
    """The 3xTF32 forward: one key, whole and ragged key tiles (the cp.async
    ring's last stage), query tiles past the rows, kv_len != seq_len, with
    and without the ring's key bias (a padded tail)."""
    q = _rand((2, 3, nq, d), torch.float32, cuda, 1)
    k, v = (_rand((2, 3, nk, d), torch.float32, cuda, s) for s in (2, 3))
    scale = d**-0.5
    if with_bias:
        bias = torch.zeros(nk, device=cuda)
        bias[nk - nk // 5:] = NEG_INF
        o, lse = ring_partial_fwd(q, k, v, bias, scale)
    else:
        bias = None
        o, lse = flash_attention_fwd(q, k, v, scale)
    torch.cuda.synchronize()
    want_o, want_lse = attention_plain(q, k, v, scale, return_lse=True, bias=bias)
    assert o.dtype == torch.float32 and bool(torch.isfinite(o).all())
    _assert_close(o, lse, want_o, want_lse)


@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("nq,nk", [(1, 1), (64, 64), (65, 129), (200, 63), (333, 200), (130, 1000)])
def test_bf16_fwd_instances_match_plain(cuda, d, with_bias, nq, nk):
    """Every bf16 forward instance (head_dim, key bias on and off): one key,
    whole and ragged key tiles, query blocks past the rows, kv_len != seq_len,
    and at nk = 1000 more key tiles than the ring has stages, so that a
    missing rescale of O or a misturned phase shows; with the bias, the last
    keys of the block are padded."""
    q = _rand((2, 3, nq, d), torch.bfloat16, cuda, nq)
    k, v = (_rand((2, 3, nk, d), torch.bfloat16, cuda, s) for s in (nk + 1, nk + 2))
    scale = d**-0.5
    if with_bias:
        bias = torch.zeros(nk, device=cuda)
        bias[nk - nk // 5:] = NEG_INF
        o, lse = ring_partial_fwd(q, k, v, bias, scale)
    else:
        bias = None
        o, lse = flash_attention_fwd(q, k, v, scale)
    torch.cuda.synchronize()
    want_o, want_lse = attention_plain(q, k, v, scale, return_lse=True, bias=bias)
    assert o.dtype == torch.bfloat16 and bool(torch.isfinite(o).all())
    _assert_close(o, lse, want_o, want_lse)


@pytest.mark.parametrize("layout", ["packed", "per_head", "ring"])
def test_bf16_fwd_is_bitwise_repeatable(cuda, layout):
    """Each row's sums have one owner and a fixed order: two calls on the
    same inputs give bitwise equal o and lse."""
    d, n = 64, 300
    if layout == "packed":
        qkv = _rand((2, n, 3 * 128), torch.bfloat16, cuda, seed=13)
        call = lambda: packed_flash_attention(qkv, d, return_lse=True)  # noqa: E731
    else:
        q, k, v = (_rand((2, 3, n, d), torch.bfloat16, cuda, s) for s in range(30, 33))
        if layout == "per_head":
            call = lambda: flash_attention_fwd(q, k, v, d**-0.5)  # noqa: E731
        else:
            bias = torch.zeros(n, device=cuda)
            bias[n - 9:] = NEG_INF
            call = lambda: ring_partial_fwd(q, k, v, bias, d**-0.5)  # noqa: E731
    first = [t.clone() for t in call()]
    second = call()
    torch.cuda.synchronize()
    for name, a, b in zip(("o", "lse"), first, second):
        assert torch.equal(a, b), name


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


def _row_stats(q, k, v, bias, scale):
    """o and lse of each query row over the block (k, v, bias) and a valid
    block beside it: what the ring's merge hands each backward step."""
    k2, v2 = (t.flip(2) for t in (k, v))  # another block of keys, all valid
    both = torch.cat([torch.zeros_like(bias), bias])
    return attention_plain(q, torch.cat([k2, k], 2), torch.cat([v2, v], 2), scale, return_lse=True, bias=both)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("nq,nk,pad", [(65, 65, 7), (130, 130, 130), (40, 200, 31), (200, 63, 1)])
def test_ring_partial_kernels_match_plain(cuda, dtype, d, nq, nk, pad):
    """One ring step, forward and backward, with the last `pad` keys of the
    block padded (all of them at 130): partial, full, and fewer or more
    queries than keys."""
    q, do = (_rand((2, 3, nq, d), dtype, cuda, s) for s in range(2))
    k, v = (_rand((2, 3, nk, d), dtype, cuda, s) for s in range(2, 4))
    bias = torch.zeros(nk, device=cuda)
    bias[nk - pad:] = NEG_INF
    scale = d**-0.5
    before = ring_partial_fwd.launches, ring_partial_bwd.launches
    o, lse = ring_partial_fwd(q, k, v, bias, scale)
    o_row, lse_row = _row_stats(q, k, v, bias, scale)
    got = ring_partial_bwd(q, do, o_row.to(dtype), lse_row.float(), k, v, bias, scale)
    torch.cuda.synchronize()
    assert (ring_partial_fwd.launches, ring_partial_bwd.launches) == (before[0] + 1, before[1] + 1)
    want_o, want_lse = attention_plain(q, k, v, scale, return_lse=True, bias=bias)
    tol_o, tol_lse = kernel_tolerance(want_o)
    torch.testing.assert_close(o.float(), want_o.float(), rtol=0, atol=tol_o)
    torch.testing.assert_close(lse, want_lse, rtol=1e-6, atol=tol_lse)
    _assert_grads_close(got, attention_bwd_plain(q, k, v, o_row.to(dtype), lse_row.float(), do, scale, bias))
    if pad == nk:  # a block of pad keys: lse about -1e30, no gradient to its keys
        assert float(lse.max()) < -1e29
        assert float(got[1].abs().max()) == 0.0 and float(got[2].abs().max()) == 0.0


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("nq,nk", [(40, 200), (200, 63), (1, 65)])
def test_per_head_kernels_with_another_key_length_match_plain(cuda, dtype, d, nq, nk):
    """The sequence-sharded path's shard of query rows against all keys."""
    q, do = (_rand((2, 3, nq, d), dtype, cuda, s) for s in range(2))
    k, v = (_rand((2, 3, nk, d), dtype, cuda, s) for s in range(2, 4))
    o, lse = flash_attention_fwd(q, k, v, d**-0.5)
    want_o, want_lse = attention_plain(q, k, v, d**-0.5, return_lse=True)
    _assert_close(o, lse, want_o, want_lse)
    got = flash_attention_bwd(q, k, v, o, lse, do, d**-0.5)
    assert got[0].shape == q.shape and got[1].shape == k.shape
    _assert_grads_close(got, attention_bwd_plain(q, k, v, o, lse, do, d**-0.5))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_a_zero_bias_gives_the_bias_free_kernels_results(cuda, dtype):
    """The biased instances add 0 where the bias-free ones (the packed and
    per-head paths') add nothing. The forward's results are bitwise equal;
    in the backward the bias-free kernels fuse `s * scale2 - lse` into one
    FMA where the biased ones round `s * scale2 + bias` first, so the
    gradients agree within the backward's tolerance."""
    q, k, v, do = (_rand((2, 3, 100, 64), dtype, cuda, s) for s in range(4))
    zero = torch.zeros(100, device=cuda)
    o, lse = flash_attention_fwd(q, k, v, 0.125)
    o_b, lse_b = ring_partial_fwd(q, k, v, zero, 0.125)
    assert torch.equal(o, o_b) and torch.equal(lse, lse_b)
    _assert_grads_close(ring_partial_bwd(q, do, o, lse, k, v, zero, 0.125),
                        flash_attention_bwd(q, k, v, o, lse, do, 0.125))


@pytest.mark.parametrize("n", [32, 64, 128])
@pytest.mark.parametrize("a_from_registers", [False, True], ids=["a_smem", "a_regs"])
def test_wgmma_transposed_b_tile_matches_matmul(cuda, n, a_from_registers):
    """One tile of the helpers under the bf16 backward: b (64, N) row-major
    is loaded by TMA and read MN-major through wgmma's transpose flag, a
    from shared memory or from registers. bf16 products are exact in f32,
    so only the order of the 64-term sums differs from torch.matmul."""
    a = _rand((64, 64), torch.bfloat16, cuda, seed=n)
    b = _rand((64, n), torch.bfloat16, cuda, seed=n + 1)
    got = wgmma_tile(a, b, a_from_registers)
    torch.cuda.synchronize()
    want = torch.matmul(a.float(), b.float())
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5 * want.abs().max().item())


@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("nq,nk", [(1, 1), (64, 64), (65, 129), (200, 63), (333, 200)])
def test_bf16_bwd_instances_match_plain(cuda, d, with_bias, nq, nk):
    """Every bf16 backward instance (head_dim, key bias on and off) at
    ragged lengths, with kv_len equal to and different from seq_len; with
    the bias, the last keys of the block are padded."""
    q, do = (_rand((2, 3, nq, d), torch.bfloat16, cuda, s) for s in (nq, nq + 1))
    k, v = (_rand((2, 3, nk, d), torch.bfloat16, cuda, s) for s in (nk + 2, nk + 3))
    scale = d**-0.5
    bias = None
    if with_bias:
        bias = torch.zeros(nk, device=cuda)
        bias[nk - max(1, nk // 8):] = NEG_INF
        o, lse = _row_stats(q, k, v, bias, scale)  # the merged row's o and lse, as the ring hands them over
        o = o.to(torch.bfloat16)
        got = ring_partial_bwd(q, do, o, lse.float(), k, v, bias, scale)
    else:
        o, lse = flash_attention_fwd(q, k, v, scale)
        got = flash_attention_bwd(q, k, v, o, lse, do, scale)
    torch.cuda.synchronize()
    _assert_grads_close(got, attention_bwd_plain(q, k, v, o, lse.float(), do, scale, bias))


@pytest.mark.parametrize("layout", ["packed", "per_head", "ring"])
def test_bf16_bwd_is_bitwise_repeatable(cuda, layout):
    """No atomics: two calls on the same inputs give bitwise equal dq, dk
    and dv (the sequence-parallel step keeps its ranks' parameters bitwise
    equal only so)."""
    d, n = 64, 300
    if layout == "packed":
        qkv = _rand((2, n, 3 * 128), torch.bfloat16, cuda, seed=11)
        do = _rand((2, n, 128), torch.bfloat16, cuda, seed=12)
        o, lse = packed_flash_attention(qkv, d, return_lse=True)
        call = lambda: packed_flash_attention_bwd(qkv, o, lse, do, d, d**-0.5).chunk(3, dim=-1)  # noqa: E731
    else:
        q, k, v, do = (_rand((2, 3, n, d), torch.bfloat16, cuda, s) for s in range(20, 24))
        if layout == "per_head":
            o, lse = flash_attention_fwd(q, k, v, d**-0.5)
            call = lambda: flash_attention_bwd(q, k, v, o, lse, do, d**-0.5)  # noqa: E731
        else:
            bias = torch.zeros(n, device=cuda)
            bias[n - 9:] = NEG_INF
            o, lse = ring_partial_fwd(q, k, v, bias, d**-0.5)
            call = lambda: ring_partial_bwd(q, do, o, lse, k, v, bias, d**-0.5)  # noqa: E731
    first = [g.clone() for g in call()]
    second = call()
    torch.cuda.synchronize()
    for name, a, b in zip(("dq", "dk", "dv"), first, second):
        assert torch.equal(a, b), name


def _ln_operands(r, c, dtype, device, seed, f=None):
    """x (mean 1, spread 2), gamma near 1, beta, and with `f` w (F, C),
    b (F,) in x's dtype and dy (R, F); else dy (R, C)."""
    x = (2 * _rand((r, c), torch.float32, device, seed) + 1).to(dtype)
    gamma = 1 + 0.1 * _rand((c,), torch.float32, device, seed + 1)
    beta = 0.1 * _rand((c,), torch.float32, device, seed + 2)
    if f is None:
        return x, gamma, beta, _rand((r, c), dtype, device, seed + 3)
    w = (c**-0.5 * _rand((f, c), torch.float32, device, seed + 4)).to(dtype)
    b = (0.1 * _rand((f,), torch.float32, device, seed + 5)).to(dtype)
    return x, gamma, beta, w, b, _rand((r, f), dtype, device, seed + 6)


def _assert_compare(got, want, what):
    c = compare(got, want)
    assert c["ok"], (what, c)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("c", LN_WIDTHS)
@pytest.mark.parametrize("r", [1, 100])
def test_layernorm_kernels_match_plain(cuda, dtype, c, r):
    x, gamma, beta, dy = _ln_operands(r, c, dtype, cuda, seed=c + r)
    before = fused_layernorm.launches, layernorm_bwd.launches
    y, mu, rstd = layernorm_fwd(x, gamma, beta, 1e-6)
    dx = layernorm_bwd(x, gamma, mu, rstd, dy)
    torch.cuda.synchronize()
    assert (fused_layernorm.launches, layernorm_bwd.launches) == (before[0] + 1, before[1] + 1)
    want_y, want_mu, want_rstd = layernorm_plain(x, gamma, beta, 1e-6)
    _assert_compare(y, want_y, "y")
    _assert_compare(mu, want_mu, "mu")
    _assert_compare(rstd, want_rstd, "rstd")
    _assert_compare(dx, layernorm_bwd_plain(x, gamma, want_mu, want_rstd, dy), "dx")


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("r,c,f", [(100, 256, 192), (1, 512, 64), (130, 768, 320), (65, 1024, 96)])
def test_ln_dense_kernels_match_plain(cuda, dtype, r, c, f):
    """Ragged rows (and a ragged last tile of output columns at F = 192,
    320 and 96) in both directions."""
    x, gamma, beta, w, b, dy = _ln_operands(r, c, dtype, cuda, seed=f, f=f)
    before = fused_ln_dense.launches, ln_dense_bwd.launches
    y, mu, rstd = ln_dense_fwd(x, gamma, beta, w, b, 1e-6)
    dx, dln = ln_dense_bwd(x, gamma, w, dy, mu, rstd)
    torch.cuda.synchronize()
    assert (fused_ln_dense.launches, ln_dense_bwd.launches) == (before[0] + 1, before[1] + 1)
    want_y, want_mu, want_rstd = ln_dense_plain(x, gamma, beta, w, b, 1e-6)
    _assert_compare(y, want_y, "y")
    _assert_compare(mu, want_mu, "mu")
    _assert_compare(rstd, want_rstd, "rstd")
    want_dx, want_dln = ln_dense_bwd_plain(x, gamma, w, dy, want_mu, want_rstd)
    assert dln.dtype == torch.float32 and dx.dtype == dtype
    torch.testing.assert_close(dln, want_dln, rtol=0, atol=dln_tolerance(want_dln, dtype))
    _assert_compare(dx, want_dx, "dx")


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("c", LN_WIDTHS)
@pytest.mark.parametrize("r,f", [(65, 32), (129, 416), (257, 96), (300, 1056)])
def test_ln_dense_bf16_forward_edges(cuda, dtype, c, r, f):
    """The wgmma forwards at every width. bf16: rows past a slab of 128 (64
    at C = 1024), F a multiple of 32 but not of the 128-column tile, F under
    one tile, and slabs whose F is split into several runs (a few slabs
    leave most SMs free, so each run takes one or two tiles); mu and rstd
    come from each slab's first run. f32 (3xTF32): rows past a 128-row tile,
    the ragged last column tile, and W's split pre-pass at every shape."""
    x, gamma, beta, w, b, _ = _ln_operands(r, c, dtype, cuda, seed=r + c + f, f=f)
    y, mu, rstd = ln_dense_fwd(x, gamma, beta, w, b, 1e-6)
    torch.cuda.synchronize()
    want_y, want_mu, want_rstd = ln_dense_plain(x, gamma, beta, w, b, 1e-6)
    assert y.shape == (r, f) and bool(torch.isfinite(y).all())
    _assert_compare(y, want_y, "y")
    _assert_compare(mu, want_mu, "mu")
    _assert_compare(rstd, want_rstd, "rstd")


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("c", LN_WIDTHS)
@pytest.mark.parametrize("r,f", [(1, 32), (129, 96), (257, 416), (300, 1056)])
def test_ln_dense_bf16_backward_edges(cuda, dtype, c, r, f):
    """The wgmma dln products at every width: rows past a 128-row tile, F a
    multiple of 32 but not of the bf16 body's 64-deep stage, F under one
    stage (the f32 body's one 32-deep chunk at F = 32), and more tiles than
    SMs hold blocks (so that a block walks several)."""
    x, gamma, beta, w, b, dy = _ln_operands(r, c, dtype, cuda, seed=r + c + f + 1, f=f)
    _, mu, rstd = ln_dense_fwd(x, gamma, beta, w, b, 1e-6)
    dx, dln = ln_dense_bwd(x, gamma, w, dy, mu, rstd)
    torch.cuda.synchronize()
    want_dx, want_dln = ln_dense_bwd_plain(x, gamma, w, dy, mu, rstd)
    assert dln.shape == (r, c) and bool(torch.isfinite(dln).all())
    torch.testing.assert_close(dln, want_dln, rtol=0, atol=dln_tolerance(want_dln, dtype))
    _assert_compare(dx, want_dx, "dx")


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_ln_dense_bf16_backward_walks_many_tiles(cuda, dtype):
    """At R = 20,000 and C = 1024 there are 1,256 tiles for 132 SMs: each
    persistent block walks about ten, its ring running on across them."""
    x, gamma, beta, w, b, dy = _ln_operands(20_000, 1024, dtype, cuda, seed=77, f=96)
    _, mu, rstd = ln_dense_fwd(x, gamma, beta, w, b, 1e-6)
    dx, dln = ln_dense_bwd(x, gamma, w, dy, mu, rstd)
    torch.cuda.synchronize()
    want_dx, want_dln = ln_dense_bwd_plain(x, gamma, w, dy, mu, rstd)
    torch.testing.assert_close(dln, want_dln, rtol=0, atol=dln_tolerance(want_dln, dtype))
    _assert_compare(dx, want_dx, "dx")


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_ln_dense_bf16_backward_is_bitwise_repeatable(cuda, dtype):
    """No atomics in #7b either: two calls give bitwise equal dln and dx."""
    x, gamma, beta, w, b, dy = _ln_operands(1000, 768, dtype, cuda, seed=5, f=2304)
    _, mu, rstd = ln_dense_fwd(x, gamma, beta, w, b, 1e-6)
    first = [t.clone() for t in ln_dense_bwd(x, gamma, w, dy, mu, rstd)]
    second = ln_dense_bwd(x, gamma, w, dy, mu, rstd)
    torch.cuda.synchronize()
    assert torch.equal(first[0], second[0]) and torch.equal(first[1], second[1])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_autograd_goes_through_the_ln_kernels(cuda, dtype):
    """backward() through `fused_ln_dense` launches the backward kernels
    (#7b) once, and through `fused_layernorm` #6b once; the f32 parameters
    get f32 gradients, those of the CPU run of the same op."""
    r, c, f = 97, 256, 192
    x, gamma, beta, w, b, dy = _ln_operands(r, c, dtype, cuda, seed=9, f=f)
    params = [t.float().requires_grad_() for t in (gamma, beta, w, b)]
    xg = x.clone().requires_grad_()
    key = (r, c, f, str(dtype).removeprefix("torch."))
    fwd0, bwd0 = (fn.launches_by_shape.get(key, 0) for fn in (fused_ln_dense, ln_dense_bwd))
    (fused_ln_dense(xg, *params).float() * dy.float()).sum().backward()
    torch.cuda.synchronize()
    assert (fused_ln_dense.launches_by_shape[key] - fwd0, ln_dense_bwd.launches_by_shape[key] - bwd0) == (1, 1)
    xc = x.cpu().requires_grad_()
    cpu_params = [p.detach().cpu().requires_grad_() for p in params]
    (fused_ln_dense(xc, *cpu_params).float() * dy.cpu().float()).sum().backward()
    _assert_compare(xg.grad.cpu(), xc.grad, "dx")
    for name, p, q in zip(("gamma", "beta", "w", "b"), params, cpu_params):
        assert p.grad.dtype == torch.float32, name
        top = q.grad.abs().max().item()
        torch.testing.assert_close(p.grad.cpu(), q.grad, rtol=0, atol=1e-4 * max(top, 1.0), msg=name)
    xl = x.clone().requires_grad_()
    before = layernorm_bwd.launches
    (fused_layernorm(xl, params[0], params[1]).float() * x.float()).sum().backward()
    torch.cuda.synchronize()
    assert layernorm_bwd.launches == before + 1 and bool(torch.isfinite(xl.grad).all())


def test_ln_kernels_raise_where_no_instance_is_built(cuda):
    """On the card a width, a dtype or an F that no kernel instance takes
    raises: nothing falls back to the plain version."""
    for c in (12, 32, 384):
        x, gamma, beta, w, b, _ = _ln_operands(8, c, torch.bfloat16, cuda, seed=c, f=64)
        with pytest.raises(ValueError, match="width"):
            fused_layernorm(x, gamma, beta)
        with pytest.raises(ValueError, match="width"):
            fused_ln_dense(x, gamma, beta, w.float(), b.float())
    x, gamma, beta, w, b, _ = _ln_operands(8, 256, torch.bfloat16, cuda, seed=1, f=64)
    with pytest.raises(ValueError, match="dtype"):
        fused_layernorm(x.double(), gamma, beta)
    with pytest.raises(ValueError, match="multiple of 32"):
        fused_ln_dense(x, gamma, beta, w[:48].float(), b[:48].float())


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """The nearest tf32 value (cvt.rna.tf32.f32), as an f32 tensor."""
    return ((x.contiguous().view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


@pytest.mark.parametrize("n", [32, 64, 128])
@pytest.mark.parametrize("a_from_registers", [False, True], ids=["a_smem", "a_regs"])
def test_wgmma_tf32_tile_matches_matmul(cuda, n, a_from_registers):
    """One tile of the tf32 helpers under the f32 backward: a (64, 32) and
    b^T (N, 32) loaded by TMA, both K-major, a from shared memory or from
    registers. The operands are tf32 values, so each product is exact; the
    tensor cores' truncating f32 sum of 32 terms is off by at most 32 units
    of 2^-23 of the sum of |a b|."""
    a = _tf32(_rand((64, 32), torch.float32, cuda, seed=n))
    b = _tf32(_rand((32, n), torch.float32, cuda, seed=n + 1))
    got = wgmma_tile(a, b, a_from_registers)
    torch.cuda.synchronize()
    want = a.double() @ b.double()
    bound = 2.0**-18 * (a.abs().double() @ b.abs().double()).max().item()
    torch.testing.assert_close(got.double(), want, rtol=0, atol=bound)


@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("nq,nk", [(1, 1), (32, 32), (33, 65), (64, 129), (200, 63), (333, 200), (540, 47),
                                   (47, 540)])
def test_f32_bwd_instances_match_plain(cuda, d, with_bias, nq, nk):
    """Every f32 backward instance (head_dim, key bias on and off) at ragged
    lengths, with kv_len equal to and different from seq_len, up to 17
    streamed tiles of 32 rows; with the bias, the last keys of the block are
    padded and o and lse are the merged row's, as the ring hands them over."""
    q, do = (_rand((2, 3, nq, d), torch.float32, cuda, s) for s in (nq, nq + 1))
    k, v = (_rand((2, 3, nk, d), torch.float32, cuda, s) for s in (nk + 2, nk + 3))
    scale = d**-0.5
    bias = None
    if with_bias:
        bias = torch.zeros(nk, device=cuda)
        bias[nk - max(1, nk // 8):] = NEG_INF
        o, lse = _row_stats(q, k, v, bias, scale)
        got = ring_partial_bwd(q, do, o, lse, k, v, bias, scale)
    else:
        o, lse = flash_attention_fwd(q, k, v, scale)
        got = flash_attention_bwd(q, k, v, o, lse, do, scale)
    torch.cuda.synchronize()
    _assert_grads_close(got, attention_bwd_plain(q, k, v, o, lse, do, scale, bias))


@pytest.mark.parametrize("layout", ["packed", "per_head", "ring"])
@pytest.mark.parametrize("d", [32, 64])
def test_f32_bwd_is_bitwise_repeatable(cuda, layout, d):
    """The f32 wgmma backward has no atomics either: two calls on the same
    inputs give bitwise equal dq, dk and dv."""
    n = 300
    if layout == "packed":
        qkv = _rand((2, n, 3 * 128), torch.float32, cuda, seed=31)
        do = _rand((2, n, 128), torch.float32, cuda, seed=32)
        o, lse = packed_flash_attention(qkv, d, return_lse=True)
        call = lambda: packed_flash_attention_bwd(qkv, o, lse, do, d, d**-0.5).chunk(3, dim=-1)  # noqa: E731
    else:
        q, k, v, do = (_rand((2, 3, n, d), torch.float32, cuda, s) for s in range(40, 44))
        if layout == "per_head":
            o, lse = flash_attention_fwd(q, k, v, d**-0.5)
            call = lambda: flash_attention_bwd(q, k, v, o, lse, do, d**-0.5)  # noqa: E731
        else:
            bias = torch.zeros(n, device=cuda)
            bias[n - 9:] = NEG_INF
            o, lse = ring_partial_fwd(q, k, v, bias, d**-0.5)
            call = lambda: ring_partial_bwd(q, do, o, lse, k, v, bias, d**-0.5)  # noqa: E731
    first = [g.clone() for g in call()]
    second = call()
    torch.cuda.synchronize()
    for name, a, b in zip(("dq", "dk", "dv"), first, second):
        assert torch.equal(a, b), name
