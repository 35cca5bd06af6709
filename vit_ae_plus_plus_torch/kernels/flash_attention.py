"""Multi-head attention: plain versions, the per-head kernels and the dispatch.

Counterpart of the JAX package's kernels/flash_attention.py
(`multihead_attention`) and kernels/pallas_flash.py (`flash_attention`, a
`jax.custom_vjp` over the forward and backward TPU kernels).

- `attention_plain` / `attention_bwd_plain`: eager PyTorch over (B, H, N, D).
  Products and softmax run in at least f32 (f64 stays f64) and results are
  cast back to the input dtype: the arithmetic of the TPU kernels, which
  upcast q, k and v to f32. They are the CPU path and the reference the CUDA
  kernels are held to on the card. Both take an optional additive f32 bias
  over the keys (the ring's validity bias, kernels/ring_flash.py) and k, v
  with another length than q (the sequence-sharded path,
  kernels/seq_flash.py).
- `flash_attention`: differentiable per-head attention, a
  `torch.autograd.Function` whose forward is `csrc/flash_fwd.cu` and whose
  backward is `csrc/flash_bwd.cu` (`flash_attention_bwd`). On CPU tensors
  both take the plain versions; on CUDA tensors they launch the kernels or
  raise. Gradients reach q, k and v on either device.
- `multihead_attention`: the per-head dispatch behind `attn_impl`
  ('plain', 'flash', 'flash_local', and the sequence-parallel 'flash_ring'
  and 'flash_seq' under `parallel.set_mesh`); the model's 'auto' is
  resolved in models/vit.py.
- `kernel_tolerance` / `bwd_tolerance`: how far the kernels may lie from the
  plain versions.

The kernels read operands through (batch, token, head) strides, so the
launchers take (B, N, H, D) views: a per-head tensor is passed transposed,
the packed (B, N, 3C) projection as three views of itself. Both dtypes run
on the tensor cores: the bf16 forward and backward through Hopper's wgmma
with their operands streamed by TMA (`wgmma_tile` checks one tile of those
helpers), f32 through 3xTF32 (each f32 operand split into two TF32 parts,
f32-accurate products): the forward on mma.sync, the backward on tf32 wgmma
at head dims 32 and 64, after a pre-pass that writes the split copies into
scratch this module allocates at the size csrc/flash_bwd.cu asks for.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from vit_ae_plus_plus_torch.kernels import _build

HEAD_DIMS = (32, 64, 128)  # the kernels' template instances
DTYPES = (torch.float32, torch.bfloat16)
# the plain versions also take float64 (the CPU trajectory tests run in f64)
CPU_DTYPES = DTYPES + (torch.float64,)


def check_dtype(dtype: torch.dtype, device: torch.device) -> None:
    allowed = CPU_DTYPES if device.type == "cpu" else DTYPES
    if dtype not in allowed:
        raise ValueError(f"dtype {dtype} not in {allowed} on {device.type}")


def _at_least_f32(dtype: torch.dtype) -> torch.dtype:
    return torch.promote_types(dtype, torch.float32)


def _scores(q, k, scale: float, bias, dt):
    s = torch.matmul(q.to(dt), k.to(dt).transpose(-1, -2)) * scale
    return s if bias is None else s + bias.to(dt)


def attention_plain(q, k, v, scale: float, return_lse: bool = False, bias=None):
    """softmax(q k^T * scale + bias) v over q (B, H, N, D) and k, v
    (B, H, Nk, D); at least f32 inside, q's dtype out. `bias`, if given, is
    (Nk,) and added to every row of scores. With `return_lse`, also the
    log-sum-exp of the biased scores, (B, H, N), in the inner dtype (f32
    for bf16 and f32 inputs)."""
    dt = _at_least_f32(q.dtype)
    s = _scores(q, k, scale, bias, dt)
    o = torch.matmul(torch.softmax(s, dim=-1), v.to(dt)).to(q.dtype)
    if return_lse:
        return o, torch.logsumexp(s, dim=-1)
    return o


def attention_bwd_plain(q, k, v, o, lse, do, scale: float, bias=None):
    """Gradients (dq, dk, dv) of `attention_plain` over q (B, H, N, D) and
    k, v (B, H, Nk, D), from the output `o` and log-sum-exp `lse` of the
    softmax over each whole row (a ring step's block is a part of the row):
    the formulas of the backward kernels, eagerly, in at least f32, each
    result in its input's dtype.

    P = exp(q k^T * scale + bias - lse), dV = P^T dO, dP = dO V^T,
    delta = rowsum(dO * O), dS = P * (dP - delta), dQ = scale * dS K,
    dK = scale * dS^T Q."""
    dt = _at_least_f32(q.dtype)
    qf, kf, vf, of, dof = (t.to(dt) for t in (q, k, v, o, do))
    p = torch.exp(_scores(qf, kf, scale, bias, dt) - lse.to(dt)[..., None])
    dv = torch.matmul(p.transpose(-1, -2), dof)
    dp = torch.matmul(dof, vf.transpose(-1, -2))
    delta = (dof * of).sum(dim=-1, keepdim=True)
    ds = p * (dp - delta)
    dq = torch.matmul(ds, kf) * scale
    dk = torch.matmul(ds.transpose(-1, -2), qf) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _vec(t: torch.Tensor) -> int:
    """Elements in one 16-byte vector load: 8 bf16, 4 f32."""
    return 16 // t.element_size()


def _strides_ok(t: torch.Tensor) -> bool:
    """The kernels' operand contract: a contiguous head_dim axis and 16-byte
    aligned rows (the forward kernels load 16 bytes at a time: 8 bf16 or,
    through cp.async, 4 f32)."""
    vec = _vec(t)
    return (
        t.stride(-1) == 1
        and not any(s % vec for s in t.stride()[:-1])
        and t.data_ptr() % (vec * t.element_size()) == 0
    )


def _check_views(q, views) -> None:
    vec = _vec(q)
    for name, t in views:
        if t.stride(-1) != 1:
            raise ValueError(f"{name}: the head_dim axis must be contiguous")
        if not _strides_ok(t):
            raise ValueError(
                f"{name}: strides {t.stride()} and address must be multiples "
                f"of {vec} elements for the {q.dtype} kernel"
            )


class FlashFwdParams(ctypes.Structure):
    """Mirror of `struct FlashFwdParams` in csrc/flash_fwd.cu."""

    _fields_ = [
        ("q", ctypes.c_void_p), ("k", ctypes.c_void_p), ("v", ctypes.c_void_p),
        ("o", ctypes.c_void_p), ("lse", ctypes.c_void_p), ("key_bias", ctypes.c_void_p),
        *[(f"{t}_s{a}", ctypes.c_longlong) for t in "qkvo" for a in "bnh"],
        ("batch", ctypes.c_int), ("heads", ctypes.c_int),
        ("seq_len", ctypes.c_int), ("kv_len", ctypes.c_int), ("head_dim", ctypes.c_int),
        ("scale", ctypes.c_float),
    ]


_BWD_TENSORS = ("q", "k", "v", "o", "do", "dq", "dk", "dv")


class FlashBwdParams(ctypes.Structure):
    """Mirror of `struct FlashBwdParams` in csrc/flash_bwd.cu."""

    _fields_ = [
        *[(name, ctypes.c_void_p) for name in _BWD_TENSORS],
        ("lse", ctypes.c_void_p), ("delta", ctypes.c_void_p), ("split", ctypes.c_void_p),
        ("key_bias", ctypes.c_void_p),
        *[(f"{t}_s{a}", ctypes.c_longlong) for t in _BWD_TENSORS for a in "bnh"],
        ("batch", ctypes.c_int), ("heads", ctypes.c_int),
        ("seq_len", ctypes.c_int), ("kv_len", ctypes.c_int), ("head_dim", ctypes.c_int),
        ("scale", ctypes.c_float),
    ]


def _check_lse(lse, b, h, n, device) -> None:
    if (
        lse.shape != (b, h, n) or lse.dtype != torch.float32
        or not lse.is_contiguous() or lse.device != device
    ):
        raise ValueError("lse must be a contiguous (B, H, N) float32 tensor on q's device")


def _check_bias(bias, nk, device) -> None:
    if bias is not None and (
        bias.shape != (nk,) or bias.dtype != torch.float32
        or not bias.is_contiguous() or bias.device != device
    ):
        raise ValueError("bias must be a contiguous (Nk,) float32 tensor on q's device")


def launch_flash_fwd(q, k, v, o, lse: Optional[torch.Tensor], scale: float,
                     key_bias: Optional[torch.Tensor] = None) -> None:
    """Run csrc/flash_fwd.cu on (B, N, H, D) views of CUDA tensors of one
    dtype: q and o of N rows, k and v of Nk rows (the wrappers check shapes
    and dtypes).

    `o` is written in place; `lse`, if given, is a contiguous (B, H, N) f32
    tensor; `key_bias`, if given, a contiguous (Nk,) f32 tensor added to
    every row of scores. Launches on the current stream and does not
    synchronise."""
    b, n, h, d = q.shape
    nk = k.shape[1]
    _check_views(q, (("q", q), ("k", k), ("v", v), ("o", o)))
    if lse is not None:
        _check_lse(lse, b, h, n, q.device)
    _check_bias(key_bias, nk, q.device)
    params = FlashFwdParams(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr() if lse is not None else None,
        key_bias.data_ptr() if key_bias is not None else None,
        *[t.stride(i) for t in (q, k, v, o) for i in (0, 1, 2)],
        b, h, n, nk, d, float(scale),
    )
    _build.launch("flash_fwd", "flash_fwd", params, q)


def launch_flash_bwd(q, k, v, o, lse, do, dq, dk, dv, scale: float,
                     key_bias: Optional[torch.Tensor] = None) -> None:
    """Run csrc/flash_bwd.cu on (B, N, H, D) views of CUDA tensors of one
    dtype: dq, dk and dv are written in place from q, k, v, the forward's o
    and f32 lse (B, H, N), and the output gradient do; q, o, do and dq have
    N rows, k, v, dk and dv Nk rows. `key_bias` as in `launch_flash_fwd`.
    Launches on the current stream and does not synchronise."""
    b, n, h, d = q.shape
    nk = k.shape[1]
    tensors = (q, k, v, o, do, dq, dk, dv)
    _check_views(q, zip(_BWD_TENSORS, tensors))
    _check_lse(lse, b, h, n, q.device)
    _check_bias(key_bias, nk, q.device)
    delta = torch.empty((b, h, n), dtype=torch.float32, device=q.device)
    params = FlashBwdParams(
        *[t.data_ptr() for t in tensors], lse.data_ptr(), delta.data_ptr(), None,
        key_bias.data_ptr() if key_bias is not None else None,
        *[t.stride(i) for t in tensors for i in (0, 1, 2)],
        b, h, n, nk, d, float(scale),
    )
    # the f32 bodies' tf32 copies of the operands (csrc/flash_bwd.cu sizes them)
    split_floats = _build.load("flash_bwd").flash_bwd_split_floats
    split_floats.argtypes = [ctypes.POINTER(FlashBwdParams), ctypes.c_int]
    split_floats.restype = ctypes.c_longlong
    floats = split_floats(ctypes.byref(params), int(q.dtype == torch.bfloat16))
    split = torch.empty(floats, dtype=torch.float32, device=q.device) if floats else None
    params.split = split.data_ptr() if split is not None else None
    _build.launch("flash_bwd", "flash_bwd", params, q)


class WgmmaProbeParams(ctypes.Structure):
    """Mirror of `struct WgmmaProbeParams` in csrc/flash_bwd.cu."""

    _fields_ = [("a", ctypes.c_void_p), ("b", ctypes.c_void_p), ("d", ctypes.c_void_p),
                ("n", ctypes.c_int), ("a_from_registers", ctypes.c_int)]


def wgmma_tile(a: torch.Tensor, b: torch.Tensor, a_from_registers: bool) -> torch.Tensor:
    """a @ b in f32 through one tile of the Hopper helpers that the wgmma
    bodies build on (csrc/flash_bwd.cu `wgmma_probe`), a from shared memory
    or from registers. bf16: a (64, 64), b (64, N) loaded by TMA and read
    MN-major through wgmma's transpose flag. f32: a (64, 32), b (32, N), one
    tf32 product (tf32 operands are K-major only: b goes in transposed).
    CUDA tensors of one dtype, N in (32, 64, 128). A check of those helpers,
    on no path of the model."""
    n = b.shape[1]
    depth = 64 if a.dtype == torch.bfloat16 else 32
    if (a.shape != (64, depth) or b.shape != (depth, n) or n not in HEAD_DIMS or a.dtype not in DTYPES
            or b.dtype != a.dtype or not a.is_cuda or not b.is_cuda):
        raise ValueError("wgmma_tile takes CUDA tensors a (64, 64) and b (64, N) in bf16, or a (64, 32) and "
                         "b (32, N) in f32, N in (32, 64, 128)")
    a, b = a.contiguous(), (b if a.dtype == torch.bfloat16 else b.t()).contiguous()
    d = torch.empty((64, n), dtype=torch.float32, device=a.device)
    _build.launch("flash_bwd", "wgmma_probe",
                  WgmmaProbeParams(a.data_ptr(), b.data_ptr(), d.data_ptr(), n, int(a_from_registers)), a)
    return d


def count_launch(wrapper, *shape_and_dtype) -> None:
    """Count one kernel launch of `wrapper`: its total `launches` and its
    `launches_by_shape[(*shape, dtype name)]`, e.g. (B, H, N, d, "bfloat16")
    for attention, (R, C, F, "bfloat16") for LayerNorm+Dense."""
    *shape, dtype = shape_and_dtype
    wrapper.launches += 1
    key = (*shape, str(dtype).removeprefix("torch."))
    wrapper.launches_by_shape[key] = wrapper.launches_by_shape.get(key, 0) + 1


def _check_operands(q, k, v, bias=None) -> None:
    if q.dim() != 4:
        raise ValueError(f"expected (B, H, N, D) tensors, got {tuple(q.shape)}")
    b, h, _, d = q.shape
    for name, t in (("k", k), ("v", v)):
        if (t.dim() != 4 or (t.shape[0], t.shape[1], t.shape[3]) != (b, h, d) or t.shape != k.shape
                or t.dtype != q.dtype or t.device != q.device):
            raise ValueError(f"{name} must match q's shape (but for its length), dtype and device")
    if q.shape[-1] not in HEAD_DIMS:
        raise ValueError(f"head_dim {q.shape[-1]} not in {HEAD_DIMS}")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {q.device}")
    check_dtype(q.dtype, q.device)
    _check_bias(bias, k.shape[2], q.device)


def kernel_operand(t: torch.Tensor) -> torch.Tensor:
    """`t` itself when the kernels can read it through its strides, else a
    contiguous copy (an incoming gradient may have any layout)."""
    return t if _strides_ok(t) else t.contiguous()


def attention_fwd(q, k, v, scale: float, bias, wrapper):
    """(o, lse) of per-head attention, q (B, H, N, D) against k, v
    (B, H, Nk, D) with an optional (Nk,) f32 key bias: the forward kernel on
    CUDA tensors, its launch counted on `wrapper`; `attention_plain` on CPU
    tensors."""
    _check_operands(q, k, v, bias)
    if q.device.type == "cpu":
        return attention_plain(q, k, v, scale, return_lse=True, bias=bias)
    b, h, n, _ = q.shape
    o = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, n), dtype=torch.float32, device=q.device)
    launch_flash_fwd(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), o.transpose(1, 2), lse, scale, bias
    )
    count_launch(wrapper, *q.shape, q.dtype)
    return o, lse


def attention_bwd(q, k, v, o, lse, do, scale: float, bias, wrapper):
    """(dq, dk, dv) of `attention_fwd`: the backward kernel on CUDA tensors,
    its launch counted on `wrapper`; `attention_bwd_plain` on CPU tensors."""
    _check_operands(q, k, v, bias)
    if q.device.type == "cpu":
        return attention_bwd_plain(q, k, v, o, lse, do, scale, bias)
    do = kernel_operand(do)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    dk, dv = (torch.empty(k.shape, dtype=k.dtype, device=k.device) for _ in range(2))
    launch_flash_bwd(*(t.transpose(1, 2) for t in (q, k, v, o)), lse,
                     *(t.transpose(1, 2) for t in (do, dq, dk, dv)), scale, bias)
    count_launch(wrapper, *q.shape, q.dtype)
    return dq, dk, dv


def flash_attention_fwd(q, k, v, scale: float, bias=None):
    """(o, lse) of per-head attention, q (B, H, N, D) against k, v
    (B, H, Nk, D) with an optional (Nk,) f32 key bias: the forward kernel
    on CUDA tensors, `attention_plain` on CPU tensors. Not differentiable:
    `flash_attention` is the differentiable entry."""
    return attention_fwd(q, k, v, scale, bias, flash_attention)


def flash_attention_bwd(q, k, v, o, lse, do, scale: float, bias=None):
    """(dq, dk, dv) of `flash_attention_fwd`: the backward kernel on CUDA
    tensors, `attention_bwd_plain` on CPU tensors."""
    return attention_bwd(q, k, v, o, lse, do, scale, bias, flash_attention_bwd)


flash_attention_bwd.launches = 0  # backward-kernel launches since the last reset
flash_attention_bwd.launches_by_shape = {}


class _FlashAttention(torch.autograd.Function):
    """Per-head attention with the kernels' backward (pallas_flash.py:767-808)."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        o, lse = flash_attention_fwd(q, k, v, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.scale = scale
        ctx.mark_non_differentiable(lse)
        return o, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do, ctx.scale)
        return dq, dk, dv, None


def flash_attention(q, k, v, scale: Optional[float] = None, return_lse: bool = False):
    """softmax(q k^T * scale) v over (B, H, N, D) tensors, non-causal, with
    gradients to q, k and v through the backward kernel.

    Any strides with a contiguous head_dim axis. Returns o (B, H, N, D) in
    q's dtype, and the lse (B, H, N) with `return_lse` (not differentiable)."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    o, lse = _FlashAttention.apply(q, k, v, scale)
    return (o, lse) if return_lse else o


flash_attention.launches = 0  # forward-kernel launches since the last reset
flash_attention.launches_by_shape = {}


def multihead_attention(q, k, v, impl: str):
    """Scaled dot-product attention over (B, H, N, Dh), scale 1/sqrt(Dh).

    impl: 'plain' (eager reference), 'flash' (the per-head kernels),
    'flash_local' (the same kernels, whatever the ambient mesh: JAX's
    `pallas_flash.flash_attention_local`, the route the GPipe pipeline's
    stages take, parallel/pp.py), or the sequence-parallel 'flash_ring'
    (q, k and v sharded over the ambient mesh's 'model' group, K/V rotating
    round the ring: kernels/ring_flash.py) and 'flash_seq' (q sharded, K/V
    replicated: kernels/seq_flash.py). Those two read
    `parallel.get_mesh()`; with no mesh, or a 'model' group of one rank,
    they take `flash_attention`, as the JAX package does."""
    scale = q.shape[-1] ** -0.5
    if impl == "plain":
        return attention_plain(q, k, v, scale)
    if impl in ("flash", "flash_local"):
        return flash_attention(q, k, v, scale)
    if impl in ("flash_ring", "flash_seq"):
        from vit_ae_plus_plus_torch.parallel import get_mesh

        mesh = get_mesh()
        if mesh is None or mesh.size("model") == 1:
            return flash_attention(q, k, v, scale)
        if impl == "flash_ring":
            from vit_ae_plus_plus_torch.kernels.ring_flash import ring_flash_attention

            return ring_flash_attention(q, k, v, mesh, scale=scale)
        from vit_ae_plus_plus_torch.kernels.seq_flash import seq_sharded_flash_attention

        return seq_sharded_flash_attention(q, k, v, mesh, scale=scale)
    raise ValueError(
        f"unknown attention impl {impl!r} (want 'flash'|'plain'|'flash_local'|'flash_ring'|'flash_seq')"
    )


def _bf16_spacing(top: float) -> float:
    """One bf16 spacing at magnitude `top`."""
    finfo = torch.finfo(torch.bfloat16)
    return finfo.eps * 2.0 ** math.floor(math.log2(max(top, finfo.tiny)))


def kernel_tolerance(want_o: torch.Tensor) -> tuple:
    """Max-abs tolerances (o, lse) of the forward kernel against
    `attention_plain` on the same inputs, given the plain version's output.

    bf16: both sides round o to bf16, so an element may differ by one bf16
    spacing at the output's largest magnitude; the kernel's bf16 P (relative
    error 2^-9 per term) adds a small fraction of one. Two spacings.
    f32: f32-accurate products on both sides (the kernel's 3xTF32 is off
    by about 2^-22 relative per product, plain TF32's 2^-11 would not pass),
    only the summation order and the log2-domain softmax differ: 1e-5.
    lse: f32 on both sides for either dtype: 1e-4."""
    if want_o.dtype != torch.bfloat16:
        return 1e-5, 1e-4
    return 2 * _bf16_spacing(want_o.float().abs().max().item()), 1e-4


def bwd_tolerance(want: torch.Tensor) -> float:
    """Max-abs tolerance of one backward-kernel gradient (dq, dk or dv)
    against `attention_bwd_plain` on the same inputs, given the plain
    gradient.

    bf16: each gradient is a sum over N keys or queries of products whose
    P and dS factors the kernel rounds to bf16 (relative 2^-9 each) while
    the plain version keeps them in f32; the rounding errors are independent
    and add up like a random walk, which measures a few bf16 spacings at the
    largest gradient. Then the result is rounded to bf16 on both sides (one
    spacing). Eight spacings at the largest magnitude, and no less than
    1e-4: where a gradient vanishes (dq and dk of a single key, whose
    dP - delta cancels exactly) both sides hold f32 rounding noise of the
    size of dP times 2^-24, which the spacing of that noise would not cover.
    f32: f32 products and f32 sums on both sides in another order:
    1e-5 relative to the largest magnitude (at least 1e-5 absolute)."""
    top = want.float().abs().max().item()
    if want.dtype != torch.bfloat16:
        return 1e-5 * max(top, 1.0)
    return max(8 * _bf16_spacing(top), 1e-4)
