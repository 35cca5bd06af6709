"""Multi-head attention: the plain version, the per-head kernel and the dispatch.

Counterpart of the JAX package's kernels/flash_attention.py
(`multihead_attention`) and kernels/pallas_flash.py (`flash_attention`).

- `attention_plain`: eager PyTorch over (B, H, N, D). Products and softmax
  run in f32 and the output is cast back to the input dtype: the arithmetic
  of the TPU kernels, which upcast q, k and v to f32. It is the CPU path and
  the reference the CUDA kernel is held to on the card.
- `flash_attention`: the per-head wrapper of `csrc/flash_fwd.cu`. On a CPU
  tensor it takes the plain version; on a CUDA tensor it launches the kernel
  or raises.
- `multihead_attention`: the per-head dispatch behind `attn_impl`
  ('plain' or 'flash'); the model's 'auto' is resolved in models/vit.py.
- `kernel_tolerance`: how far the kernel may lie from the plain version.

The kernel reads its operands through (batch, token, head) strides, so
`launch_flash_fwd` takes (B, N, H, D) views: a per-head tensor is passed
transposed, the packed (B, N, 3C) projection as three views of itself.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from vit_ae_plus_plus_torch.kernels import _build

HEAD_DIMS = (32, 64, 128)  # the kernel's template instances
DTYPES = (torch.float32, torch.bfloat16)


def attention_plain(q, k, v, scale: float, return_lse: bool = False):
    """softmax(q k^T * scale) v over (B, H, N, D); f32 inside, q's dtype out.
    With `return_lse`, also the f32 log-sum-exp of the scaled scores, (B, H, N)."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    o = torch.matmul(torch.softmax(s, dim=-1), v.float()).to(q.dtype)
    if return_lse:
        return o, torch.logsumexp(s, dim=-1)
    return o


class FlashFwdParams(ctypes.Structure):
    """Mirror of `struct FlashFwdParams` in csrc/flash_fwd.cu."""

    _fields_ = [
        ("q", ctypes.c_void_p), ("k", ctypes.c_void_p), ("v", ctypes.c_void_p),
        ("o", ctypes.c_void_p), ("lse", ctypes.c_void_p),
        *[(f"{t}_s{a}", ctypes.c_longlong) for t in "qkvo" for a in "bnh"],
        ("batch", ctypes.c_int), ("heads", ctypes.c_int),
        ("seq_len", ctypes.c_int), ("head_dim", ctypes.c_int),
        ("scale", ctypes.c_float),
    ]


def _flash_lib() -> ctypes.CDLL:
    lib = _build.load("flash_fwd")
    lib.flash_fwd.argtypes = [
        ctypes.POINTER(FlashFwdParams), ctypes.c_int, ctypes.c_int, ctypes.c_void_p
    ]
    lib.flash_fwd.restype = ctypes.c_int
    lib.flash_fwd_error_string.argtypes = [ctypes.c_int]
    lib.flash_fwd_error_string.restype = ctypes.c_char_p
    return lib


def launch_flash_fwd(q, k, v, o, lse: Optional[torch.Tensor], scale: float) -> None:
    """Run csrc/flash_fwd.cu on (B, N, H, D) views of CUDA tensors of one
    shape and dtype (the wrappers check both).

    `o` is written in place; `lse`, if given, is a contiguous (B, H, N) f32
    tensor. Launches on the current stream and does not synchronise."""
    b, n, h, d = q.shape
    # shapes, dtypes and head_dim are checked by the wrappers; the bf16 kernel moves 16-byte vectors: every row start must be aligned
    vec = 16 // q.element_size() if q.dtype == torch.bfloat16 else 1
    for name, t in (("q", q), ("k", k), ("v", v), ("o", o)):
        if t.stride(-1) != 1:
            raise ValueError(f"{name}: the head_dim axis must be contiguous")
        if any(s % vec for s in t.stride()[:3]) or t.data_ptr() % (vec * t.element_size()):
            raise ValueError(
                f"{name}: strides {t.stride()} and address must be multiples "
                f"of {vec} elements for the {q.dtype} kernel"
            )
    if lse is not None and (
        lse.shape != (b, h, n) or lse.dtype != torch.float32
        or not lse.is_contiguous() or lse.device != q.device
    ):
        raise ValueError("lse must be a contiguous (B, H, N) float32 tensor on q's device")

    params = FlashFwdParams(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr() if lse is not None else None,
        *[t.stride(i) for t in (q, k, v, o) for i in (0, 1, 2)],
        b, h, n, d, float(scale),
    )
    lib = _flash_lib()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.flash_fwd(
        ctypes.byref(params), int(q.dtype == torch.bfloat16), q.device.index or 0, stream
    )
    if err != 0:
        raise RuntimeError(
            f"flash_fwd launch failed: {lib.flash_fwd_error_string(err).decode()}"
        )


def _check_operands(q, k, v) -> None:
    if q.dim() != 4:
        raise ValueError(f"expected (B, H, N, D) tensors, got {tuple(q.shape)}")
    for name, t in (("k", k), ("v", v)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name} must match q's shape, dtype and device")
    if q.shape[-1] not in HEAD_DIMS:
        raise ValueError(f"head_dim {q.shape[-1]} not in {HEAD_DIMS}")
    if q.dtype not in DTYPES:
        raise ValueError(f"dtype {q.dtype} not in {DTYPES}")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {q.device}")


def flash_attention(q, k, v, scale: Optional[float] = None, return_lse: bool = False):
    """softmax(q k^T * scale) v over (B, H, N, D) tensors, non-causal.

    Any strides with a contiguous head_dim axis. Returns o (B, H, N, D) in
    q's dtype, and the f32 lse (B, H, N) with `return_lse`."""
    _check_operands(q, k, v)
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    if q.device.type == "cpu":
        return attention_plain(q, k, v, scale, return_lse)
    b, h, n, _ = q.shape
    o = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, n), dtype=torch.float32, device=q.device) if return_lse else None
    launch_flash_fwd(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), o.transpose(1, 2), lse, scale
    )
    flash_attention.launches += 1
    return (o, lse) if return_lse else o


flash_attention.launches = 0  # kernel launches since the last reset


def multihead_attention(q, k, v, impl: str):
    """Scaled dot-product attention over (B, H, N, Dh), scale 1/sqrt(Dh).

    impl: 'plain' (eager reference) or 'flash' (the per-head kernel)."""
    scale = q.shape[-1] ** -0.5
    if impl == "plain":
        return attention_plain(q, k, v, scale)
    if impl == "flash":
        return flash_attention(q, k, v, scale)
    raise ValueError(f"unknown attention impl {impl!r} (want 'flash'|'plain')")


def kernel_tolerance(want_o: torch.Tensor) -> tuple:
    """Max-abs tolerances (o, lse) of the CUDA kernel against `attention_plain`
    on the same inputs, given the plain version's output `want_o`.

    bf16: both sides round o to bf16, so an element may differ by one bf16
    spacing at the output's largest magnitude; the kernel's bf16 P (relative
    error 2^-9 per term) adds a small fraction of one. Two spacings.
    f32: f32 products on both sides, only the summation order and the
    log2-domain softmax differ: 1e-5. lse: f32 on both sides for either
    dtype: 1e-4."""
    if want_o.dtype != torch.bfloat16:
        return 1e-5, 1e-4
    finfo = torch.finfo(torch.bfloat16)
    top = max(want_o.float().abs().max().item(), finfo.tiny)
    return 2 * finfo.eps * 2.0 ** math.floor(math.log2(top)), 1e-4
