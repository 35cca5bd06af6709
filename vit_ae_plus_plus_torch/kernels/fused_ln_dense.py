"""LayerNorm fused into the next Dense layer: plain versions and wrappers.

Counterpart of the JAX package's kernels/fused_ln_dense.py
(`fused_ln_dense`, a `jax.custom_vjp` over the TPU kernels `_fwd_cp` and
`_bwd_cp`), which the blocks run for norm1 -> attn.qkv and norm2 -> mlp.fc1
under `ln_fusion="on"` (models/vit.py).

- `ln_dense_plain` / `ln_dense_bwd_plain`: eager PyTorch with the TPU
  kernels' arithmetic: fast-variance statistics in at least f32, the
  normalised rows rounded to the compute dtype, the product accumulated in
  f32, rounded to the compute dtype, then the bias added in the compute
  dtype; the backward's dln = dY W in f32 and the LayerNorm row pass. They
  are the CPU path and the reference the CUDA kernels are held to.
- `ln_dense_fwd` / `ln_dense_bwd`: csrc/ln_dense.cu on CUDA tensors (or
  raise), the plain versions on CPU tensors. The bf16 forward runs on
  Hopper's wgmma with W streamed through TMA: each block normalises a slab
  of rows once, in shared memory, for a run of 128-column tiles. The bf16
  backward's dln product runs on wgmma too, dY and W streamed by TMA (W
  read MN-major), before the LayerNorm row pass. In f32 both products run
  as 3xTF32 on wgmma: a pre-pass splits W into tf32 hi and lo copies
  (scratch the wrapper allocates, transposed for the dln product), and x
  (normalised in registers) or dY is split as it is read.
- `fused_ln_dense(x, gamma, beta, w, b, eps)`: the differentiable op over
  the f32 parameters; W in PyTorch's (F, C) layout.
"""

from __future__ import annotations

import ctypes

import torch

from vit_ae_plus_plus_torch.kernels._build import launch
from vit_ae_plus_plus_torch.kernels.flash_attention import count_launch
from vit_ae_plus_plus_torch.kernels.fused_ln import (
    check_rows,
    cuda_operand,
    layernorm_bwd_plain,
    row_stats_plain,
)


def _check(x2: torch.Tensor, w: torch.Tensor) -> None:
    """The kernels' contract: C a built width (`check_rows`), w (F, C) with
    F a multiple of 32 on CUDA (the kernels store output columns in pairs,
    and the f32 ones split W in 32 x 32 tiles and step the depth by 32; any
    R). The wrappers hand the kernels contiguous, 16-byte aligned operands
    (`cuda_operand`), as the kernels' TMA descriptors need."""
    check_rows(x2, "ln_dense")
    if w.dim() != 2 or w.shape[1] != x2.shape[1]:
        raise ValueError(f"w must be (F, C) with C={x2.shape[1]}, got {tuple(w.shape)}")
    if x2.device.type == "cuda" and w.shape[0] % 32:
        raise ValueError(f"F={w.shape[0]} is not a multiple of 32 (the CUDA kernels' tiles)")


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b with at least f32 products and sums and an at least f32 result:
    JAX's `preferred_element_type=float32`. On the card a bf16 pair runs
    as one bf16 GEMM that writes f32 (exact products, f32 sums), not as an
    f32 GEMM."""
    if a.is_cuda and a.dtype == torch.bfloat16:
        return torch.mm(a, b, out_dtype=torch.float32)
    dt = torch.promote_types(a.dtype, torch.float32)
    return torch.mm(a.to(dt), b.to(dt))


def ln_dense_plain(x2, gamma, beta, w, b, eps: float):
    """(y, mu, rstd): y = LN(x2).to(cdt) @ w^T accumulated in f32, rounded to
    cdt, plus b in cdt (cdt = x2's dtype; w (F, C) and b (F,) already in it)."""
    mu, rstd = row_stats_plain(x2, eps)
    xhat = (x2.to(mu.dtype) - mu[:, None]) * rstd[:, None]
    ln = (xhat * gamma.to(mu.dtype) + beta.to(mu.dtype)).to(x2.dtype)
    acc = _mm(ln, w.t())
    return acc.to(x2.dtype) + b.to(x2.dtype), mu, rstd


def ln_dense_bwd_plain(x2, gamma, w, dy2, mu, rstd):
    """(dx, dln): dln = dy2 @ w in f32, (R, C); dx the LayerNorm row pass on
    dln, in x2's dtype."""
    dln = _mm(dy2, w)
    return layernorm_bwd_plain(x2, gamma, mu, rstd, dln), dln


class LndParams(ctypes.Structure):
    """Mirror of `struct LndParams` in csrc/ln_dense.cu."""

    _fields_ = [
        *[(name, ctypes.c_void_p) for name in
          ("x", "gamma", "beta", "w", "b", "y", "mu", "rstd", "dy", "dln", "dx", "w_hi", "w_lo")],
        ("rows", ctypes.c_longlong), ("cols", ctypes.c_int), ("features", ctypes.c_int),
        ("eps", ctypes.c_float),
    ]


def _split_scratch(w: torch.Tensor, transposed: bool) -> list:
    """The f32 kernels' scratch for W split into tf32 hi and lo: two f32
    tensors of (F, C), or (C, F) transposed; [None, None] for bf16."""
    if w.dtype != torch.float32:
        return [None, None]
    shape = w.shape[::-1] if transposed else w.shape
    return [torch.empty(shape, dtype=torch.float32, device=w.device) for _ in range(2)]


def _ptr(t):
    return None if t is None else t.data_ptr()


def ln_dense_fwd(x2, gamma, beta, w, b, eps: float):
    """(y, mu, rstd) for x2 (R, C) and w (F, C), b (F,) in x2's dtype: the
    forward kernel on CUDA tensors, `ln_dense_plain` on CPU tensors."""
    _check(x2, w)
    if x2.device.type == "cpu":
        return ln_dense_plain(x2, gamma, beta, w, b, eps)
    (r, c), f = x2.shape, w.shape[0]
    x2, w, b = (cuda_operand(t, x2.dtype) for t in (x2, w, b))
    gamma, beta = (cuda_operand(t, torch.float32) for t in (gamma, beta))
    y = torch.empty((r, f), dtype=x2.dtype, device=x2.device)
    mu, rstd = (torch.empty(r, dtype=torch.float32, device=x2.device) for _ in range(2))
    w_hi, w_lo = _split_scratch(w, transposed=False)
    launch("ln_dense", "ln_dense_fwd",
           LndParams(x2.data_ptr(), gamma.data_ptr(), beta.data_ptr(), w.data_ptr(), b.data_ptr(),
                     y.data_ptr(), mu.data_ptr(), rstd.data_ptr(), None, None, None, _ptr(w_hi), _ptr(w_lo),
                     r, c, f, float(eps)),
           x2)
    count_launch(fused_ln_dense, r, c, f, x2.dtype)
    return y, mu, rstd


def ln_dense_bwd(x2, gamma, w, dy2, mu, rstd):
    """(dx, dln): the backward kernels (the dln product, then the row pass)
    on CUDA tensors, `ln_dense_bwd_plain` on CPU tensors."""
    _check(x2, w)
    if x2.device.type == "cpu":
        return ln_dense_bwd_plain(x2, gamma, w, dy2, mu, rstd)
    (r, c), f = x2.shape, w.shape[0]
    x2, w, dy2 = (cuda_operand(t, x2.dtype) for t in (x2, w, dy2))
    gamma, mu, rstd = (cuda_operand(t, torch.float32) for t in (gamma, mu, rstd))
    dx = torch.empty_like(x2)
    dln = torch.empty((r, c), dtype=torch.float32, device=x2.device)
    w_hi, w_lo = _split_scratch(w, transposed=True)
    launch("ln_dense", "ln_dense_bwd",
           LndParams(x2.data_ptr(), gamma.data_ptr(), None, w.data_ptr(), None, None, mu.data_ptr(),
                     rstd.data_ptr(), dy2.data_ptr(), dln.data_ptr(), dx.data_ptr(), _ptr(w_hi), _ptr(w_lo),
                     r, c, f, 0.0),
           x2)
    count_launch(ln_dense_bwd, r, c, f, x2.dtype)
    return dx, dln


ln_dense_bwd.launches = 0  # backward-kernel launches since the last reset
ln_dense_bwd.launches_by_shape = {}


class _FusedLnDense(torch.autograd.Function):
    """Counterpart of the `jax.custom_vjp` at fused_ln_dense.py:198-254."""

    @staticmethod
    def forward(ctx, x, gamma, beta, w, b, eps):
        x2 = x.reshape(-1, x.shape[-1])
        wc = w.to(x.dtype)  # W and b in the compute dtype, as _lnd_fwd casts them
        y, mu, rstd = ln_dense_fwd(x2, gamma, beta, wc, b.to(x.dtype), eps)
        ctx.save_for_backward(x2, gamma, beta, wc, mu, rstd)
        return y.view(*x.shape[:-1], w.shape[0])

    @staticmethod
    def backward(ctx, dy):
        x2, gamma, beta, wc, mu, rstd = ctx.saved_tensors
        dy2 = dy.reshape(-1, wc.shape[0])
        dx, dln = ln_dense_bwd(x2, gamma, wc, dy2, mu, rstd)
        # parameter grads outside the kernel (fused_ln_dense.py:237-244): dW
        # from LN(x) rebuilt in the compute dtype, the rest f32 row sums
        dt = mu.dtype
        xhat = (x2.to(dt) - mu[:, None]) * rstd[:, None]
        dw = _mm(dy2.t(), (xhat * gamma.to(dt) + beta.to(dt)).to(x2.dtype))
        db = dy2.sum(dim=0, dtype=dt)
        dgamma = (dln * xhat).sum(dim=0)
        dbeta = dln.sum(dim=0)
        return dx.view(*dy.shape[:-1], x2.shape[1]), dgamma, dbeta, dw, db, None


def fused_ln_dense(x, gamma, beta, w, b, eps: float = 1e-6):
    """y = LayerNorm(x; gamma, beta, eps) @ w^T + b over the last axis of x.

    x (..., C) in the compute dtype; gamma, beta (C,), w (F, C) and b (F,)
    the f32 parameters (w in nn.Linear's layout), cast to x's dtype inside.
    Differentiable in all five; the parameter gradients come back in f32.
    A CPU tensor takes the plain versions; a CUDA tensor launches the kernels
    (csrc/ln_dense.cu) or raises."""
    return _FusedLnDense.apply(x, gamma, beta, w, b, eps)


fused_ln_dense.launches = 0  # forward-kernel launches since the last reset
fused_ln_dense.launches_by_shape = {}


def dln_tolerance(want: torch.Tensor, inputs_dtype: torch.dtype) -> float:
    """Max-abs tolerance of the kernel's f32 dln against the plain version's.
    Both multiply the same operands exactly and sum in f32 in another order
    (the tensor cores for bf16 operands): 1e-4 relative to the largest
    magnitude for bf16 operands, 1e-5 for f32 (where the kernel's 3xTF32
    products are exact to about 2^-22, tests/test_torch_port_tf32_split.py)."""
    top = want.abs().max().item()
    return (1e-4 if inputs_dtype == torch.bfloat16 else 1e-5) * max(top, 1.0)
