"""LayerNorm with f32 statistics: plain versions and the kernels' wrappers.

Counterpart of the JAX package's kernels/fused_ln.py (`fused_layernorm`, a
`jax.custom_vjp` over the forward and backward TPU kernels `_fwd_cp` and
`_bwd_cp`).

- `layernorm_plain` / `layernorm_bwd_plain`: eager PyTorch over (R, C) rows,
  the arithmetic of the TPU kernels: mean and the fast variance
  E[x^2] - mean^2 in at least f32, not clamped (so not `F.layer_norm`, whose
  variance is two-pass), and dx = rstd * (g - mean(g) - xhat * mean(g *
  xhat)) with g = dy * gamma. They are the CPU path and the reference the
  CUDA kernels are held to on the card.
- `layernorm_fwd` / `layernorm_bwd`: the kernels of csrc/layernorm.cu on
  CUDA tensors (or raise), the plain versions on CPU tensors.
- `fused_layernorm`: differentiable LayerNorm over the last axis, a
  `torch.autograd.Function` whose backward is `layernorm_bwd`; dgamma and
  dbeta are row sums outside the kernel, as in JAX.

Shared with kernels/fused_ln_dense.py: the widths the row kernels are built
for (`LN_WIDTHS`), the operand checks and the tolerances (`compare`).
"""

from __future__ import annotations

import ctypes

import torch

from vit_ae_plus_plus_torch.kernels._build import launch
from vit_ae_plus_plus_torch.kernels.flash_attention import _bf16_spacing, check_dtype, count_launch

LN_WIDTHS = (256, 512, 768, 1024)  # C of the kernels' template instances (csrc/ln_rows.cuh)
# at most this share of elements may differ at all between a bf16 kernel and
# its plain version (see `row_tolerance`)
MISMATCH_TOL = 0.02


def _inner(dtype: torch.dtype) -> torch.dtype:
    return torch.promote_types(dtype, torch.float32)


def row_stats_plain(x2: torch.Tensor, eps: float):
    """(mu, rstd) of the rows of x2 (R, C) in at least f32: the mean and
    rsqrt(E[x^2] - mean^2 + eps), the variance not clamped."""
    xf = x2.to(_inner(x2.dtype))
    mu = xf.mean(dim=-1)
    var = (xf * xf).mean(dim=-1) - mu * mu
    return mu, torch.rsqrt(var + eps)


def layernorm_plain(x2, gamma, beta, eps: float):
    """(y, mu, rstd): y = ((x - mu) * rstd) * gamma + beta over the rows of
    x2 (R, C), in at least f32, y in x2's dtype; mu and rstd (R,)."""
    mu, rstd = row_stats_plain(x2, eps)
    dt = mu.dtype
    xhat = (x2.to(dt) - mu[:, None]) * rstd[:, None]
    return (xhat * gamma.to(dt) + beta.to(dt)).to(x2.dtype), mu, rstd


def layernorm_bwd_plain(x2, gamma, mu, rstd, grad):
    """dx (R, C) in x2's dtype from the forward's mu and rstd and the row
    gradient `grad` (dy, or dln for the LayerNorm+Dense backward)."""
    dt = mu.dtype
    xhat = (x2.to(dt) - mu[:, None]) * rstd[:, None]
    g = grad.to(dt) * gamma.to(dt)
    mg = g.mean(dim=-1, keepdim=True)
    mgx = (g * xhat).mean(dim=-1, keepdim=True)
    return (rstd[:, None] * (g - mg - xhat * mgx)).to(x2.dtype)


def check_rows(x2: torch.Tensor, what: str) -> None:
    """The row kernels' contract on an (R, C) operand: a device they run on,
    a dtype they are built for, and on CUDA a width they are instanced at."""
    if x2.dim() != 2:
        raise ValueError(f"{what}: expected (R, C) rows, got {tuple(x2.shape)}")
    if x2.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {x2.device}")
    check_dtype(x2.dtype, x2.device)
    if x2.device.type == "cuda" and x2.shape[1] not in LN_WIDTHS:
        raise ValueError(f"{what}: width C={x2.shape[1]} not in {LN_WIDTHS} (the CUDA kernels' instances)")


def cuda_operand(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """`t` in `dtype`, contiguous and 16-byte aligned, for a kernel's pointer."""
    t = t.to(dtype).contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


class LnParams(ctypes.Structure):
    """Mirror of `struct LnParams` in csrc/layernorm.cu."""

    _fields_ = [
        *[(name, ctypes.c_void_p) for name in ("x", "dy", "gamma", "beta", "y", "dx", "mu", "rstd")],
        ("rows", ctypes.c_longlong), ("cols", ctypes.c_int), ("eps", ctypes.c_float),
    ]


def layernorm_fwd(x2, gamma, beta, eps: float):
    """(y, mu, rstd) of the LayerNorm over the rows of x2 (R, C): the
    forward kernel on a CUDA tensor, `layernorm_plain` on a CPU tensor."""
    check_rows(x2, "layernorm")
    if x2.device.type == "cpu":
        return layernorm_plain(x2, gamma, beta, eps)
    r, c = x2.shape
    x2 = cuda_operand(x2, x2.dtype)
    gamma, beta = (cuda_operand(t, torch.float32) for t in (gamma, beta))
    y = torch.empty_like(x2)
    mu, rstd = (torch.empty(r, dtype=torch.float32, device=x2.device) for _ in range(2))
    launch("layernorm", "layernorm_fwd",
           LnParams(x2.data_ptr(), None, gamma.data_ptr(), beta.data_ptr(), y.data_ptr(), None,
                    mu.data_ptr(), rstd.data_ptr(), r, c, float(eps)), x2)
    count_launch(fused_layernorm, r, c, x2.dtype)
    return y, mu, rstd


def layernorm_bwd(x2, gamma, mu, rstd, dy2):
    """dx (R, C) in x2's dtype: the backward kernel on CUDA tensors,
    `layernorm_bwd_plain` on CPU tensors."""
    check_rows(x2, "layernorm_bwd")
    if x2.device.type == "cpu":
        return layernorm_bwd_plain(x2, gamma, mu, rstd, dy2)
    r, c = x2.shape
    x2, dy2 = (cuda_operand(t, x2.dtype) for t in (x2, dy2))
    gamma, mu, rstd = (cuda_operand(t, torch.float32) for t in (gamma, mu, rstd))
    dx = torch.empty_like(x2)
    launch("layernorm", "layernorm_bwd",
           LnParams(x2.data_ptr(), dy2.data_ptr(), gamma.data_ptr(), None, None, dx.data_ptr(),
                    mu.data_ptr(), rstd.data_ptr(), r, c, 0.0), x2)
    count_launch(layernorm_bwd, r, c, x2.dtype)
    return dx


layernorm_bwd.launches = 0  # backward-kernel launches since the last reset
layernorm_bwd.launches_by_shape = {}


class _FusedLayerNorm(torch.autograd.Function):
    """Counterpart of the `jax.custom_vjp` at fused_ln.py:225-262."""

    @staticmethod
    def forward(ctx, x, gamma, beta, eps):
        x2 = x.reshape(-1, x.shape[-1])
        y, mu, rstd = layernorm_fwd(x2, gamma, beta, eps)
        ctx.save_for_backward(x2, gamma, mu, rstd)
        return y.view(x.shape)

    @staticmethod
    def backward(ctx, dy):
        x2, gamma, mu, rstd = ctx.saved_tensors
        dy2 = dy.reshape(x2.shape)
        dx = layernorm_bwd(x2, gamma, mu, rstd, dy2)
        # parameter grads: row sums, outside the kernel (fused_ln.py:250-254)
        dt = mu.dtype
        xhat = (x2.to(dt) - mu[:, None]) * rstd[:, None]
        dyf = dy2.to(dt)
        dgamma = (dyf * xhat).sum(dim=0).to(gamma.dtype)
        dbeta = dyf.sum(dim=0).to(gamma.dtype)
        return dx.view(dy.shape), dgamma, dbeta, None


def fused_layernorm(x, gamma, beta, eps: float = 1e-6):
    """LayerNorm over the last axis of x (any leading shape), result in x's
    dtype, statistics in at least f32; differentiable in x, gamma and beta.
    A CPU tensor takes the plain versions; a CUDA tensor launches the kernels
    (csrc/layernorm.cu) or raises."""
    return _FusedLayerNorm.apply(x, gamma, beta, eps)


fused_layernorm.launches = 0  # forward-kernel launches since the last reset
fused_layernorm.launches_by_shape = {}


def row_tolerance(want: torch.Tensor) -> float:
    """Max-abs tolerance of a row kernel's output (y, dx, or the LN+Dense
    forward's y) against its plain version on the same inputs.

    bf16: both sides compute in f32 and round the result to bf16; their
    statistics and sums differ only in summation order (and, for a product,
    in the order of an f32 accumulation), which flips the rounding of an
    element now and then: one bf16 spacing at the element, so two at the
    largest magnitude. Together with it, `MISMATCH_TOL` bounds the share of
    elements that differ at all (a kernel that rounds at other places than
    the plain version moves a large share of them by one spacing). f32: f32
    on both sides in another order: 1e-5 relative to the largest magnitude
    (at least 1e-5 absolute)."""
    top = want.float().abs().max().item()
    if want.dtype != torch.bfloat16:
        return 1e-5 * max(top, 1.0)
    return 2 * _bf16_spacing(top)


def compare(got: torch.Tensor, want: torch.Tensor) -> dict:
    """How far a kernel's output lies from its plain version: the max abs
    error and its `row_tolerance`, the share of elements that differ and
    its limit (`MISMATCH_TOL` in bf16, none in f32), and `ok`."""
    err = (got.float() - want.float()).abs().max().item()
    tol = row_tolerance(want)
    mismatch = (got != want).float().mean().item()
    mismatch_tol = MISMATCH_TOL if want.dtype == torch.bfloat16 else 1.0
    ok = bool(torch.isfinite(got).all()) and err <= tol and mismatch <= mismatch_tol
    return {"max_abs_err": err, "tol": tol, "mismatch": mismatch, "mismatch_tol": mismatch_tol, "ok": ok}
