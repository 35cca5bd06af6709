"""The plain reference: the 3D ViT-AE++ MAE, its objective and AdamW, in
plain PyTorch and float32.

It follows the published model (He et al., MAE, arXiv:2111.06377; the
ViT-AE++ reference's model/vit_autoenc.py and its losses) and the
conventions of the program it judges, written out again here: patches in
(dz, dy, dx, c) order, the fixed 3D sin-cos tables (numpy's 'xy'
meshgrid, widths split in even thirds), masking by a stable argsort of
the given noise, pre-LN blocks (LayerNorm eps 1e-6, exact GELU), the
SimSiam predictor with flax's BatchNorm (biased batch variance, eps 1e-5),
the masked reconstruction in voxel space, the Sobel map of the raw
prediction against that of the blurred target (separable banded
products, zero padding), the per-token negative cosine term, and AdamW
with decay on every tensor of more than one dimension.

`precision` sets the products' operands: 'f32' (exact float32, TF32
off), 'tf32' (operands rounded to TF32's 10-bit mantissa) or 'fp8'
(operands scaled per tensor into float8 e4m3 and back); that is the
control, the reference one precision below the configuration's. The
filters and reductions stay float32.

Blocks run under activation checkpointing and attention in row chunks,
so that a full-width step fits beside nothing else on the card; that
changes no value.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

PRECISIONS = ("f32", "tf32", "fp8")


# ---------------------------------------------------------------- parameters

def _block_spec(prefix: str, dim: int, hidden: int) -> list:
    return [
        (f"{prefix}.norm1.weight", (dim,), "norm_w"), (f"{prefix}.norm1.bias", (dim,), "norm_b"),
        (f"{prefix}.attn.qkv.weight", (3 * dim, dim), "xavier"), (f"{prefix}.attn.qkv.bias", (3 * dim,), "bias"),
        (f"{prefix}.attn.proj.weight", (dim, dim), "xavier"), (f"{prefix}.attn.proj.bias", (dim,), "bias"),
        (f"{prefix}.norm2.weight", (dim,), "norm_w"), (f"{prefix}.norm2.bias", (dim,), "norm_b"),
        (f"{prefix}.mlp.fc1.weight", (hidden, dim), "xavier"), (f"{prefix}.mlp.fc1.bias", (hidden,), "bias"),
        (f"{prefix}.mlp.fc2.weight", (dim, hidden), "xavier"), (f"{prefix}.mlp.fc2.bias", (dim,), "bias"),
    ]


def encoder_spec(cfg: dict) -> list:
    """[(name, shape, kind)] of the encoder's parameters (the program's
    names; the patch embed as its Conv3d weight (D, C, p, p, p))."""
    d, p, c = cfg["embed_dim"], cfg["patch_size"], cfg["in_chans"]
    spec = [("patch_embed.proj.weight", (d, c, p, p, p), "xavier"), ("patch_embed.proj.bias", (d,), "bias"),
            ("cls_token", (1, 1, d), "token")]
    for i in range(cfg["depth"]):
        spec += _block_spec(f"blocks.{i}", d, int(d * cfg["mlp_ratio"]))
    return spec + [("norm.weight", (d,), "norm_w"), ("norm.bias", (d,), "norm_b")]


def mae_spec(cfg: dict) -> list:
    """[(name, shape, kind)] of every parameter of the MAE."""
    d, dd = cfg["embed_dim"], cfg["decoder_embed_dim"]
    spec = encoder_spec(cfg)
    spec += [("decoder_embed.weight", (dd, d), "xavier"), ("decoder_embed.bias", (dd,), "bias"),
             ("mask_token", (1, 1, dd), "token")]
    for i in range(cfg["decoder_depth"]):
        spec += _block_spec(f"decoder_blocks.{i}", dd, int(dd * cfg["mlp_ratio"]))
    pdim = cfg["patch_size"] ** 3 * cfg["in_chans"]
    spec += [("decoder_norm.weight", (dd,), "norm_w"), ("decoder_norm.bias", (dd,), "norm_b"),
             ("decoder_pred.weight", (pdim, dd), "xavier"), ("decoder_pred.bias", (pdim,), "bias")]
    if cfg["contrastive"]:
        spec += [("predictor.0.weight", (d, d), "xavier"),
                 ("predictor.1.weight", (d,), "norm_w"), ("predictor.1.bias", (d,), "norm_b"),
                 ("predictor.3.weight", (d, d), "xavier"), ("predictor.3.bias", (d,), "bias")]
    return spec


# ---------------------------------------------------------------- precision

def _round(x: torch.Tensor, precision: str) -> torch.Tensor:
    """x with its value rounded to the precision's operands; the gradient
    passes straight through."""
    if precision == "f32":
        return x
    with torch.no_grad():
        if precision == "tf32":
            bits = x.float().contiguous().view(torch.int32)
            r = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
        elif precision == "fp8":
            scale = x.abs().amax().clamp_min(1e-30) / 448.0
            r = (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale
        else:
            raise ValueError(f"precision must be one of {PRECISIONS}, got {precision!r}")
    return x + (r - x).detach()


def _mm(a, b, precision):
    return _round(a, precision) @ _round(b, precision)


def _linear(x, w, b, precision):
    y = _mm(x, w.t(), precision)
    return y if b is None else y + b


# ---------------------------------------------------------------- layers

def patchify(v: torch.Tensor, p: int) -> torch.Tensor:
    """(N, C, S, S, S) -> (N, L, p^3 C), patches in raster order, each in
    (dz, dy, dx, c) order."""
    n, c, s = v.shape[0], v.shape[1], v.shape[2]
    g = s // p
    x = v.reshape(n, c, g, p, g, p, g, p).permute(0, 2, 4, 6, 3, 5, 7, 1)
    return x.reshape(n, g ** 3, p ** 3 * c)


def unpatchify(x: torch.Tensor, p: int) -> torch.Tensor:
    n, l, pd = x.shape
    g = round(l ** (1 / 3))
    c = pd // p ** 3
    x = x.reshape(n, g, g, g, p, p, p, c).permute(0, 7, 1, 4, 2, 5, 3, 6)
    return x.reshape(n, c, g * p, g * p, g * p)


def sincos_table(dim: int, grid: int) -> np.ndarray:
    """(1 + G^3, dim): a zero cls row, then the 3D sin-cos embedding."""

    def one_d(width, pos):
        omega = 1.0 / 10000 ** (np.arange(width // 2, dtype=np.float64) / (width / 2.0))
        out = np.einsum("m,d->md", pos.reshape(-1), omega)
        return np.concatenate([np.sin(out), np.cos(out)], axis=1)

    axes = [np.arange(grid, dtype=np.float32)] * 3
    g = np.stack(np.meshgrid(*axes), axis=0).reshape(3, 1, grid, grid, grid)
    res = dim // 3 + (dim // 3) % 2
    emb = np.concatenate([one_d(res, g[0]), one_d(res, g[1]), one_d(dim - 2 * res, g[2])], axis=1)
    return np.concatenate([np.zeros((1, dim)), emb], axis=0)


def _table(dim, grid, device):
    return torch.as_tensor(sincos_table(dim, grid), dtype=torch.float32, device=device)


def _layer_norm(x, P, name):
    return F.layer_norm(x, (x.shape[-1],), P[f"{name}.weight"], P[f"{name}.bias"], 1e-6)


def _attention_core(q, k, v, precision):
    s = _mm(q, k.transpose(-2, -1), precision) * (q.shape[-1] ** -0.5)
    return _mm(torch.softmax(s, dim=-1), v, precision)


def _attention(x, P, name, heads, precision):
    b, n, c = x.shape
    d = c // heads
    qkv = _linear(x, P[f"{name}.qkv.weight"], P[f"{name}.qkv.bias"], precision)
    q, k, v = qkv.view(b, n, 3, heads, d).permute(2, 0, 3, 1, 4).unbind(0)
    chunk = max(1, int(2e9 // (heads * n * n * 4)))
    outs = []
    for i in range(0, b, chunk):
        sl = slice(i, i + chunk)
        if torch.is_grad_enabled():
            outs.append(checkpoint(_attention_core, q[sl], k[sl], v[sl], precision, use_reentrant=False))
        else:
            outs.append(_attention_core(q[sl], k[sl], v[sl], precision))
    o = torch.cat(outs).transpose(1, 2).reshape(b, n, c)
    return _linear(o, P[f"{name}.proj.weight"], P[f"{name}.proj.bias"], precision)


def _block(x, P, name, heads, precision):
    x = x + _attention(_layer_norm(x, P, f"{name}.norm1"), P, f"{name}.attn", heads, precision)
    h = F.gelu(_linear(_layer_norm(x, P, f"{name}.norm2"), P[f"{name}.mlp.fc1.weight"],
                       P[f"{name}.mlp.fc1.bias"], precision))
    return x + _linear(h, P[f"{name}.mlp.fc2.weight"], P[f"{name}.mlp.fc2.bias"], precision)


def _blocks(x, P, prefix, depth, heads, precision):
    for i in range(depth):
        if torch.is_grad_enabled():
            x = checkpoint(_block, x, P, f"{prefix}.{i}", heads, precision, use_reentrant=False)
        else:
            x = _block(x, P, f"{prefix}.{i}", heads, precision)
    return x


def _patch_embed(v, P, cfg, precision):
    w = P["patch_embed.proj.weight"]
    w = w.permute(0, 2, 3, 4, 1).reshape(w.shape[0], -1)  # rows in (dz, dy, dx, c) order
    return _linear(patchify(v, cfg["patch_size"]), w, P["patch_embed.proj.bias"], precision)


def _batch_norm(x, P, name):
    """flax BatchNorm on batch statistics: biased variance, eps 1e-5."""
    mean = x.mean(dim=0)
    var = torch.clamp_min((x * x).mean(dim=0) - mean * mean, 0.0)
    return (x - mean) * (torch.rsqrt(var + 1e-5) * P[f"{name}.weight"]) + P[f"{name}.bias"]


def _predictor(z, P, precision):
    h = torch.relu(_batch_norm(_linear(z, P["predictor.0.weight"], None, precision), P, "predictor.1"))
    return _linear(h, P["predictor.3.weight"], P["predictor.3.bias"], precision)


def mae_forward(P, cfg, view1, view2, noise, precision="f32") -> Dict[str, torch.Tensor]:
    """pred (B, L, p^3 C), mask (B, L) (1 = removed) and, contrastive with
    view2, p1, p2, z1, z2 (z detached)."""
    both = torch.cat([view1, view2]) if view2 is not None else view1
    b = view1.shape[0]
    grid = cfg["volume_size"] // cfg["patch_size"]
    d, dev = cfg["embed_dim"], view1.device
    pos = _table(d, grid, dev)
    x = _patch_embed(both, P, cfg, precision) + pos[1:]
    n, l, _ = x.shape
    keep = int(l * (1 - cfg["mask_ratio"]))
    ids_shuffle = torch.argsort(noise, dim=1, stable=True)
    ids_restore = torch.argsort(ids_shuffle, dim=1, stable=True)
    x = torch.gather(x, 1, ids_shuffle[:, :keep, None].expand(-1, -1, d))
    mask = torch.ones((n, l), device=dev)
    mask[:, :keep] = 0
    mask = torch.gather(mask, 1, ids_restore)
    cls = (P["cls_token"] + pos[:1]).expand(n, -1, -1)
    x = _blocks(torch.cat([cls, x], dim=1), P, "blocks", cfg["depth"], cfg["num_heads"], precision)
    latent_all = _layer_norm(x, P, "norm")
    latent = latent_all[:b]

    dd = cfg["decoder_embed_dim"]
    y = _linear(latent, P["decoder_embed.weight"], P["decoder_embed.bias"], precision)
    vis = y[:, 1:]
    full = torch.cat([vis, P["mask_token"].expand(b, l - keep, dd)], dim=1)
    full = torch.gather(full, 1, ids_restore[:b, :, None].expand(-1, -1, dd))
    y = torch.cat([y[:, :1], full], dim=1) + _table(dd, grid, dev)
    y = _blocks(y, P, "decoder_blocks", cfg["decoder_depth"], cfg["decoder_num_heads"], precision)
    pred = _linear(_layer_norm(y, P, "decoder_norm"), P["decoder_pred.weight"], P["decoder_pred.bias"],
                   precision)[:, 1:]
    out = {"pred": pred, "mask": mask[:b]}
    if view2 is not None:
        z1 = latent.reshape(-1, d)
        z2 = latent_all[b:].reshape(-1, d)
        out.update(p1=_predictor(z1, P, precision), p2=_predictor(z2, P, precision),
                   z1=z1.detach(), z2=z2.detach())
    return out


# ---------------------------------------------------------------- objective

_SMOOTH, _DERIV = (1.0, 2.0, 1.0), (1.0, 0.0, -1.0)
_EINSUM = {0: "bczyx,zw->bcwyx", 1: "bczyx,yw->bczwx", 2: "bczyx,xw->bczyw"}


def _band(taps, size, device):
    """M[j, i] = taps[j - i + pad]: the 1-D cross-correlation with zero
    padding as a right product."""
    taps = np.asarray(taps, np.float32)
    pad = len(taps) // 2
    k = np.arange(size)[:, None] - np.arange(size)[None, :] + pad
    m = np.where((k >= 0) & (k < len(taps)), taps[np.clip(k, 0, len(taps) - 1)], 0.0)
    return torch.as_tensor(m, dtype=torch.float32, device=device)


def _pass(v, taps, axis):
    return torch.einsum(_EINSUM[axis], v, _band(taps, v.shape[2 + axis], v.device))


def sobel(v: torch.Tensor) -> torch.Tensor:
    """(N, C, S, S, S) -> (N, S, S, S): the Sobel gradient magnitude summed
    over channels, with gradient 0 where it is 0."""
    sz, sy = _pass(v, _SMOOTH, 0), _pass(v, _SMOOTH, 1)
    gx = _pass(_pass(sz, _SMOOTH, 1), _DERIV, 2)
    gy = _pass(_pass(sz, _DERIV, 1), _SMOOTH, 2)
    gz = _pass(_pass(sy, _DERIV, 0), _SMOOTH, 2)
    sq = gx * gx + gy * gy + gz * gz
    pos = sq > 0
    return torch.where(pos, torch.sqrt(torch.where(pos, sq, torch.ones_like(sq))), torch.zeros_like(sq)).sum(1)


def gaussian_taps(sigma: float) -> Tuple[float, ...]:
    ks = int(sigma * 5)
    ks += 1 - ks % 2
    ts = np.linspace(-ks // 2, ks // 2 + 1, ks, dtype=np.float32)
    g = np.exp(-((ts / sigma) ** 2) / 2.0)
    return tuple((g / g.sum()).tolist())


def blur(v: torch.Tensor, sigma: float = 2.0) -> torch.Tensor:
    taps = gaussian_taps(sigma)
    for axis in range(3):
        v = _pass(v, taps, axis)
    return v


def _cos(a, b):
    na = torch.clamp_min(torch.linalg.vector_norm(a, dim=1), 1e-8)
    nb = torch.clamp_min(torch.linalg.vector_norm(b, dim=1), 1e-8)
    return (a * b).sum(dim=1) / (na * nb)


def mae_loss(out, view1, cfg, objective) -> torch.Tensor:
    """The composite loss: masked reconstruction + edge weight x edge term
    + contrastive weight x negative cosine (perceptual weight 0)."""
    p = cfg["patch_size"]
    pred_vol = unpatchify(out["pred"], p)
    b, s = view1.shape[0], view1.shape[-1]
    g = s // p
    m = out["mask"].reshape(b, 1, g, 1, g, 1, g, 1).expand(b, 1, g, p, g, p, g, p).reshape(b, 1, s, s, s)
    recon = (((pred_vol - view1) ** 2) * m).sum() / (out["mask"].sum() * p ** 3 * pred_vol.shape[1])
    edge = ((sobel(pred_vol) - sobel(blur(view1))) ** 2).mean()
    total = recon + objective["edge_map_weight"] * edge
    if "p1" in out and objective["contr_weight"]:
        contr = -(_cos(out["p1"], out["z2"]).mean() + _cos(out["p2"], out["z1"]).mean()) * 0.5
        total = total + objective["contr_weight"] * contr
    return total


# ---------------------------------------------------------------- AdamW

class AdamW:
    """AdamW with decoupled decay (p <- p - lr (m_hat / (sqrt(v_hat) + eps)
    + wd p)) on every tensor of more than one dimension, none on the rest."""

    def __init__(self, params: Dict[str, torch.Tensor], lr, b1, b2, eps, weight_decay):
        self.params, self.lr, self.b1, self.b2, self.eps, self.wd = params, lr, b1, b2, eps, weight_decay
        self.m = {n: torch.zeros_like(p) for n, p in params.items()}
        self.v = {n: torch.zeros_like(p) for n, p in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor]) -> None:
        self.t += 1
        c1, c2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        for n, p in self.params.items():
            g = grads[n]
            self.m[n].mul_(self.b1).add_(g, alpha=1 - self.b1)
            self.v[n].mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            upd = (self.m[n] / c1) / ((self.v[n] / c2).sqrt() + self.eps)
            if p.ndim > 1:
                upd = upd + self.wd * p
            p.sub_(self.lr * upd)


def part_norms(named) -> Dict[str, float]:
    """The norm of each leaf, a fused qkv weight or bias counted as its
    three projections (`name[q]`, `name[k]`, `name[v]`), so that the key's
    bias, whose gradient is nought under softmax, is a leaf of its own."""
    out = {}
    for name, t in named:
        t = t.detach()
        if name.endswith(("qkv.weight", "qkv.bias")):
            for part, piece in zip("qkv", t.chunk(3, dim=0)):
                out[f"{name}[{part}]"] = float(piece.norm())
        else:
            out[name] = float(t.norm())
    return out


def train_readings(cfg: dict, params: Dict[str, torch.Tensor], batches: List[dict], lr: float,
                   precision: str = "f32") -> dict:
    """Train `params` (modified in place) for len(batches) steps; returns
    each step's 'losses', 'grad_norms' (each leaf's norm of the first
    step's gradient) and 'change_norms' (each leaf's norm of its change
    over all the steps), leaves as `part_norms` counts them. TF32 is off
    while it runs."""
    obj, opt = cfg["objective"], cfg["optimizer"]
    start = {n: p.detach().clone() for n, p in params.items()}
    for p in params.values():
        p.requires_grad_(True)
    adam = AdamW(params, lr, opt["b1"], opt["b2"], opt["eps"], opt["weight_decay"])
    cuda = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    losses, grad_norms = [], None
    try:
        for batch in batches:
            out = mae_forward(params, cfg, batch["view1"], batch.get("view2"), batch["noise"], precision)
            loss = mae_loss(out, batch["view1"], cfg, obj)
            grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
            if grad_norms is None:
                grad_norms = part_norms(grads.items())
            losses.append(float(loss.detach()))
            adam.step(grads)
            del out, loss, grads
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = cuda
    change = part_norms((n, p.detach() - start[n]) for n, p in params.items())
    return {"losses": losses, "grad_norms": grad_norms, "change_norms": change}

