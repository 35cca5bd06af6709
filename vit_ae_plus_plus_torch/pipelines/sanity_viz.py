"""Reconstruction sanity checks and visualisations.

The port's copy of the JAX package's pipelines/sanity_viz.py. Parity
targets:
- visualization/sanity_checks.py:23-263: run the MAE on test volumes, report
  the pred/gt nonzero fractions, unpatchify the binary mask to voxel space,
  save per-slice PNG stacks (original / masked / reconstruction / paste
  composite, masked regions tinted);
- visualization/visualizations.py:37-68: one sample's masked /
  reconstruction / paste volumes as NIfTI;
- visualization/custom_operation_checks.py:16-57: the patchify/unpatchify
  round trip and the Sobel / blur images for TensorBoard.

`reconstruct` runs one MAE pass on the model's device (the card unless the
model was built on the CPU); the PNG writers need matplotlib and raise an
`ImportError` that names it where it is missing, as the JAX package's do.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch

from vit_ae_plus_plus_torch.ops import patchify, unpatchify


def require_matplotlib():
    """matplotlib, or an ImportError that names it."""
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError("matplotlib is needed for the PNG output of sanity-viz and explore-data "
                          "(pip install matplotlib)") from e
    return matplotlib


def _pyplot(headless: bool = True):
    """matplotlib's pyplot (Agg when `headless`), or an ImportError that
    names matplotlib."""
    matplotlib = require_matplotlib()
    if headless:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


@torch.no_grad()
def reconstruct(model, volume: np.ndarray, mask_ratio: float = 0.75, seed: int = 0,
                noise: Optional[torch.Tensor] = None) -> Dict[str, np.ndarray]:
    """One MAE pass -> original / masked / reconstruction / paste / mask
    volumes (B, C, S, S, S) as float32 numpy.

    `masked`: the original with removed patches zeroed; `paste`: the
    reconstruction in removed patches, the original elsewhere
    (sanity_checks.py:82-108). The masking noise (B, L) is drawn from a
    `torch.Generator` seeded with `seed` on the model's device, unless
    `noise` is given."""
    p = model.cfg.patch_size
    dev = next(model.parameters()).device
    x = torch.as_tensor(np.asarray(volume, np.float32), device=dev)
    gen = None
    if noise is None:
        gen = torch.Generator(device=dev).manual_seed(seed)
    else:
        noise = torch.as_tensor(noise, device=dev)
    model.eval()
    out = model(x, None, mask_ratio=mask_ratio, noise=noise, generator=gen)
    pred_vol = unpatchify(out["pred"].float(), p)
    mask = out["mask"].float()
    mask_vox = unpatchify(mask[:, :, None].repeat(1, 1, p ** 3 * model.cfg.in_chans), p)
    masked = x * (1 - mask_vox)
    paste = pred_vol * mask_vox + x * (1 - mask_vox)
    return {
        "original": x.cpu().numpy(),
        "reconstruction": pred_vol.cpu().numpy(),
        "masked": masked.cpu().numpy(),
        "paste": paste.cpu().numpy(),
        "mask": mask_vox.cpu().numpy(),
    }


def nonzero_fractions(recon: Dict[str, np.ndarray], threshold: float = 1e-6) -> Dict[str, float]:
    """Pred/gt nonzero-voxel fractions (sanity_checks.py:110-111)."""
    return {
        "pred_nonzero_frac": float((np.abs(recon["reconstruction"]) > threshold).mean()),
        "gt_nonzero_frac": float((np.abs(recon["original"]) > threshold).mean()),
    }


def save_slice_pngs(recon: Dict[str, np.ndarray], out_dir: str, sample_idx: int = 0,
                    axis: int = 0, stride: int = 8) -> int:
    """Per-slice PNG stack with the masked region tinted blue
    (sanity_checks.py:30-72) -> the number of slices written."""
    plt = _pyplot()
    os.makedirs(out_dir, exist_ok=True)
    vol = recon["original"][sample_idx, 0]
    rec = recon["reconstruction"][sample_idx, 0]
    paste = recon["paste"][sample_idx, 0]
    mask = recon["mask"][sample_idx, 0]
    n = 0
    for z in range(0, vol.shape[axis], stride):
        sl = [slice(None)] * 3
        sl[axis] = z
        sl = tuple(sl)
        fig, axes = plt.subplots(1, 4, figsize=(12, 3))
        for ax, (title, img) in zip(
            axes,
            [("original", vol[sl]), ("masked", vol[sl] * (1 - mask[sl])),
             ("reconstruction", rec[sl]), ("paste", paste[sl])],
        ):
            ax.imshow(img, cmap="gray")
            if title == "masked":
                overlay = np.zeros((*mask[sl].shape, 4))
                overlay[..., 2] = 1.0
                overlay[..., 3] = 0.35 * mask[sl]
                ax.imshow(overlay)
            ax.set_title(title)
            ax.axis("off")
        fig.savefig(os.path.join(out_dir, f"sample{sample_idx}_slice{z:03d}.png"),
                    bbox_inches="tight", dpi=80)
        plt.close(fig)
        n += 1
    return n


def save_nifti(recon: Dict[str, np.ndarray], out_dir: str, sample_idx: int = 0) -> bool:
    """Original / masked / reconstruction / paste as .nii.gz
    (visualizations.py:37-68): through nibabel where it is installed, else
    the port's NIfTI-1 writer (utils/nifti.py); never skipped."""
    os.makedirs(out_dir, exist_ok=True)
    names = ("original", "masked", "reconstruction", "paste")
    try:
        import nibabel as nib
    except ImportError:
        from vit_ae_plus_plus_torch.utils.nifti import write_nifti

        for name in names:
            write_nifti(os.path.join(out_dir, f"{name}_{sample_idx}.nii.gz"), recon[name][sample_idx, 0])
        return True
    for name in names:
        img = nib.Nifti1Image(recon[name][sample_idx, 0], affine=np.eye(4))
        nib.save(img, os.path.join(out_dir, f"{name}_{sample_idx}.nii.gz"))
    return True


def check_patchify_roundtrip(volume: np.ndarray, patch_size: int) -> bool:
    """custom_operation_checks.py:16-36."""
    v = torch.as_tensor(np.asarray(volume))
    return bool(torch.allclose(unpatchify(patchify(v, patch_size), patch_size), v))


def op_check_images(volume: np.ndarray, tb_log_dir: str, z: Optional[int] = None) -> None:
    """Sobel / blur visual inspection to TensorBoard
    (custom_operation_checks.py:39-52): the volume's centre slice, its blur
    and its edge map as one image grid, on the host."""
    from vit_ae_plus_plus_torch.ops import gaussian_blur_3d, sobel_edges_3d
    from vit_ae_plus_plus_torch.train.metrics import TBWriter

    vol = torch.as_tensor(np.asarray(volume))
    vol = vol[None] if vol.ndim == 4 else vol
    z = z if z is not None else vol.shape[2] // 2
    with torch.no_grad():
        blur = gaussian_blur_3d(vol, 2.0)
        edges = sobel_edges_3d(vol)[:, None]
    imgs = []
    for img in (vol[:, :1], blur[:, :1], edges):
        sl = img[0, 0, z].numpy()
        rng = sl.max() - sl.min()
        imgs.append(((sl - sl.min()) / (rng if rng else 1.0))[None])
    writer = TBWriter(tb_log_dir)
    writer.images(np.stack(imgs), tag="op_checks")
    writer.close()


def plot_one_slice(volumes_path: str, out_path: Optional[str] = None,
                   sample_idx: int = 0, seed: int = 0) -> np.ndarray:
    """BraTS data-exploration demo (reference dataset/brats_dataset/
    data_exploration.py:9-28): load the raw volume store, augment one sample
    with the demo policy (affine + blur + noise(0.5) + gamma) drawn from
    numpy's `default_rng(seed)`, and plot the centre slice; a PNG when
    `out_path` is given, else an interactive window. Returns the slice."""
    from vit_ae_plus_plus_torch.data.transforms import (
        Compose, RandomAffine3D, RandomBlur, RandomGamma, RandomNoise,
    )

    data = np.load(volumes_path, mmap_mode="r")
    print(f"Original shape {data.shape}")
    vol = np.asarray(data[sample_idx]).transpose(3, 0, 1, 2)  # (C, D, H, W)
    policy = Compose([RandomAffine3D(), RandomBlur(), RandomNoise(std=0.5),
                      RandomGamma(log_gamma=(-0.3, 0.3))])
    vol = policy(vol, np.random.default_rng(seed))
    one_slice = vol[0, vol.shape[1] // 2]
    plt = _pyplot(headless=bool(out_path))
    plt.imshow(one_slice)
    if out_path:
        os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
        plt.savefig(out_path)
        plt.close()
    else:
        plt.show()
    return one_slice
