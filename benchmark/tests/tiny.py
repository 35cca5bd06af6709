"""A copy of the benchmark with each cell cut to a size a CPU test can run:
the tiny preset's widths at 16^3 / p4, a batch of 4."""

import json
import shutil
from pathlib import Path

from benchmark.core import registry

TINY = {"vitae_b_96p8": ("contr_mae_vit_tiny_patch4", dict(
            volume_size=16, patch_size=4, embed_dim=24, depth=2, num_heads=3,
            decoder_embed_dim=12, decoder_depth=1, decoder_num_heads=2)),
        "mae_l_96p8": ("mae_vit_tiny_patch4", dict(
            volume_size=16, patch_size=4, embed_dim=24, depth=2, num_heads=3,
            decoder_embed_dim=12, decoder_depth=1, decoder_num_heads=2))}


def tiny_root(dst: Path) -> Path:
    """A benchmark directory at `dst` whose every cell runs at the tiny size
    under its own name, with its own limits."""
    root = Path(dst) / "benchmark"
    shutil.copytree(registry.ROOT, root, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    for name, (preset, widths) in TINY.items():
        path = root / "configs" / f"{name}.json"
        cfg = dict(json.loads(path.read_text()), preset=preset, **widths)
        path.write_text(json.dumps(cfg))
    for name in registry.workload_names(root):
        path = root / "workloads" / f"{name}.json"
        wl = json.loads(path.read_text())
        wl["traffic"].update(batch=4, profile_steps=2)
        path.write_text(json.dumps(wl))
    return root
