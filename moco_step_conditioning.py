#!/usr/bin/env python3
"""How far the full-width MoCo-ViT step moves on its own, on one NVIDIA GPU.

    python3 moco_step_conditioning.py [READINGS.json]

Run from the root of a checkout. It builds the CUDA kernels, then takes
`chip_smoke.py`'s MoCo-ViT step (ViT-B at 96^3 / patch 8, heads 4096 / 256,
batch 8, seeded weights through `params_from_jax`) in two momentum
encoders: a copy of the base encoder (the state `moco-kfold` starts from)
and another seeded tree. For each, in bf16 and in f32, it runs one step
with attn_impl="plain" and compares against it:

- the same step with the packed attention kernels ("auto");
- the plain step on the views scaled by 1 + 2^-20 and by 1 - 2^-20 (how far
  a change in the last bits carries through the step: the floor);
- in f32, the plain step with TF32 allowed in every f32 product (a control
  whose products are about 1e-3 off);
- in bf16, both the plain step and the kernels' against the f32 plain step
  (how far bf16 itself is from f32).

Each quantity of `chip_smoke.MoCoTrainer.run` (the loss, three gradients,
five running statistics, two momentum-encoder leaves after the EMA) is read
two ways: its largest error over its largest magnitude (`max`, the metric of
chip_smoke's gates) and the norm of its error over its norm (`norm`). Prints
one line per comparison and writes every reading, as one JSON object, to
READINGS.json when it is given. Exits 1 without a CUDA device.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent


def norm_errs(got: dict, want: dict) -> dict:
    """The loss over its magnitude; every tensor's error norm over its norm."""
    errs = {"loss": abs(got["loss"] - want["loss"]) / abs(want["loss"])}
    for n in want:
        if n != "loss":
            errs[n] = float((got[n] - want[n]).norm() / want[n].norm().clamp_min(1e-30))
    return errs


def short(name: str) -> str:
    return name if name == "loss" else ".".join(name.split(".")[-3:])


def main(argv) -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("moco_step_conditioning: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    import chip_smoke as cs
    from vit_ae_plus_plus_torch.kernels import _build
    from vit_ae_plus_plus_torch.train.checkpoint import params_from_jax

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = cs.card_line()
    t0 = time.perf_counter()
    _build.build()
    print(f"{card}; kernels built in {time.perf_counter() - t0:.1f}s", flush=True)
    base, other = (params_from_jax(tree, cs.PATCH, 1, stats)
                   for tree, stats in (cs.moco_tree(81), cs.moco_tree(82)))
    rng = np.random.default_rng(83)
    views = [torch.from_numpy(rng.standard_normal((cs.BATCH, 1, cs.VOLUME, cs.VOLUME, cs.VOLUME),
                                                  dtype=np.float32)).cuda() for _ in range(2)]
    readings = {}

    def step(mom, dtype, impl="plain", scale=1.0, tf32=False):
        torch.backends.cuda.matmul.allow_tf32 = tf32
        try:
            out, _ = cs.MoCoTrainer(base, dtype, impl, momentum_sd=mom).run(*[v * scale for v in views])
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
        torch.cuda.empty_cache()
        return out

    for mom_name, mom in (("momentum = base", None), ("momentum = another tree", other)):
        plain = {}
        for dtype in ("float32", "bfloat16"):
            plain[dtype] = step(mom, dtype)
            runs = {"kernels": step(mom, dtype, "auto"),
                    "floor +": step(mom, dtype, scale=1 + 2**-20),
                    "floor -": step(mom, dtype, scale=1 - 2**-20)}
            if dtype == "float32":
                runs["TF32 products (control)"] = step(mom, dtype, tf32=True)
            pairs = [(what, got, dtype) for what, got in runs.items()]
            if dtype == "bfloat16":
                pairs += [("the bf16 plain step", plain[dtype], "float32"), ("kernels", runs["kernels"], "float32")]
            for what, got, ref in pairs:
                key = f"{mom_name}, {dtype}, {what} vs the {'f32 ' if ref != dtype else ''}plain step"
                readings[key] = {"max": cs.moco_errs(got, plain[ref]), "norm": norm_errs(got, plain[ref]),
                                 "loss": got["loss"], "plain_loss": plain[ref]["loss"]}
                for metric in ("max", "norm"):
                    print(f"{key} [{metric}]: " + ", ".join(
                        f"{short(k)} {e:.3g}" for k, e in readings[key][metric].items()), flush=True)
            print(f"{mom_name}, {dtype}: plain loss {plain[dtype]['loss']:.6f}", flush=True)
    print(f"moco_step_conditioning ({card}) done in {time.perf_counter() - t0:.1f}s", flush=True)
    if argv:
        Path(argv[0]).parent.mkdir(parents=True, exist_ok=True)
        Path(argv[0]).write_text(json.dumps({"card": card, "readings": readings}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
