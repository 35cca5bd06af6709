"""Command-line interface of the port.

    python -m vit_ae_plus_plus_torch.cli serve --checkpoint mae.pth [...]

Only `serve` is ported so far. Its checkpoint is a reference-layout `.pth`,
as the JAX package's `export-torch` writes it. It runs on `cuda` unless
`--device cpu` is given.
"""

from __future__ import annotations

import argparse
import sys


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="vit_ae_plus_plus_torch.cli")
    sub = parser.add_subparsers(dest="cmd", required=True)

    srv = sub.add_parser(
        "serve",
        help="dynamic-batching HTTP feature-inference server (serving.py): "
             "POST /features with .npy volumes, GET /healthz, GET /stats")
    srv.add_argument("--checkpoint", required=True,
                     help="reference-layout MAE state dict (.pth), as "
                          "`vit_ae_plus_plus_tpu.cli export-torch` writes it")
    srv.add_argument("--model", default="contr_mae_vit_base_patch16")
    srv.add_argument("--volume-size", type=int, default=96)
    srv.add_argument("--in-channels", type=int, default=1)
    srv.add_argument("--patch-size", type=int, default=8)
    srv.add_argument("--batch-size", type=int, default=8,
                     help="serving slab size (requests are dynamic-batched "
                          "and padded to it)")
    srv.add_argument("--compute-dtype", default="bfloat16",
                     choices=["float32", "bfloat16"])
    srv.add_argument("--normalize", default="none", choices=["none", "zscore"],
                     help="zscore: per-channel z-score each request volume")
    srv.add_argument("--max-wait-ms", type=float, default=5.0,
                     help="dynamic-batching gather window")
    srv.add_argument("--max-body-mb", type=int, default=1024,
                     help="reject request bodies over this size with HTTP 413")
    srv.add_argument("--device", default=None,
                     help="torch device (default: cuda; 'cpu' to run on the CPU)")
    srv.add_argument("--host", default="127.0.0.1")
    srv.add_argument("--port", type=int, default=8000)
    return parser


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.cmd == "serve":
        from vit_ae_plus_plus_torch.serving import serve

        serve(
            args.checkpoint, model_name=args.model,
            volume_size=args.volume_size, in_chans=args.in_channels,
            patch_size=args.patch_size, batch_size=args.batch_size,
            compute_dtype=args.compute_dtype, normalize=args.normalize,
            max_wait_ms=args.max_wait_ms, host=args.host, port=args.port,
            max_body_mb=args.max_body_mb, device=args.device,
        )
    return 0


def run() -> int:
    """Console entry with friendly error reporting."""
    try:
        return main()
    except (FileNotFoundError, KeyError, ValueError, RuntimeError) as e:
        print(f"error: {type(e).__name__}: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(run())
