"""Command-line interface of the port.

    python -m vit_ae_plus_plus_torch.cli serve --checkpoint mae.pth [...]
    python -m vit_ae_plus_plus_torch.cli prepare-data brats --volumes flair_all.npy \
        --labels label_all.npy --out-dir splits
    python -m vit_ae_plus_plus_torch.cli prepare-data egd --csv rad.csv \
        --scans-root pre_processed --out-dir splits

`serve` and `prepare-data` are ported so far. The checkpoint of `serve` is
a reference-layout `.pth`, as the JAX package's `export-torch` writes it;
it runs on `cuda` unless `--device cpu` is given. `prepare-data` runs on
the host and writes the same split files as the JAX package's command.
"""

from __future__ import annotations

import argparse
import os
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

    prep = sub.add_parser(
        "prepare-data",
        help="one-time split bootstrap (data/splits.py): BraTS x/y_{train,val,"
             "test,whole}_ssl.npy, or the EGD split lists")
    prep.add_argument("kind", choices=["brats", "egd"])
    prep.add_argument("--volumes", help="brats: flair_all.npy")
    prep.add_argument("--labels", help="brats: label_all.npy")
    prep.add_argument("--nifti-dir", help="ingest raw NIfTI instead of npy: "
                      "brats: a directory of .nii/.nii.gz scans (replaces "
                      "--volumes/--labels); egd: per-scan dirs holding "
                      "{flair,t1ce,t1,t2}.nii[.gz] (replaces --scans-root)")
    prep.add_argument("--labels-csv", help="brats with --nifti-dir: "
                      "name,label rows keyed by the scan file stem")
    prep.add_argument("--csv", help="egd: radiologist csv")
    prep.add_argument("--scans-root", help="egd: pre_processed dir")
    prep.add_argument("--out-dir", required=True)
    prep.add_argument("--overwrite", action="store_true")
    return parser


def prepare_data(args) -> None:
    """The `prepare-data` subcommand's body (the JAX package's, unchanged)."""
    from vit_ae_plus_plus_torch.data import splits as S

    if args.kind == "brats":
        volumes, labels = args.volumes, args.labels
        if args.nifti_dir:
            if not args.labels_csv:
                raise SystemExit("--nifti-dir needs --labels-csv")
            volumes, labels = S.ingest_nifti_volumes(
                args.nifti_dir, args.labels_csv, args.out_dir,
                overwrite=args.overwrite,
            )
        S.split_brats_data(volumes, labels, args.out_dir, args.overwrite)
    else:
        if not args.csv:
            raise SystemExit("prepare-data egd needs --csv (radiologist labels)")
        scans_root = args.scans_root
        if args.nifti_dir:
            scans_root = os.path.join(args.out_dir, "scans")
            S.convert_egd_nifti_scans(args.nifti_dir, scans_root)
        S.prepare_egd_splits(args.csv, scans_root, args.out_dir,
                             "who_idh_mutation_status")
        S.prepare_egd_splits(args.csv, scans_root, args.out_dir,
                             "who_1p19q_codeletion")
        S.refine_1p19q_scans(args.out_dir)


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
    elif args.cmd == "prepare-data":
        prepare_data(args)
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
