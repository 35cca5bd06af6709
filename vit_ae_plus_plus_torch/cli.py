"""Command-line interface of the port.

    python -m vit_ae_plus_plus_torch.cli serve --checkpoint mae.pth [...]
    python -m vit_ae_plus_plus_torch.cli prepare-data brats --volumes flair_all.npy \
        --labels label_all.npy --out-dir splits
    python -m vit_ae_plus_plus_torch.cli prepare-data egd --csv rad.csv \
        --scans-root pre_processed --out-dir splits
    python -m vit_ae_plus_plus_torch.cli pretrain-kfold --data-path splits \
        --work-dir run1 [--config config.ini] [...]

`serve`, `prepare-data` and `pretrain-kfold` are ported so far. The
checkpoint of `serve` is a reference-layout `.pth`, as the JAX package's
`export-torch` and this package's `pretrain-kfold` write it. `serve` and
`pretrain-kfold` run on `cuda` unless `--device cpu` is given.
`prepare-data` runs on the host and writes the same split files as the JAX
package's command. `pretrain-kfold` takes the JAX command's flags and, as
there, `--config` loads a config.ini section over them (configs/ini.py);
it prints its per-fold results as one JSON line last.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
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

    pre = sub.add_parser(
        "pretrain-kfold",
        help="k-fold MAE pretraining and per-fold SSL feature extraction "
             "(pipelines/pretrain_kfold.py)")
    _add_common(pre)
    pre.add_argument("--pipe-devices", type=int, default=1,
                     help="GPipe pipeline stages (not ported yet: > 1 is refused)")
    pre.add_argument("--pp-microbatches", type=int, default=None,
                     help="GPipe microbatches (not ported yet)")
    pre.add_argument("--fsdp", action="store_true",
                     help="ZeRO/FSDP (not ported yet: refused)")
    pre.add_argument("--device", default=None,
                     help="torch device (default: cuda; 'cpu' to run on the CPU)")
    return parser


def _add_common(p: argparse.ArgumentParser) -> None:
    """The JAX command's common flags, with its defaults."""
    p.add_argument("--config", default=None, help="config.ini path (overrides CLI)")
    p.add_argument("--config-key", default="K_FOLD", help="INI section for this run")
    p.add_argument("--dataset", default="brats", choices=["brats", "egd"])
    p.add_argument("--data-path", default="", help="root of prepared split arrays")
    p.add_argument("--work-dir", default="output_dir/run")
    p.add_argument("--volume-size", type=int, default=96)
    p.add_argument("--in-channels", type=int, default=1)
    p.add_argument("--num-classes", type=int, default=2)
    p.add_argument("--batch-size", type=int, default=4)
    p.add_argument("--epochs", type=int, default=50)
    p.add_argument("--patch-size", type=int, default=8)
    p.add_argument("--use-z-score", action=argparse.BooleanOptionalAction,
                   default=True, help="--no-use-z-score selects min-max [-1,1]")
    p.add_argument("--compute-dtype", default="bfloat16", choices=["float32", "bfloat16"])
    p.add_argument("--loss-filters-dtype", default="float32",
                   choices=["float32", "bfloat16"],
                   help="opt-in bfloat16 runs the edge-loss Sobel/blur filters in bf16")
    p.add_argument("--ln-dtype", default="float32", choices=["float32", "bfloat16"],
                   help="opt-in bf16 block-LN statistics")
    p.add_argument("--model", default="contr_mae_vit_base_patch16")
    p.add_argument("--n-splits", type=int, default=5)
    p.add_argument("--n-devices", type=int, default=None,
                   help="data-parallel devices (not ported yet: > 1 is refused)")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--device-augment", action="store_true",
                   help="augmentation on the card (not ported yet: refused)")
    p.add_argument("--device-data", action="store_true",
                   help="the whole raw fold on the card (not ported yet: refused)")
    p.add_argument("--resume", action="store_true",
                   help="resume folds from their resume checkpoints")
    p.add_argument("--ckpt-every", type=int, default=1,
                   help="flush the min-loss and resume checkpoints every N epochs "
                        "(the interim best is kept on the device)")
    p.add_argument("--profile-dir", default=None,
                   help="torch.profiler trace dir (one steady epoch, Chrome JSON)")
    p.add_argument("--perceptual-weight", type=float, default=0.0)
    p.add_argument("--vgg-ckpt", default=None, help="torch VGG16 weights")


def configs_from_args(args) -> tuple:
    """(DataConfig, TrainConfig) from the parsed flags, as the JAX command
    builds them; with `--config`, the INI's sections override the training
    hyperparameters and the flags still give the execution options."""
    from vit_ae_plus_plus_torch.configs import DataConfig, TrainConfig

    if args.config:
        from vit_ae_plus_plus_torch.configs.ini import bootstrap

        data_cfg, train_cfg, extras = bootstrap(args.config, args.config_key)
        data_cfg = dataclasses.replace(data_cfg, base_path=args.data_path or data_cfg.base_path)
        train_cfg = dataclasses.replace(
            train_cfg,
            compute_dtype=args.compute_dtype,
            patch_size=extras.get("patch_size", args.patch_size),
            seed=args.seed,
            device_augment=args.device_augment or args.device_data,
            device_data=args.device_data,
            resume=args.resume,
            ckpt_every=args.ckpt_every,
            profile_dir=args.profile_dir,
            vgg_ckpt=args.vgg_ckpt,
            loss_filters_dtype=args.loss_filters_dtype,
            ln_dtype=args.ln_dtype,
            pipe_devices=args.pipe_devices,
            pp_microbatches=args.pp_microbatches,
            fsdp=args.fsdp,
        )
        return data_cfg, train_cfg
    data_cfg = DataConfig(
        name=args.dataset, base_path=args.data_path, volume_size=args.volume_size,
        in_channels=args.in_channels, num_classes=args.num_classes,
        use_z_score=args.use_z_score,
    )
    train_cfg = TrainConfig(
        epochs=args.epochs, batch_size=args.batch_size, seed=args.seed,
        patch_size=args.patch_size, compute_dtype=args.compute_dtype,
        device_augment=args.device_augment or args.device_data,
        device_data=args.device_data,
        resume=args.resume,
        ckpt_every=args.ckpt_every,
        profile_dir=args.profile_dir,
        perceptual_weight=args.perceptual_weight,
        vgg_ckpt=args.vgg_ckpt,
        loss_filters_dtype=args.loss_filters_dtype,
        ln_dtype=args.ln_dtype,
        pipe_devices=args.pipe_devices,
        pp_microbatches=args.pp_microbatches,
        fsdp=args.fsdp,
    )
    return data_cfg, train_cfg


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
    elif args.cmd == "pretrain-kfold":
        from vit_ae_plus_plus_torch.pipelines.pretrain_kfold import pretrain_kfold

        data_cfg, train_cfg = configs_from_args(args)
        out = pretrain_kfold(data_cfg, train_cfg, args.work_dir, model_name=args.model,
                             n_splits=args.n_splits, n_devices=args.n_devices,
                             device=args.device)
        print(json.dumps(out, default=str))
    return 0


def run(argv=None) -> int:
    """Console entry with friendly error reporting: exit 2 on a bad input, a
    refused setting, a missing card or a work dir locked by another run
    (`WorkdirLockedError` and `NotImplementedError` are `RuntimeError`s)."""
    try:
        return main(argv)
    except (FileNotFoundError, FileExistsError, KeyError, ValueError, RuntimeError) as e:
        print(f"error: {type(e).__name__}: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(run())
