"""Command-line interface of the port.

    python -m vit_ae_plus_plus_torch.cli serve --checkpoint mae.pth [--n-devices N] [...]
    python -m vit_ae_plus_plus_torch.cli serve --task classify \
        --checkpoint ft1 [--ensemble-criterion ft] [--quantize int8] [--resize-inputs]
    python -m vit_ae_plus_plus_torch.cli compile-engine --checkpoint mae.pth \
        --out engine.vitae [the engine flags of serve]
    python -m vit_ae_plus_plus_torch.cli serve --engine engine.vitae
    python -m vit_ae_plus_plus_torch.cli prepare-data brats --volumes flair_all.npy \
        --labels label_all.npy --out-dir splits
    python -m vit_ae_plus_plus_torch.cli prepare-data egd --csv rad.csv \
        --scans-root pre_processed --out-dir splits
    python -m vit_ae_plus_plus_torch.cli pretrain-kfold --data-path splits \
        --work-dir run1 [--config config.ini] [...]
    python -m vit_ae_plus_plus_torch.cli extract-features --data-path splits \
        --work-dir feats --checkpoint run1/checkpoints/fold_0/checkpoint-min_loss.pth
    python -m vit_ae_plus_plus_torch.cli probe-kfold --data-path splits \
        --work-dir probe1 --pretrain-dir run1 [--use-mixup] [--eval-only]
    python -m vit_ae_plus_plus_torch.cli finetune-kfold ... (the same flags)
    python -m vit_ae_plus_plus_torch.cli finetune --data-path splits \
        --work-dir ft1 --checkpoint mae.pth [--fix-backbone] [--use-mixup]
    python -m vit_ae_plus_plus_torch.cli eval-classical \
        --feature-dir run1/ssl_features_dir [--n-splits 5] [--method svm|rf|linear]
    python -m vit_ae_plus_plus_torch.cli resnet-kfold --data-path splits \
        --work-dir resnet1 [--eval-only]
    python -m vit_ae_plus_plus_torch.cli moco-kfold --data-path splits \
        --work-dir moco1 [--moco-arch vit|resnet]
    python -m vit_ae_plus_plus_torch.cli moco-extract --data-path splits \
        --work-dir feats --checkpoint moco1 [--fold K]
    python -m vit_ae_plus_plus_torch.cli contrastive-train --data-path splits \
        --work-dir contr1 [--use-proj]
    python -m vit_ae_plus_plus_torch.cli sanity-viz --data-path splits \
        --work-dir viz --checkpoint mae.pth [--num-samples 2]
    python -m vit_ae_plus_plus_torch.cli explore-data --volumes flair_all.npy [--out slice.png]
    python -m vit_ae_plus_plus_torch.cli profile-attrib --trace-dir run1/profile --steps 3 [--json]
    python -m vit_ae_plus_plus_torch.cli export-torch \
        --checkpoint run1/checkpoints/fold_0/resume --out mae.pth
    python -m vit_ae_plus_plus_torch.cli doctor [--device cpu]

Every subcommand of the JAX package's CLI is here. Every ViT checkpoint they
read is a reference-layout `.pth`, as the JAX package's `export-torch` and
this package's `pretrain-kfold` and `export-torch` write it; every
`--checkpoint` also takes an `http://`, `https://` or `file://` URL,
downloaded once into a cache (train/checkpoint.py
`resolve_checkpoint_path`) before any rank is spawned. All but
`prepare-data`, `eval-classical`, `explore-data`, `profile-attrib` and
`export-torch` run on `cuda` unless `--device cpu` is given. `serve` and
`compile-engine` print a note for the non-parity `_fast` / `_fastdec`
presets, as the JAX package does.
`compile-engine` writes the engine `serve` would build to an artifact
(serving_aot.py); `serve --engine` loads it with no graft, no
quantisation and no kernel build, and ignores every other engine flag.
`prepare-data` runs on the host and writes the same split files as the JAX
package's command; `eval-classical` fits the SVM, the random forest or
the logistic regression on the host, through the port's copies of
scikit-learn's libsvm, tree builder, liblinear and logistic regression.
The training and extraction commands take the JAX commands' flags and,
as there, `--config` loads a config.ini section over them
(configs/ini.py); they print their results as one JSON line last.

`--n-devices N` (N > 1) on `pretrain-kfold`, `probe-kfold`,
`finetune-kfold`, `finetune`, `extract-features`, `moco-kfold` and
`contrastive-train` runs the command on N
spawned ranks (`parallel.run_ranks`), each under a data mesh of (N, 1):
NCCL with rank r on `cuda:r`, refused before any spawn when fewer than N
cards are visible, or gloo ranks on the CPU with `--device cpu`. The
batch size stays the global batch and must split into N equal shards.
`serve --n-devices N` serves over a (N, 1) data mesh of N such ranks
(serving.py): rank 0 holds the HTTP front and splits each slab over the
ranks, whose number must divide the batch size, and SIGTERM to the
command reaches rank 0, which drains, stops the others and returns.
`pretrain-kfold --pipe-devices S` runs the GPipe pipeline on N ranks (S
by default) under the ('data', 'pipe') mesh of S stages and N / S data
coordinates (parallel/pp.py); N must be divisible by S, and the batch
splits over the N / S data coordinates.
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
        help="dynamic-batching HTTP inference server (serving.py): "
             "POST /features or /predict with .npy or NIfTI-1 volumes, "
             "GET /healthz, GET /stats")
    _engine_args(srv)
    srv.add_argument("--engine", default=None,
                     help="a compile-engine artifact (serving_aot.py): no graft, no quantisation, no kernel "
                          "build; every other engine flag, --n-devices included, is ignored")
    srv.add_argument("--n-devices", type=int, default=None,
                     help="serve over a (N, 1) data mesh of N ranks, each slab split over them (N must divide "
                          "the batch size): NCCL, one rank per card, or gloo ranks on the CPU with --device cpu")
    srv.add_argument("--max-wait-ms", type=float, default=5.0,
                     help="dynamic-batching gather window")
    srv.add_argument("--max-body-mb", type=int, default=1024,
                     help="reject request bodies over this size with HTTP 413")
    srv.add_argument("--host", default="127.0.0.1")
    srv.add_argument("--port", type=int, default=8000)

    ce = sub.add_parser(
        "compile-engine",
        help="build a serving engine and write it to an artifact (serving_aot.py) that serve --engine loads "
             "without a graft, a quantisation or a kernel build; it is tied to the device and versions it "
             "was built on")
    _engine_args(ce)
    ce.add_argument("--out", required=True, help="the artifact's path")

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
                     help="GPipe pipeline stages over a 'pipe' mesh axis (must divide --n-devices and both "
                          "block-stack depths; parallel/pp.py)")
    pre.add_argument("--pp-microbatches", type=int, default=None,
                     help="GPipe microbatches (default: auto, <= 4*pipe)")
    pre.add_argument("--fsdp", action="store_true",
                     help="ZeRO/FSDP: shard params + optimizer moments 1/data over the 'data' mesh axis "
                          "(parallel/fsdp.py; needs --n-devices > 1)")
    pre.add_argument("--device", default=None,
                     help="torch device (default: cuda; 'cpu' to run on the CPU)")

    helps = {
        "extract-features": "SSL features of a pretrained MAE checkpoint "
                            "(pipelines/extract_features.py)",
        "probe-kfold": "k-fold linear probe on pretrain-kfold's fold checkpoints "
                       "(pipelines/probe_kfold.py)",
        "finetune-kfold": "k-fold fine-tune on pretrain-kfold's fold checkpoints "
                          "(pipelines/probe_kfold.py)",
        "finetune": "single-run fine-tune over the train/val/test splits "
                    "(pipelines/finetune.py)",
        "resnet-kfold": "supervised 3D-ResNet k-fold baseline (pipelines/resnet_kfold.py)",
        "moco-kfold": "MoCo-v3 k-fold pretraining and per-fold trunk features (pipelines/moco_kfold.py)",
        "moco-extract": "trunk features of MoCo checkpoints without training (pipelines/moco_kfold.py)",
        "contrastive-train": "two-view contrastive ViT training, negative cosine loss (pipelines/contrastive.py)",
        "sanity-viz": "MAE reconstructions of test volumes: nonzero fractions and per-slice PNGs "
                      "(pipelines/sanity_viz.py; needs matplotlib)",
    }
    for name, text in helps.items():
        p = sub.add_parser(name, help=text)
        _add_common(p)
        if name in ("probe-kfold", "finetune-kfold"):
            p.add_argument("--pretrain-dir", required=True,
                           help="pretrain-kfold's work dir (checkpoints/fold_k/checkpoint-min_loss.pth)")
            p.add_argument("--use-mixup", action="store_true")
            p.add_argument("--eval-only", action="store_true")
        if name == "resnet-kfold":
            p.add_argument("--eval-only", action="store_true")
        if name == "finetune":
            p.add_argument("--checkpoint", required=True, help="MAE checkpoint (.pth)")
            p.add_argument("--fix-backbone", action="store_true")
            p.add_argument("--use-mixup", action="store_true")
            p.add_argument("--eval-only", action="store_true")
        if name == "moco-kfold":
            p.add_argument("--fsdp", action="store_true",
                           help="shard both MoCo encoders + LARS moments 1/data over the mesh "
                                "(parallel/fsdp.py; needs --n-devices > 1)")
        if name in ("moco-kfold", "moco-extract"):
            p.add_argument("--moco-arch", default="vit", choices=["vit", "resnet"],
                           help="MoCo trunk (reference builder.py:101-124)")
            p.add_argument("--resnet-depth", type=int, default=10)
            p.add_argument("--moco-dim", type=int, default=256)
            p.add_argument("--moco-mlp-dim", type=int, default=4096)
        if name == "moco-extract":
            p.add_argument("--checkpoint", required=True,
                           help="a moco-kfold work dir, or one checkpoint (.pth)")
            p.add_argument("--fold", type=int, default=None)
        if name == "contrastive-train":
            p.add_argument("--use-proj", action="store_true",
                           help="apply the 3-layer projector (reference use_proj)")
        if name == "sanity-viz":
            p.add_argument("--checkpoint", required=True, help="MAE checkpoint (reference-layout .pth)")
            p.add_argument("--num-samples", type=int, default=2)
        if name == "extract-features":
            p.add_argument("--checkpoint", required=True, help="MAE checkpoint (.pth)")
            p.add_argument("--only-test-split", action="store_true")
            p.add_argument("--quantize", default="none", choices=["none", "int8"],
                           help="int8: the int8 engine (models/quant.py)")
        p.add_argument("--device", default=None,
                       help="torch device (default: cuda; 'cpu' to run on the CPU)")

    ev = sub.add_parser(
        "eval-classical",
        help="SVM, random forest or logistic regression on pretrain-kfold's per-fold SSL features "
             "(pipelines/eval_classical.py; host only)")
    ev.add_argument("--feature-dir", required=True,
                    help="{train,test}_contrast_ssl_{features,labels}_split_{k}.npy, as pretrain-kfold writes them")
    ev.add_argument("--n-splits", type=int, default=5)
    ev.add_argument("--method", default="svm", choices=["svm", "rf", "linear"],
                    help="svm (SVC), rf (random forest) or linear (logistic regression)")

    explore = sub.add_parser("explore-data",
                             help="plot one augmented slice (reference dataset/brats_dataset/data_exploration.py; "
                                  "needs matplotlib)")
    explore.add_argument("--volumes", required=True, help="flair_all.npy path")
    explore.add_argument("--out", default=None, help="PNG output (else show)")
    explore.add_argument("--sample", type=int, default=0)

    prof = sub.add_parser(
        "profile-attrib",
        help="step-time attribution table from a torch.profiler trace (utils/profile_tools.py; pair with "
             "pretrain-kfold --profile-dir)")
    prof.add_argument("--trace-dir", required=True, help="the trace directory, or one trace file")
    prof.add_argument("--steps", type=int, default=1, help="steps captured in the trace (divides totals)")
    prof.add_argument("--json", action="store_true", help="machine-readable output")

    exp = sub.add_parser(
        "export-torch",
        help="write the port's MAE checkpoint as one strict reference-layout torch .pth state_dict (what the "
             "reference's model/vit_autoenc.py loads): from a resume checkpoint.pth, a directory of GPipe "
             "checkpoint-stage{p}.pth files, or a reference-layout .pth")
    exp.add_argument("--checkpoint", required=True,
                     help="pretrain-kfold's checkpoints/fold_k/resume (or its checkpoint.pth), the GPipe stage "
                          "files' directory, or a reference-layout .pth; not an orbax directory (the JAX "
                          "package's export-torch reads those)")
    exp.add_argument("--out", required=True, help="output .pth path")
    exp.add_argument("--model", default="contr_mae_vit_base_patch16")
    exp.add_argument("--volume-size", type=int, default=96)
    exp.add_argument("--in-channels", type=int, default=1)
    exp.add_argument("--patch-size", type=int, default=None,
                     help="override the zoo preset's patch size (must match the trained checkpoint)")
    exp.add_argument("--seed", type=int, default=42,
                     help="kept for the JAX command's flags; read by nothing (no template is initialised here)")

    doc = sub.add_parser("doctor",
                         help="environment diagnostics: CUDA device, toolchain, kernel and host libraries, the "
                              "build directory, distributed backends, versions, engine artifacts (utils/doctor.py)")
    doc.add_argument("--device", default=None,
                     help="torch device (default: cuda; 'cpu' to check a machine without a card)")
    return parser


def _engine_args(p: argparse.ArgumentParser) -> None:
    """The engine flags of `serve` and `compile-engine`."""
    p.add_argument("--checkpoint", default=None,
                   help="--task features: a reference-layout MAE state dict "
                        "(.pth), as pretrain-kfold or `vit_ae_plus_plus_tpu.cli "
                        "export-torch` writes it; --task classify: fine-tuned "
                        "classifier .pth file(s), comma-separated, or a "
                        "finetune-kfold work dir (fold ensemble)")
    p.add_argument("--task", default="features", choices=["features", "classify"],
                   help="features: SSL features from an MAE checkpoint; "
                        "classify: the fold-mean softmax of fine-tuned "
                        "classifier checkpoints")
    p.add_argument("--num-classes", type=int, default=2)
    p.add_argument("--ensemble-criterion", default="ft", choices=["ft", "spec", "sens"],
                   help="which per-fold best model to ensemble when "
                        "--checkpoint is a finetune-kfold work dir")
    p.add_argument("--model", default="contr_mae_vit_base_patch16")
    p.add_argument("--volume-size", type=int, default=96)
    p.add_argument("--in-channels", type=int, default=1)
    p.add_argument("--patch-size", type=int, default=8)
    p.add_argument("--batch-size", type=int, default=8,
                   help="serving slab size (requests are dynamic-batched "
                        "and padded to it)")
    p.add_argument("--compute-dtype", default="bfloat16",
                   choices=["float32", "bfloat16"])
    p.add_argument("--quantize", default="none", choices=["none", "int8"],
                   help="int8: the trunk's Dense products on int8 operands "
                        "(models/quant.py)")
    p.add_argument("--normalize", default="none", choices=["none", "zscore"],
                   help="zscore: per-channel z-score each request volume")
    p.add_argument("--resize-inputs", action="store_true",
                   help="trilinear-resample mismatched spatial dims to "
                        "the model's volume size instead of rejecting")
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda; 'cpu' to run on the CPU)")


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
                   help="data-parallel devices: pretrain-kfold, probe-kfold, finetune-kfold, finetune, "
                        "extract-features, moco-kfold and contrastive-train run on N ranks, one per card "
                        "over NCCL (gloo ranks on the CPU with --device cpu), each on batch-size / N rows "
                        "of every batch; resnet-kfold refuses N > 1")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--device-augment", action="store_true",
                   help="augment and normalise each raw batch on the card (pretrain-kfold)")
    p.add_argument("--device-data", action="store_true",
                   help="hold the fold's raw volumes on the card (implies --device-augment)")
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
            pipe_devices=getattr(args, "pipe_devices", 1),
            pp_microbatches=getattr(args, "pp_microbatches", None),
            fsdp=getattr(args, "fsdp", False),
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
        pipe_devices=getattr(args, "pipe_devices", 1),
        pp_microbatches=getattr(args, "pp_microbatches", None),
        fsdp=getattr(args, "fsdp", False),
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


DATA_PARALLEL = ("pretrain-kfold", "probe-kfold", "finetune-kfold", "finetune", "extract-features", "moco-kfold",
                 "contrastive-train")


def warn_fast_preset(model_name) -> None:
    """The `_fast` / `_fastdec` presets are opt-in NON-PARITY presets
    (another attention partition at the same parameter shapes,
    models/zoo.py): they serve only checkpoints trained under the same
    preset; a parity-trained checkpoint loads but computes another
    function."""
    if model_name and model_name.endswith(("_fast", "_fastdec")):
        print(
            f"note: {model_name!r} is an opt-in non-parity preset; serve it "
            "only with checkpoints trained under this same preset "
            "(parity-trained checkpoints are shape-compatible but NOT "
            "function-compatible)",
            file=sys.stderr,
        )


def _engine_model_name(path: str):
    """The preset an engine artifact was built from (its meta.json's
    config), or None where the file cannot be read: `load_engine` reports
    that properly."""
    import zipfile

    try:
        with zipfile.ZipFile(path) as zf:
            meta = json.loads(zf.read("meta.json"))
        return meta["config"]["model_name"]
    except Exception:
        return None


def resolve_checkpoints(args, argv: list) -> list:
    """Resolve a `--checkpoint` URL (each element of `serve`'s and
    `compile-engine`'s comma list) to its cached local file, once, in this
    process: `args.checkpoint` and the returned argv, which the spawned
    ranks parse, then name the local file."""
    from vit_ae_plus_plus_torch.train.checkpoint import resolve_checkpoint_path

    given = getattr(args, "checkpoint", None)
    if not given:
        return argv
    if args.cmd in ("serve", "compile-engine"):
        local = ",".join(resolve_checkpoint_path(c) for c in given.split(","))
    else:
        local = resolve_checkpoint_path(given)
    if local == given:
        return argv
    args.checkpoint = local
    argv = list(argv)
    for i, a in enumerate(argv):
        if a == "--checkpoint" and i + 1 < len(argv) and argv[i + 1] == given:
            argv[i + 1] = local
        elif a == f"--checkpoint={given}":
            argv[i] = f"--checkpoint={local}"
    return argv


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    args = build_parser().parse_args(argv)
    if args.cmd == "doctor":
        from vit_ae_plus_plus_torch.utils.doctor import run_doctor

        return run_doctor(device=args.device)
    if args.cmd == "serve" and args.engine is not None:
        warn_fast_preset(_engine_model_name(args.engine))
    elif args.cmd in ("serve", "compile-engine") and args.checkpoint is not None:
        warn_fast_preset(args.model)
    argv = resolve_checkpoints(args, argv)
    n = world_size(args)
    if n > 1 and args.cmd == "serve" and args.engine is None:
        out = launch_serve(args, argv, n)
    elif n > 1 and args.cmd in DATA_PARALLEL:
        out = launch_ranks(args, argv, n)
    else:
        out = command(args)
    if out is not None:
        print(out if isinstance(out, str) else json.dumps(out, default=str))
    return 0


def world_size(args) -> int:
    """The ranks a command runs on: `--n-devices` (1 without it), or for
    `pretrain-kfold --pipe-devices S` S when `--n-devices` is not given, as
    in the JAX package; a count S does not divide raises before any
    spawn."""
    n = getattr(args, "n_devices", None)
    pipe = getattr(args, "pipe_devices", 1) or 1
    if pipe > 1:
        total = n if n is not None else pipe
        if total % pipe:
            raise ValueError(f"--n-devices {total} not divisible by --pipe-devices {pipe}")
        return total
    return n or 1


def _rank_mesh(args):
    """The mesh of one rank of `launch_ranks`: (n, 1), or with
    `--pipe-devices S` the ('data', 'pipe') mesh of S stages."""
    from vit_ae_plus_plus_torch.parallel import make_mesh, make_pipeline_mesh

    n, pipe = world_size(args), getattr(args, "pipe_devices", 1) or 1
    return make_pipeline_mesh(pipe, n // pipe) if pipe > 1 else make_mesh(n)


def launch_ranks(args, argv: list, n: int, store_dir: str = None, forward_signals=()):
    """`argv`'s command on `n` spawned ranks, each under a data mesh of
    (n, 1), or the pipeline's mesh (module docstring); -> rank 0's result.
    The ranks meet through a file store under the work dir (or
    `store_dir`); `forward_signals` reach rank 0 (`run_ranks`)."""
    import torch

    from vit_ae_plus_plus_torch.parallel import run_ranks

    shards = n // (getattr(args, "pipe_devices", 1) or 1)
    if args.batch_size % shards:
        raise ValueError(f"--batch-size {args.batch_size} does not split into {shards} equal shards: a "
                         "data-parallel run needs a batch size that its data axis divides")
    backend = "gloo" if args.device is not None and torch.device(args.device).type == "cpu" else "nccl"
    store_dir = store_dir or os.path.join(args.work_dir, ".ranks")
    kw = {"forward_signals": forward_signals} if forward_signals else {}
    return run_ranks(_rank_command, n, (argv,), store_dir=store_dir, timeout=None, backend=backend, **kw)[0]


def launch_serve(args, argv: list, n: int):
    """`serve --n-devices n`: the server on `n` ranks (serving.py's serving
    mesh); SIGTERM to this process reaches rank 0, which drains, stops the
    others and returns. The ranks meet through a file store in a temporary
    directory."""
    import signal
    import tempfile

    if args.checkpoint is None:
        raise ValueError("serve needs --checkpoint or --engine")
    store = tempfile.mkdtemp(prefix="vitae-serve-")
    try:
        return launch_ranks(args, argv, n, store_dir=store, forward_signals=(signal.SIGTERM,))
    finally:
        import shutil

        shutil.rmtree(store, ignore_errors=True)


def _rank_command(rank: int, argv: list):
    """One rank of `launch_ranks`: the command under its mesh."""
    from vit_ae_plus_plus_torch.parallel import set_mesh

    args = build_parser().parse_args(argv)
    with set_mesh(_rank_mesh(args)):
        return command(args)


def command(args):
    """Run the parsed command -> what `main` prints last (a JSON-able
    result, a line, or None)."""
    if args.cmd == "serve":
        from vit_ae_plus_plus_torch.parallel import get_mesh
        from vit_ae_plus_plus_torch.serving import serve

        if args.engine is None and args.checkpoint is None:
            raise ValueError("serve needs --checkpoint or --engine")
        serve(
            args.checkpoint, max_wait_ms=args.max_wait_ms, host=args.host, port=args.port,
            max_body_mb=args.max_body_mb, device=args.device, engine_path=args.engine, mesh=get_mesh(),
            **_engine_options(args),
        )
    elif args.cmd == "compile-engine":
        from vit_ae_plus_plus_torch.serving import build_engine
        from vit_ae_plus_plus_torch.serving_aot import save_engine

        if args.checkpoint is None:
            raise ValueError("compile-engine needs --checkpoint")
        meta = save_engine(build_engine(args.checkpoint, device=args.device, **_engine_options(args)), args.out)
        return (f"wrote {args.out} ({os.path.getsize(args.out) / 2**20:.1f} MB): {meta['kind']}, batch "
                f"{meta['batch_size']}, volume {tuple(meta['volume_shape'])}, quantize={meta['quantize']}, "
                f"{meta['fingerprint']['platform']}/{meta['fingerprint']['device_name']}")
    elif args.cmd == "prepare-data":
        prepare_data(args)
    elif args.cmd == "pretrain-kfold":
        from vit_ae_plus_plus_torch.pipelines.pretrain_kfold import pretrain_kfold

        data_cfg, train_cfg = configs_from_args(args)
        return pretrain_kfold(data_cfg, train_cfg, args.work_dir, model_name=args.model,
                              n_splits=args.n_splits, n_devices=args.n_devices,
                              device=args.device)
    elif args.cmd in ("probe-kfold", "finetune-kfold"):
        from vit_ae_plus_plus_torch.pipelines.probe_kfold import probe_kfold

        data_cfg, train_cfg = configs_from_args(args)
        return probe_kfold(
            data_cfg, train_cfg, args.work_dir, args.pretrain_dir, model_name=args.model,
            n_splits=args.n_splits, fix_backbone=(args.cmd == "probe-kfold"),
            use_mixup=args.use_mixup, eval_only=args.eval_only, n_devices=args.n_devices,
            device=args.device,
        )
    elif args.cmd == "finetune":
        from vit_ae_plus_plus_torch.pipelines.finetune import finetune_single

        data_cfg, train_cfg = configs_from_args(args)
        return finetune_single(
            data_cfg, train_cfg, args.work_dir, args.checkpoint, model_name=args.model,
            fix_backbone=args.fix_backbone, use_mixup=args.use_mixup, eval_only=args.eval_only,
            n_devices=args.n_devices, device=args.device,
        )
    elif args.cmd == "resnet-kfold":
        from vit_ae_plus_plus_torch.pipelines.resnet_kfold import resnet_kfold

        data_cfg, train_cfg = configs_from_args(args)
        return resnet_kfold(data_cfg, train_cfg, args.work_dir, n_splits=args.n_splits, eval_only=args.eval_only,
                            n_devices=args.n_devices, device=args.device)
    elif args.cmd == "moco-kfold":
        from vit_ae_plus_plus_torch.pipelines.moco_kfold import moco_kfold

        data_cfg, train_cfg = configs_from_args(args)
        return moco_kfold(data_cfg, train_cfg, args.work_dir, n_splits=args.n_splits, arch=args.moco_arch,
                          resnet_depth=args.resnet_depth, moco_dim=args.moco_dim, moco_mlp_dim=args.moco_mlp_dim,
                          fsdp=args.fsdp, n_devices=args.n_devices, device=args.device)
    elif args.cmd == "moco-extract":
        from vit_ae_plus_plus_torch.pipelines.moco_kfold import moco_extract

        data_cfg, _ = configs_from_args(args)
        return moco_extract(data_cfg, args.checkpoint, args.work_dir, batch_size=args.batch_size,
                            arch=args.moco_arch, resnet_depth=args.resnet_depth, moco_dim=args.moco_dim,
                            moco_mlp_dim=args.moco_mlp_dim, n_splits=args.n_splits, fold_idx=args.fold,
                            compute_dtype=args.compute_dtype, device=args.device)
    elif args.cmd == "contrastive-train":
        from vit_ae_plus_plus_torch.pipelines.contrastive import contrastive_train

        data_cfg, train_cfg = configs_from_args(args)
        return contrastive_train(data_cfg, train_cfg, args.work_dir, use_proj=args.use_proj,
                                 n_devices=args.n_devices, device=args.device)
    elif args.cmd == "eval-classical":
        from vit_ae_plus_plus_torch.pipelines.eval_classical import evaluate_features

        return evaluate_features(args.feature_dir, n_splits=args.n_splits, method=args.method)
    elif args.cmd == "extract-features":
        from vit_ae_plus_plus_torch.pipelines.extract_features import extract_ssl_features

        data_cfg, _ = configs_from_args(args)
        extract_ssl_features(
            data_cfg, args.checkpoint, args.work_dir, model_name=args.model,
            batch_size=args.batch_size, only_test_split=args.only_test_split,
            patch_size=args.patch_size, compute_dtype=args.compute_dtype,
            quantize=args.quantize, n_devices=args.n_devices, device=args.device,
        )
        return "done"
    elif args.cmd == "sanity-viz":
        return sanity_viz(args)
    elif args.cmd == "explore-data":
        from vit_ae_plus_plus_torch.pipelines.sanity_viz import plot_one_slice

        plot_one_slice(args.volumes, out_path=args.out, sample_idx=args.sample)
    elif args.cmd == "profile-attrib":
        from vit_ae_plus_plus_torch.utils.profile_tools import attribute_trace, format_table

        table = attribute_trace(args.trace_dir, steps=args.steps)
        return table if args.json else format_table(table)
    elif args.cmd == "export-torch":
        from vit_ae_plus_plus_torch.models import MODEL_ZOO
        from vit_ae_plus_plus_torch.train.checkpoint import export_torch, save_atomic

        zoo_kw = dict(volume_size=args.volume_size, in_chans=args.in_channels)
        if args.patch_size is not None:
            zoo_kw["patch_size"] = args.patch_size
        sd = export_torch(args.checkpoint, MODEL_ZOO[args.model](**zoo_kw))
        save_atomic(sd, args.out)
        return {"out": args.out, "tensors": len(sd)}
    return None


def sanity_viz(args) -> dict:
    """The `sanity-viz` subcommand: the MAE of `--checkpoint` (a
    reference-layout .pth) at `--compute-dtype` reconstructs the first
    `--num-samples` test volumes, sample i with seed i; -> {i: nonzero
    fractions}. Each sample's PNGs are written as sample 0, so the last
    sample's stand, as in the JAX command. Checks for matplotlib before it
    builds anything."""
    from vit_ae_plus_plus_torch.data import get_dataset
    from vit_ae_plus_plus_torch.device import resolve_device
    from vit_ae_plus_plus_torch.models import MODEL_ZOO, build_model
    from vit_ae_plus_plus_torch.pipelines.sanity_viz import (
        nonzero_fractions, reconstruct, require_matplotlib, save_slice_pngs,
    )
    from vit_ae_plus_plus_torch.train.checkpoint import load_exported_mae, load_reference_state_dict

    require_matplotlib()
    dev = resolve_device(args.device)
    data_cfg, _ = configs_from_args(args)
    mae_cfg = MODEL_ZOO[args.model](volume_size=data_cfg.volume_size, in_chans=data_cfg.in_channels,
                                    dtype=args.compute_dtype)
    model = build_model(mae_cfg)
    load_exported_mae(model, load_reference_state_dict(args.checkpoint))
    model = model.to(dev)
    dataset = get_dataset(data_cfg.name, "test", data_cfg, transforms=None, use_z_score=data_cfg.use_z_score)
    out = {}
    for i in range(min(args.num_samples, len(dataset))):
        _aug, orig, _lab = dataset[i]
        recon = reconstruct(model, orig[None], seed=i)
        out[i] = nonzero_fractions(recon)
        save_slice_pngs(recon, args.work_dir, sample_idx=0)
    return out


def _engine_options(args) -> dict:
    """`build_engine`'s options from the engine flags (`_engine_args`)."""
    return dict(task=args.task, model_name=args.model, volume_size=args.volume_size, in_chans=args.in_channels,
                patch_size=args.patch_size, batch_size=args.batch_size, compute_dtype=args.compute_dtype,
                quantize=args.quantize, normalize=args.normalize, num_classes=args.num_classes,
                ensemble_criterion=args.ensemble_criterion, resize=args.resize_inputs)


def run(argv=None) -> int:
    """Console entry with friendly error reporting: exit 2 on a bad input, a
    refused setting, a missing card or optional library, or a work dir
    locked by another run (`WorkdirLockedError` and `NotImplementedError`
    are `RuntimeError`s)."""
    try:
        return main(argv)
    except (FileNotFoundError, FileExistsError, KeyError, ValueError, RuntimeError, ImportError) as e:
        print(f"error: {type(e).__name__}: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(run())
