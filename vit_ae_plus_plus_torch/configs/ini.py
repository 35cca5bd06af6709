"""config.ini bridge: the reference's two-tier config system.

The port's copy of the JAX package's configs/ini.py: an INI file whose
[DATASET] section plus a per-entry-point section override the CLI and
default values ("INI overrides CLI", reference README.MD:13). Same section
names (DATASET, SANITY, K_FOLD, EXTRACT_SSL, RESNET, FINE_TUNE_K_FOLD), the
same key names and the same fallbacks, mapped onto the typed dataclass
configs. `in_channels` falls back to 2 here, where `DataConfig` says 1, as
in the JAX package.
"""

from __future__ import annotations

import configparser
from typing import Tuple

from vit_ae_plus_plus_torch.configs.config import DataConfig, TrainConfig


def read_config(config_path: str) -> configparser.ConfigParser:
    parser = configparser.ConfigParser()
    parser.read(config_path)
    return parser


def bootstrap(config_path: str, key: str) -> Tuple[DataConfig, TrainConfig, dict]:
    """INI -> (DataConfig, TrainConfig, extras). `key` selects the entry-point
    section, exactly like reference bootstrap(args, key)."""
    p = read_config(config_path)
    d = p["DATASET"] if "DATASET" in p else {}
    s = p[key] if key in p else {}

    data_cfg = DataConfig(
        name=d.get("name", "brats"),
        mode=d.get("mode", "whole"),
        split=d.get("split", "idh"),
        use_z_score=p["DATASET"].getboolean("use_z_score", fallback=True) if "DATASET" in p else True,
        in_channels=p["DATASET"].getint("in_channels", fallback=2) if "DATASET" in p else 2,
        volume_size=p["DATASET"].getint("volume_size", fallback=96) if "DATASET" in p else 96,
        num_classes=p["DATASET"].getint("num_classes", fallback=2) if "DATASET" in p else 2,
        base_path=d.get("base_path", ""),
    )

    def getint(k, fb):
        return p[key].getint(k, fallback=fb) if key in p else fb

    def getfloat(k, fb):
        return p[key].getfloat(k, fallback=fb) if key in p else fb

    def getbool(k, fb):
        return p[key].getboolean(k, fallback=fb) if key in p else fb

    train_cfg = TrainConfig(
        epochs=getint("epochs", 50),
        batch_size=getint("batch_size", 4),
        weight_decay=getfloat("weight_decay", 0.05),
        start_epoch=getint("start_epoch", 0),
        mask_ratio=getfloat("mask_ratio", 0.75),
        perceptual_weight=getfloat("perceptual_weight", 0.0),
        contr_weight=getfloat("contr_weight", 0.0),
        use_edge_map=getbool("use_edge_map", True),
        output_dir=s.get("output_dir", "output_dir/k_fold"),
        log_dir=s.get("log_dir", "output_dir/k_fold"),
    )

    extras = {
        "patch_size": getint("patch_size", 8),
        "drop_path": getfloat("drop_path", 0.0),
        "checkpoint": s.get("checkpoint", "checkpoint-380.pth"),
        "eval": getbool("eval", False),
        "feature_extractor_load_path": s.get("feature_extractor_load_path", ""),
        "eval_model_path": s.get("eval_model_path", ""),
        "use_mixup": getbool("use_mixup", False),
        "subtype": s.get("subtype", ""),
        "nb_classes": getint("nb_classes", 2),
        "use_proj": getbool("use_proj", False),
        "only_test_split": getbool("only_test_split", False),
        "use_imagenet": getbool("use_imagenet", False),
        "fix_backbone": (
            p["FINE_TUNE_K_FOLD"].getboolean("fix_backbone", fallback=None)
            if "FINE_TUNE_K_FOLD" in p else None
        ),
    }
    return data_cfg, train_cfg, extras
