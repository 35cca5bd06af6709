from vit_ae_plus_plus_torch.configs.config import DataConfig, MAEConfig, TrainConfig, ViTConfig

__all__ = ["DataConfig", "MAEConfig", "TrainConfig", "ViTConfig"]
