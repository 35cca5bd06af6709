from vit_ae_plus_plus_torch.configs.config import MAEConfig, TrainConfig, ViTConfig

__all__ = ["MAEConfig", "TrainConfig", "ViTConfig"]
