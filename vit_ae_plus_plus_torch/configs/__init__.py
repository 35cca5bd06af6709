from vit_ae_plus_plus_torch.configs.config import MAEConfig, ViTConfig

__all__ = ["MAEConfig", "ViTConfig"]
