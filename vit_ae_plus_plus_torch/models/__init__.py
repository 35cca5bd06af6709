from vit_ae_plus_plus_torch.models.mae import MaskedAutoencoderViT3D
from vit_ae_plus_plus_torch.models.vit import VisionTransformer3D
from vit_ae_plus_plus_torch.models.zoo import MODEL_ZOO, build_model

__all__ = ["MODEL_ZOO", "MaskedAutoencoderViT3D", "VisionTransformer3D", "build_model"]
