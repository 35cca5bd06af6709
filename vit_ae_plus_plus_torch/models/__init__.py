from vit_ae_plus_plus_torch.models.mae import MaskedAutoencoderViT3D
from vit_ae_plus_plus_torch.models.vgg import (
    VGG16Features,
    build_perceptual,
    load_torch_vgg_state_dict,
    make_perceptual_fn,
)
from vit_ae_plus_plus_torch.models.vit import VisionTransformer3D, VisionTransformer3DContrastive
from vit_ae_plus_plus_torch.models.zoo import MODEL_ZOO, build_model

__all__ = [
    "MODEL_ZOO",
    "MaskedAutoencoderViT3D",
    "VGG16Features",
    "VisionTransformer3D",
    "VisionTransformer3DContrastive",
    "build_model",
    "build_perceptual",
    "load_torch_vgg_state_dict",
    "make_perceptual_fn",
]
