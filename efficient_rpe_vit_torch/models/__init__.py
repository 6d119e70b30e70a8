from .rpe import KerpleRPE, RPE_REGISTRY
from .attention import (
    SoftmaxAttention,
    FavorPlusAttention,
    ReluAttention,
    ATTENTION_REGISTRY,
)
from .layers import Mlp, TransformerBlock
from .vit import ViT, patchify
from .factory import (
    MODEL_VARIANTS,
    create_model,
)

__all__ = [
    "KerpleRPE",
    "RPE_REGISTRY",
    "SoftmaxAttention",
    "FavorPlusAttention",
    "ReluAttention",
    "ATTENTION_REGISTRY",
    "Mlp",
    "TransformerBlock",
    "ViT",
    "patchify",
    "MODEL_VARIANTS",
    "create_model",
]
