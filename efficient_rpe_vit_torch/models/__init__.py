from .rpe import CirculantStringRPE, KerpleRPE, RoPE, RoPE2D, RPE_REGISTRY
from .attention import (
    SoftmaxAttention,
    FavorHyperAttention,
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
    "CirculantStringRPE",
    "KerpleRPE",
    "RoPE",
    "RoPE2D",
    "RPE_REGISTRY",
    "SoftmaxAttention",
    "FavorHyperAttention",
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
