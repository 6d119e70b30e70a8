from .rpe import CirculantStringRPE, KerpleRPE, RoPE, RoPE2D, RPE_REGISTRY
from .attention import (
    SoftmaxAttention,
    FavorHyperAttention,
    FavorPlusAttention,
    ReluAttention,
    ATTENTION_REGISTRY,
)
from .layers import Mlp, MoeMlp, TransformerBlock
from .vit import ViT, patchify
from .factory import (
    MODEL_VARIANTS,
    count_parameters,
    create_model,
    get_model_info,
    list_available_models,
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
    "MoeMlp",
    "TransformerBlock",
    "ViT",
    "patchify",
    "MODEL_VARIANTS",
    "create_model",
    "list_available_models",
    "get_model_info",
    "count_parameters",
]
