"""The retriever models: the transformer encoder, heads, the five model
families, and weight import (Flax param trees, HF checkpoints)."""

from dhr_tpu_torch.models.flax_params import (
    flax_to_state_dict,
    load_flax_params,
    random_flax_params,
)
from dhr_tpu_torch.models.retrievers import (
    MODEL_TYPES,
    BiEncoder,
    Reps,
    RetrieverConfig,
    RetrieverEncoder,
)
from dhr_tpu_torch.models.transformer import (
    EncoderConfig,
    EncoderWithMLM,
    TransformerEncoder,
)

__all__ = [
    "MODEL_TYPES", "BiEncoder", "EncoderConfig", "EncoderWithMLM", "Reps",
    "RetrieverConfig", "RetrieverEncoder", "TransformerEncoder",
    "flax_to_state_dict", "load_flax_params", "random_flax_params",
]
