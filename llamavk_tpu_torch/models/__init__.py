from .llama import (
    FusedLayerParams,
    KVCache,
    LayerParams,
    LlamaParams,
    ModelConfig,
    QEmbedding,
    embed_tokens,
    init_kv_cache,
    llama_forward,
)
from .loader import (
    LLAMA_CONFIGS,
    load_model,
    params_from_arrays,
    params_from_reader,
    random_tiny_model,
    synthetic_params,
)
