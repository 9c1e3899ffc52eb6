from .q4 import (
    QK,
    GGML_FTYPE_F32,
    GGML_FTYPE_F16,
    GGML_FTYPE_Q4_0,
    GGML_FTYPE_Q4_1,
    quantize_q4_0,
    dequantize_q4_0,
    quantize_q4_1,
    dequantize_q4_1,
    q4_0_to_bytes,
    q4_0_from_bytes,
    q4_1_to_bytes,
    q4_1_from_bytes,
)
from .ggml_io import (
    GGMLMagic,
    Hparams,
    TokenEntry,
    TensorRecord,
    CheckpointReader,
    CheckpointWriter,
)
from .repack import (
    ilv_perm,
    ilv_inv_perm,
    PackedQ4,
    pack_q4,
    unpack_q4,
    repack_q4_0,
    repack_q4_1,
    repack_dense,
)
