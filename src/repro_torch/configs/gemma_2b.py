"""gemma-2b [dense]: 18L d_model=2048 8H MQA (kv=1) d_ff=16384 vocab=256000,
GeGLU, head_dim=256. [arXiv:2403.08295; hf]"""

from repro_torch.configs import common
from repro_torch.models.transformer import TransformerConfig


def model_config() -> TransformerConfig:
    return TransformerConfig(
        name="gemma-2b",
        n_layers=18,
        d_model=2048,
        n_heads=8,
        n_kv_heads=1,
        head_dim=256,
        d_ff=16384,
        vocab=256000,
        act="gelu",  # GeGLU
    )


def smoke_config() -> TransformerConfig:
    return TransformerConfig(
        name="gemma-smoke",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=1,
        head_dim=32,
        d_ff=256,
        vocab=512,
        act="gelu",
        q_chunk=32,
        kv_chunk=32,
    )


common.register(
    common.ArchSpec(
        arch_id="gemma-2b",
        family="lm",
        model_config=model_config,
        smoke_config=smoke_config,
        shapes=common.LM_SHAPES,
    )
)
