"""minicpm-2b [dense]: 40L d_model=2304 36H (kv=36) d_ff=5760 vocab=122753,
WSD schedule, llama-like. [arXiv:2404.06395; hf]"""

from repro_torch.configs import common
from repro_torch.models.transformer import TransformerConfig


def model_config() -> TransformerConfig:
    return TransformerConfig(
        name="minicpm-2b",
        n_layers=40,
        d_model=2304,
        n_heads=36,
        n_kv_heads=36,
        head_dim=64,
        d_ff=5760,
        vocab=122753,
    )


def smoke_config() -> TransformerConfig:
    return TransformerConfig(
        name="minicpm-smoke",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        head_dim=16,
        d_ff=160,
        vocab=512,
        q_chunk=32,
        kv_chunk=32,
    )


common.register(
    common.ArchSpec(
        arch_id="minicpm-2b",
        family="lm",
        model_config=model_config,
        smoke_config=smoke_config,
        shapes=common.LM_SHAPES,
        notes="trains with the WSD schedule (optim/adamw.py)",
    )
)
