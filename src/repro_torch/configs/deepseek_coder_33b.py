"""deepseek-coder-33b [dense]: 62L d_model=7168 56H (GQA kv=8) d_ff=19200
vocab=32256, llama-arch. [arXiv:2401.14196; hf]"""

from repro_torch.configs import common
from repro_torch.models.transformer import TransformerConfig


def model_config() -> TransformerConfig:
    return TransformerConfig(
        name="deepseek-coder-33b",
        n_layers=62,
        d_model=7168,
        n_heads=56,
        n_kv_heads=8,
        head_dim=128,
        d_ff=19200,
        vocab=32256,
    )


def smoke_config() -> TransformerConfig:
    return TransformerConfig(
        name="deepseek-coder-smoke",
        n_layers=2,
        d_model=64,
        n_heads=8,
        n_kv_heads=2,
        head_dim=8,
        d_ff=192,
        vocab=512,
        q_chunk=32,
        kv_chunk=32,
    )


common.register(
    common.ArchSpec(
        arch_id="deepseek-coder-33b",
        family="lm",
        model_config=model_config,
        smoke_config=smoke_config,
        shapes=common.LM_SHAPES,
    )
)
