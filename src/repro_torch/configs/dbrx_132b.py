"""dbrx-132b [moe]: 40L d_model=6144 48H (GQA kv=8) d_ff=10752 vocab=100352,
MoE 16 experts top-4, fine-grained. [hf:databricks/dbrx-base; unverified]"""

from repro_torch.configs import common
from repro_torch.models.transformer import TransformerConfig


def model_config() -> TransformerConfig:
    return TransformerConfig(
        name="dbrx-132b",
        n_layers=40,
        d_model=6144,
        n_heads=48,
        n_kv_heads=8,
        head_dim=128,
        d_ff=10752,
        vocab=100352,
        n_experts=16,
        top_k=4,
        d_ff_expert=10752,
        act="silu",
    )


def smoke_config() -> TransformerConfig:
    return TransformerConfig(
        name="dbrx-smoke",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        head_dim=16,
        d_ff=96,
        vocab=512,
        n_experts=4,
        top_k=2,
        d_ff_expert=96,
        moe_group=64,
        q_chunk=32,
        kv_chunk=32,
    )


common.register(
    common.ArchSpec(
        arch_id="dbrx-132b",
        family="lm",
        model_config=model_config,
        smoke_config=smoke_config,
        shapes=common.LM_SHAPES,
    )
)
