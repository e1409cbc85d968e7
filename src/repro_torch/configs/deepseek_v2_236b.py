"""deepseek-v2-236b [moe]: 60L d_model=5120 128H d_ff_expert=1536
vocab=102400, MLA kv_lora=512, MoE 2 shared + 160 routed top-6.
[arXiv:2405.04434; hf]  (Simplification noted in DESIGN.md: HF's dense first
layer is made MoE like the rest so scan-over-layers stays uniform.)"""

from repro_torch.configs import common
from repro_torch.models.transformer import TransformerConfig


def model_config() -> TransformerConfig:
    return TransformerConfig(
        name="deepseek-v2-236b",
        n_layers=60,
        d_model=5120,
        n_heads=128,
        n_kv_heads=128,
        head_dim=128,
        d_ff=12288,  # (unused in MoE layers; HF dense-layer width)
        vocab=102400,
        n_experts=160,
        top_k=6,
        n_shared_experts=2,
        d_ff_expert=1536,
        use_mla=True,
        kv_lora_rank=512,
        q_lora_rank=1536,
        qk_rope_dim=64,
        qk_nope_dim=128,
        v_head_dim=128,
    )


def smoke_config() -> TransformerConfig:
    return TransformerConfig(
        name="deepseek-v2-smoke",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        head_dim=16,
        d_ff=128,
        vocab=512,
        n_experts=8,
        top_k=2,
        n_shared_experts=2,
        d_ff_expert=32,
        moe_group=64,
        use_mla=True,
        kv_lora_rank=32,
        q_lora_rank=24,
        qk_rope_dim=8,
        qk_nope_dim=16,
        v_head_dim=16,
        q_chunk=32,
        kv_chunk=32,
    )


common.register(
    common.ArchSpec(
        arch_id="deepseek-v2-236b",
        family="lm",
        model_config=model_config,
        smoke_config=smoke_config,
        shapes=common.LM_SHAPES,
    )
)
