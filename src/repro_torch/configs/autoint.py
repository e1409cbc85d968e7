"""autoint [recsys]: 39 sparse fields, embed_dim=16, 3 attn layers (2 heads,
d=32), self-attention feature interaction. [arXiv:1810.11921; paper]"""

from repro_torch.configs import common
from repro_torch.models.recsys import AutoIntConfig


def model_config() -> AutoIntConfig:
    return AutoIntConfig(
        n_sparse=39, embed_dim=16, n_attn_layers=3, n_heads=2, d_attn=32
    )


def smoke_config() -> AutoIntConfig:
    return AutoIntConfig(
        n_sparse=8,
        embed_dim=8,
        n_attn_layers=2,
        n_heads=2,
        d_attn=8,
        mlp_dims=(32,),
        table_sizes=tuple([256] * 8),
    )


common.register(
    common.ArchSpec(
        arch_id="autoint",
        family="recsys",
        model_config=model_config,
        smoke_config=smoke_config,
        shapes=common.RECSYS_SHAPES,
        notes=(
            "embedding rows exchanged all-to-all style by the row-sharded "
            "lookup — the paper's exact data shape (sorted hot ids); int8 "
            "payload + bitpacked id options"
        ),
    )
)
