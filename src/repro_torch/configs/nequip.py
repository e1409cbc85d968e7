"""nequip [gnn]: 5L d_hidden=32 l_max=2 n_rbf=8 cutoff=5, O(3)-equivariant
tensor products. [arXiv:2101.03164; paper]"""

from repro_torch.configs import common
from repro_torch.models.gnn import NequIPConfig


def model_config(d_in: int = 16, d_out: int = 16) -> NequIPConfig:
    return NequIPConfig(
        n_layers=5, d_hidden=32, l_max=2, n_rbf=8, cutoff=5.0, d_in=d_in, d_out=d_out
    )


def smoke_config() -> NequIPConfig:
    return NequIPConfig(n_layers=2, d_hidden=4, l_max=2, n_rbf=4, cutoff=5.0, d_in=8, d_out=4)


common.register(
    common.ArchSpec(
        arch_id="nequip",
        family="gnn",
        model_config=model_config,
        smoke_config=smoke_config,
        shapes=common.GNN_SHAPES,
        notes=(
            "equivariance-sensitive: wire payloads stay fp32 (lossless id "
            "compression only) — DESIGN.md §Arch-applicability"
        ),
    )
)
