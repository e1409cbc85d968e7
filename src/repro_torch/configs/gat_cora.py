"""gat-cora [gnn]: 2L d_hidden=8 n_heads=8 attention aggregator.
[arXiv:1710.10903; paper]"""

from repro_torch.configs import common
from repro_torch.models.gnn import GATConfig


def model_config(d_in: int = 1433, d_out: int = 7) -> GATConfig:
    return GATConfig(n_layers=2, d_hidden=8, n_heads=8, d_in=d_in, d_out=d_out)


def smoke_config() -> GATConfig:
    return GATConfig(n_layers=2, d_hidden=4, n_heads=2, d_in=16, d_out=4)


common.register(
    common.ArchSpec(
        arch_id="gat-cora",
        family="gnn",
        model_config=model_config,
        smoke_config=smoke_config,
        shapes=common.GNN_SHAPES,
        notes=(
            "cora-scale graphs fall below the compression/scale-out "
            "threshold; cells still run (replicated), per paper §5.4.3"
        ),
    )
)
