"""graphcast [gnn]: 16L d_hidden=512 mesh_refinement=6 sum-agg n_vars=227 —
encoder-processor-decoder mesh GNN. [arXiv:2212.12794; unverified]

Per DESIGN.md §5: the arch is the 16-layer interaction-network stack; the
*graph* for each of the 4 cells comes from the shape spec.  The refined
icosahedral multimesh itself is built by models/icosahedron.py and
exercised by repro_torch.bench.gnn."""

from repro_torch.configs import common
from repro_torch.models.gnn import GraphCastConfig


def model_config(d_in: int = 227, d_out: int = 227) -> GraphCastConfig:
    return GraphCastConfig(
        n_layers=16, d_hidden=512, d_in=d_in, d_out=d_out, mesh_refinement=6
    )


def smoke_config() -> GraphCastConfig:
    return GraphCastConfig(n_layers=2, d_hidden=32, d_in=16, d_out=8, mesh_refinement=2)


common.register(
    common.ArchSpec(
        arch_id="graphcast",
        family="gnn",
        model_config=model_config,
        smoke_config=smoke_config,
        shapes=common.GNN_SHAPES,
    )
)
