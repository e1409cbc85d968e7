"""egnn [gnn]: 4L d_hidden=64 E(n)-equivariant. [arXiv:2102.09844; paper]"""

from repro_torch.configs import common
from repro_torch.models.gnn import EGNNConfig


def model_config(d_in: int = 16, d_out: int = 16) -> EGNNConfig:
    return EGNNConfig(n_layers=4, d_hidden=64, d_in=d_in, d_out=d_out)


def smoke_config() -> EGNNConfig:
    return EGNNConfig(n_layers=2, d_hidden=16, d_in=8, d_out=4)


common.register(
    common.ArchSpec(
        arch_id="egnn",
        family="gnn",
        model_config=model_config,
        smoke_config=smoke_config,
        shapes=common.GNN_SHAPES,
        # the reference's note: its 2D forward (and the port's) quantizes the
        # whole [h, x] payload, coordinates included, under quantize_payload
        notes="lossy payload quantization disabled on coordinate channels",
    )
)
