"""graph500 [graph]: the paper's own workload — 2D-partitioned BFS with
compressed collectives over Kronecker graphs (scale 22..30, edgefactor 16)."""

import dataclasses

from repro_torch.configs import common


@dataclasses.dataclass(frozen=True)
class Graph500Config:
    name: str = "graph500"
    scale: int = 22
    edgefactor: int = 16
    mode: str = "auto"  # raw | bitmap | auto
    n_roots: int = 64  # benchmark spec: 64 BFS iterations


def model_config() -> Graph500Config:
    return Graph500Config()


def smoke_config() -> Graph500Config:
    return Graph500Config(scale=10, n_roots=4)


common.register(
    common.ArchSpec(
        arch_id="graph500",
        family="graph",
        model_config=model_config,
        smoke_config=smoke_config,
        shapes=common.GRAPH500_SHAPES,
        notes="the paper's workload; TEPS benchmark in benchmarks/teps.py",
    )
)
