"""Shared config machinery: shape sets per family, arch registry."""

from __future__ import annotations

import dataclasses
from typing import Any, Callable


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str  # train | prefill | decode | serve | retrieval | graph_train | skip
    params: dict[str, Any] = dataclasses.field(default_factory=dict)
    skip_reason: str = ""


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    arch_id: str
    family: str  # lm | gnn | recsys | graph
    model_config: Callable[[], Any]
    smoke_config: Callable[[], Any]
    shapes: tuple[ShapeSpec, ...]
    notes: str = ""

    def shape(self, name: str) -> ShapeSpec:
        for s in self.shapes:
            if s.name == name:
                return s
        raise KeyError(f"{self.arch_id}: unknown shape {name!r}")


# --- family shape sets (assigned-pool definitions, verbatim) ----------------

LM_SHAPES = (
    ShapeSpec("train_4k", "train", {"seq_len": 4096, "global_batch": 256}),
    ShapeSpec("prefill_32k", "prefill", {"seq_len": 32768, "global_batch": 32}),
    ShapeSpec("decode_32k", "decode", {"seq_len": 32768, "global_batch": 128}),
    ShapeSpec(
        "long_500k",
        "skip",
        {"seq_len": 524288, "global_batch": 1},
        skip_reason=(
            "pure full-attention arch (MLA is still full attention over a "
            "latent KV); 512k decode requires sub-quadratic attention per "
            "the shape-set rule — recorded as SKIP (DESIGN.md §5)"
        ),
    ),
)

GNN_SHAPES = (
    ShapeSpec(
        "full_graph_sm",
        "graph_train",
        {"n_nodes": 2_708, "n_edges": 10_556, "d_feat": 1_433, "n_classes": 7,
         "dist": "replicated"},
    ),
    ShapeSpec(
        "minibatch_lg",
        "graph_train",
        {"n_nodes": 232_965, "n_edges": 114_615_892, "batch_nodes": 1_024,
         "fanout": (15, 10), "d_feat": 602, "n_classes": 41, "dist": "sampled"},
    ),
    ShapeSpec(
        "ogb_products",
        "graph_train",
        {"n_nodes": 2_449_029, "n_edges": 61_859_140, "d_feat": 100,
         "n_classes": 47, "dist": "2d"},
    ),
    ShapeSpec(
        "molecule",
        "graph_train",
        {"n_nodes": 30, "n_edges": 64, "batch": 128, "d_feat": 16,
         "n_classes": 16, "dist": "batched"},
    ),
)

RECSYS_SHAPES = (
    ShapeSpec("train_batch", "train", {"batch": 65_536}),
    ShapeSpec("serve_p99", "serve", {"batch": 512}),
    ShapeSpec("serve_bulk", "serve", {"batch": 262_144}),
    ShapeSpec("retrieval_cand", "retrieval", {"batch": 1, "n_candidates": 1_000_000}),
)

GRAPH500_SHAPES = (
    ShapeSpec("scale22", "bfs", {"scale": 22, "edgefactor": 16}),
    ShapeSpec("scale27", "bfs", {"scale": 27, "edgefactor": 16}),
    ShapeSpec("scale30", "bfs", {"scale": 30, "edgefactor": 16}),
)

_REGISTRY: dict[str, ArchSpec] = {}


def register(spec: ArchSpec) -> ArchSpec:
    _REGISTRY[spec.arch_id] = spec
    return spec


def get(arch_id: str) -> ArchSpec:
    _load_all()  # every module, also after one was imported on its own
    try:
        return _REGISTRY[arch_id]
    except KeyError:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_REGISTRY)}") from None


def list_archs() -> list[str]:
    _load_all()  # every module, also after one was imported on its own
    return sorted(_REGISTRY)


def _load_all() -> None:
    # import for registration side effects: only the ported archs
    from repro_torch.configs import egnn, gat_cora, graphcast, nequip  # noqa: F401
