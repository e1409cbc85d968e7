"""Graph500 generation and Kernel 1, the paper's vertex sorting, and the
codec study's synthetic streams (host-side numpy copies of
``repro.graphgen``)."""

from repro_torch.graphgen import builder, kronecker, zipf  # noqa: F401
from repro_torch.graphgen.builder import (  # noqa: F401
    CSRGraph,
    block_pad,
    build_csr,
    relabel_by_degree,
    symmetrize,
)
from repro_torch.graphgen.kronecker import kronecker_edges, rmat_edges  # noqa: F401
from repro_torch.graphgen.zipf import sorted_id_stream, zipf_stream  # noqa: F401

__all__ = [
    "kronecker_edges",
    "rmat_edges",
    "build_csr",
    "CSRGraph",
    "symmetrize",
    "relabel_by_degree",
    "zipf_stream",
    "sorted_id_stream",
]
