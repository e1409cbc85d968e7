"""Tests that need the card: each CUDA kernel against its plain PyTorch
version, and the BFS on the card against the BFS on the CPU.  They import
no JAX, so they run where the card is:

    python -m pytest -q -m gpu tests/test_torch_gpu.py

Without a card they skip (decided in the fixture, not at import)."""

import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.comm import CommStats, SimGrid
from repro_torch.core import bfs, csr
from repro_torch.core import distributed_bfs as dbfs
from repro_torch.graphgen import builder, kronecker
from repro_torch.kernels.bitpack import ops as bp_ops
from repro_torch.kernels.bitpack import ref as bp_ref
from repro_torch.kernels.spmv import ops as sp_ops


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
def test_kernels_match_plain_on_card(cuda):
    """Exact agreement at the smoke script's ragged shapes (B > 8 planes
    takes a second pass of the ELL kernel), and each wrapper counts its
    launches."""
    import chip_smoke

    kernels.reset_launches()
    chip_smoke.check_ragged()
    for name in ("pack", "unpack", "popcount_planes", "popcount_blocks", "popcount_words",
                 "spmv_min_planes", "spmv_pull_min_planes", "spmv_min", "spmv_pull_min"):
        assert kernels.LAUNCHES[name] > 0, name
    nbr = torch.zeros((4, 2), dtype=torch.int32, device=cuda)
    f = bp_ops.pack_planes(torch.ones((1, 4), dtype=torch.bool, device=cuda), 1)
    with pytest.raises(ValueError):  # a mixed-device call raises, it does not fall back
        sp_ops.spmv_min_planes(nbr.cpu(), f, bp_ref.chunk_pad(4))


@pytest.mark.gpu
@pytest.mark.parametrize("policy", ["top_down", "bottom_up", "direction_opt"])
@pytest.mark.parametrize("expand", ["coo", "ell", "hybrid"])
def test_bfs_on_card_matches_cpu(cuda, policy, expand):
    g = builder.build_csr(kronecker.kronecker_edges(12, seed=1), n=1 << 12)
    roots = np.array([0, 7, 100, 4000], np.int32)
    on_card = bfs.bfs(g.src, g.dst, roots, g.n, policy=policy, expand=expand, device=cuda)
    on_cpu = bfs.bfs(g.src, g.dst, roots, g.n, policy=policy, expand=expand, device="cpu")
    assert torch.equal(on_card.parent.cpu(), on_cpu.parent)
    assert torch.equal(on_card.level.cpu(), on_cpu.level)
    assert on_card.n_levels == on_cpu.n_levels


@pytest.mark.gpu
def test_distributed_on_card_matches_cpu(cuda):
    """auto + direction_opt + hybrid on a simulated 2x2 grid: the card's
    parents, levels, depth and byte ledger equal the CPU run's, and the
    path launched the unpack kernel."""
    g = builder.build_csr(kronecker.kronecker_edges(12, seed=1), n=1 << 12)
    bg = csr.partition_2d(g, 2, 2)
    cfg = dbfs.DistBFSConfig(mode="auto", policy="direction_opt", expand="hybrid")
    roots = np.array([0, 7, 100, 4000], np.int32)
    runs = {}
    for dev in (cuda, "cpu"):
        grid = SimGrid(2, 2, dev)
        stats = CommStats()
        kernels.reset_launches()
        parent, level, depth = dbfs.build_bfs(grid, bg, cfg, stats=stats)(
            *dbfs.shard_blocked(grid, bg, cfg), roots)
        runs[str(dev)] = (parent.cpu(), level.cpu(), depth, stats.table(),
                          dict(kernels.LAUNCHES))
    card, cpu = runs[str(cuda)], runs["cpu"]
    assert torch.equal(card[0], cpu[0]) and torch.equal(card[1], cpu[1])
    assert card[2] == cpu[2] and card[3] == cpu[3]
    assert card[4].get("unpack", 0) > 0 and not cpu[4]
