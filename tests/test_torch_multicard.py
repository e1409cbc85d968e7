"""The multi-card path on the CPU: kernel launches routed to their tensors'
card (a mocked CUDA runtime), the popcount ticket words keyed by the
launch's stream, the process grid's NCCL device rule, and
``bench.multicard`` as 4 gloo CPU processes against ``SimGrid`` and the
JAX package's single-device BFS.

Distributed ``direction_opt`` does not trace on jax 0.9.0, so the process
grid's trees are held against JAX single-device ``bfs(policy=
"direction_opt")`` and ``validate.reference_bfs`` on the same graph and
roots; ``bench.multicard`` itself holds every process's planes, level
counts and merged ledger against ``SimGrid``'s.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bfs as jbfs
from repro.core import validate as jvalidate
from repro.graphgen import builder as jbuilder
from repro.graphgen import kronecker as jkronecker
from repro_torch import kernels
from repro_torch.bench import multicard
from repro_torch.comm import procgrid
from repro_torch.kernels.popcount import ops as pc_ops

SCALE = 12
#: a fake CUDA runtime: cuda:0 current, stream handle STREAM + index
STREAM = 7000


@pytest.fixture
def fake_cuda(monkeypatch):
    """``kernels.launch`` over a fake runtime: ``cuda:0`` is current, the
    current stream of ``cuda:k`` is ``STREAM + k``, ``torch.cuda.device``
    records the card it is entered with, and the C entry point records its
    arguments with the guards open when it ran.  Yields that record."""
    calls, open_guards = [], []

    class Guard:
        def __init__(self, device):
            self.device = torch.device(device)

        def __enter__(self):
            open_guards.append(self.device)

        def __exit__(self, *exc):
            open_guards.pop()
            return False

    def cfunc(name, argtypes):
        def fn(*args):
            calls.append({"name": name, "args": args, "guards": list(open_guards)})
            return 0
        return fn

    monkeypatch.setattr(torch._C, "_cuda_getDevice", lambda: 0, raising=False)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream", lambda i: STREAM + i,
                        raising=False)
    monkeypatch.setattr(torch.cuda, "device", Guard)
    monkeypatch.setattr(kernels, "cfunc", cfunc)
    kernels.reset_launches()
    yield calls
    kernels.reset_launches()


@pytest.mark.parametrize("index", [0, 1, 3])
def test_launch_runs_on_its_tensors_card(fake_cuda, index):
    """The launch takes the stream of its tensors' card and enters that
    card's guard exactly when it is not the current one (cuda:0)."""
    kernels.launch("pack", "rt_pack_u8", (), torch.device("cuda", index), 11, 22)
    (call,) = fake_cuda
    assert call["name"] == "rt_pack_u8"
    assert call["args"] == (11, 22, STREAM + index)
    assert call["guards"] == ([] if index == 0 else [torch.device("cuda", index)])
    assert kernels.LAUNCHES["pack"] == 1


def test_popcount_tickets_follow_the_launch_stream(fake_cuda, monkeypatch):
    """popcount_planes' ticket words are keyed by the stream its launch
    goes to: the current stream of the words' card, not of the current
    card."""
    zeros = torch.zeros
    monkeypatch.setattr(torch, "zeros", lambda *a, device=None, **kw: zeros(*a, **kw))
    monkeypatch.setattr(pc_ops, "_SCRATCH", {})
    card = torch.device("cuda", 2)
    scratch = pc_ops._ticket_scratch(card, 8)
    kernels.launch(pc_ops.PLANES_KERNEL, "rt_popcount_planes", pc_ops._PLANES_ARGS, card,
                   scratch.data_ptr())
    (call,) = fake_cuda
    assert list(pc_ops._SCRATCH) == [(card, STREAM + 2)] == [(card, call["args"][-1])]
    assert pc_ops._ticket_scratch(card, 8) is scratch  # one stream, one set of words


@pytest.mark.parametrize("backend,rank,device,want", [
    ("nccl", 2, None, "cuda:2"),
    ("nccl", 2, "cuda", "cuda:2"),
    ("nccl", 2, "cuda:2", "cuda:2"),
    ("nccl", 2, torch.device("cuda", 2), "cuda:2"),
    ("nccl", 2, "cuda:0", ValueError),
    ("nccl", 0, "cpu", ValueError),
    ("gloo", 3, "cpu", "cpu"),
    ("mpi", 0, "cpu", ValueError),
])
def test_rank_device_rule(backend, rank, device, want):
    """Under nccl rank p runs on cuda:p: no index means that card, another
    card or a CPU device raises; gloo takes the device as it is."""
    if want is ValueError:
        with pytest.raises(ValueError):
            procgrid.rank_device(backend, rank, device)
    else:
        assert procgrid.rank_device(backend, rank, device) == torch.device(want)


@pytest.fixture(scope="module")
def run():
    """``bench.multicard`` on 4 gloo CPU processes at scale 12, the train
    step at refinement 2 and smoke widths; torch on one thread in this
    process (the workers take one each)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield multicard.main(["--device", "cpu", "--backend", "gloo", "--scale", str(SCALE),
                              "--refine", "2", "--smoke"])
    finally:
        torch.set_num_threads(saved)


def test_multicard_cpu_runs_every_case(run):
    """Every case of both grids ran on the processes, equal to SimGrid
    (``main`` exits nonzero otherwise), and every tree is valid."""
    assert run["failures"] == []
    keys = set(run["bfs"]["cases"])
    assert keys == {f"{r}x{c} bfs {m} direction_opt" for (r, c), modes in
                    multicard.BFS_CASES.items() for m in modes} | {"2x2 sssp auto top_down"}
    assert run["bfs"]["validated_trees"] == multicard.N_ROOTS
    assert [p["rank"] for p in run["bfs"]["processes"]] == [0, 1, 2, 3]
    for rec in run["bfs"]["cases"].values():
        assert rec["bytes"] and all(t > 0 for t in rec["batch_s"])


@pytest.fixture(scope="module")
def jax_trees():
    from repro_torch.bench import teps
    from repro_torch.graphgen import builder, kronecker

    jg = jbuilder.build_csr(jkronecker.kronecker_edges(SCALE, seed=1), n=1 << SCALE)
    g = builder.build_csr(kronecker.kronecker_edges(SCALE, seed=1), n=1 << SCALE)
    roots = teps.valid_roots(g, multicard.N_ROOTS, seed=2)
    return jg, roots


@pytest.mark.parametrize("b", range(multicard.N_ROOTS // multicard.BATCH))
def test_multicard_trees_equal_jax_single_device(run, jax_trees, b):
    """Each batch's trees, which every process gave under every plan on
    both grids, equal JAX single-device ``bfs(policy="direction_opt")``
    and the host reference's levels."""
    jg, roots = jax_trees
    chunk = roots[b * multicard.BATCH:(b + 1) * multicard.BATCH]
    parent, level = run["trees"][b]
    ref = jbfs.bfs(jnp.asarray(jg.src), jnp.asarray(jg.dst), jnp.asarray(chunk), jg.n,
                   policy="direction_opt", expand="hybrid")
    np.testing.assert_array_equal(parent, np.asarray(ref.parent))
    np.testing.assert_array_equal(level, np.asarray(ref.level))
    for k, r in enumerate(chunk):
        np.testing.assert_array_equal(level[k], jvalidate.reference_bfs(jg, int(r)))


def test_multicard_train_step_within_bounds(run):
    """The train step on the processes: fp32 within GNN_FP32_REL of
    SimGrid's, int8 loss within TRAIN_INT8_LOSS_REL of fp32."""
    train = run["train"]
    assert max(train["fp32_gaps"]) <= multicard.GNN_FP32_REL
    assert train["int8_loss_rel"] < multicard.TRAIN_INT8_LOSS_REL
    assert train["devices"] == ["cpu"] * 4
