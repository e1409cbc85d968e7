"""PyTorch + CUDA port of :mod:`repro`: the Graph500 BFS on one device and
on a 2D grid (simulated, or one process per rank), the frontier algebras
(SSSP, CC, PageRank), the 2D-partitioned GNN (GraphCast, GAT, EGNN,
NequIP) with int8 payloads, its training step, AdamW and the int8
error-feedback gradient all-reduce, LM serving (the decoder-only
transformer, the slot-batched decode engine, the token pipeline), the
AutoInt recommender, the training runtime (checkpoints, the step
watchdog, the ``launch.train`` launcher), and the cell catalogue with its
FLOP models, placement specs, the H100 roofline and the dry-run that
counts each cell's program (``launch``).

The layout mirrors ``src/repro/`` module for module, so each port module's
counterpart is easy to find.  The package imports ``torch`` and numpy only:
no JAX and no ``repro`` module, not even the numpy-only ones — it keeps its
own copies (``graphgen``, ``core.validate``, ``models.icosahedron``,
``configs``).

Entry points take ``device=None``, which means the first CUDA card; they
raise when no card is present instead of carrying on on the CPU.  Tests
pass ``device="cpu"`` explicitly, which routes every kernel wrapper to its
plain PyTorch version.  ``device="meta"`` builds shapes and dtypes with no
storage (the cell catalogue's arguments, the counterpart of
``jax.ShapeDtypeStruct``): a kernel wrapper takes its plain version for
meta tensors as for CPU ones, which gives the shapes and launches nothing
(``launch.dryrun`` counts the cells' programs that way).
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``; a CUDA device is checked for availability.
    ``cpu`` and ``meta`` (shapes only) are taken as they are.

    Raises ``RuntimeError`` when CUDA is asked for (explicitly or by
    default) and no card is present: the port never falls back to the CPU
    on its own.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch: no CUDA device is available; pass device='cpu' to "
            "run the plain PyTorch versions of the kernels"
        )
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"repro_torch runs on 'cuda', 'cpu' or 'meta', got {dev}")
    return dev
