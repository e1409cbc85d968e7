"""2D-partitioned GNN forward harness: GraphCast on its multimesh, int8 halo
payloads, on a simulated grid.

Builds GraphCast's processor graph, the refined icosahedral multimesh
(:func:`repro_torch.models.icosahedron.multimesh`), partitions it onto a
2D :class:`~repro_torch.comm.SimGrid` (``core.csr.partition_2d``, owned
chunks a multiple of 1024), makes synthetic smooth fields from ``--seed``
(a random linear function of each node's position plus noise, as
``examples/train_gnn.py`` makes them) and parameters from a
``torch.Generator`` seeded the same, then answers ``--requests`` forwards
with the int8 payload on, one with it off, and the single-device forward
once on the whole multimesh.  Every forward is timed with device
synchronization, after one untimed warm-up forward.  It reports:

* the payload bytes of one forward's feature exchanges, int8
  (``Int8Format(n).wire_bytes``) against fp32 (``4 n``), for each rank's
  contribution to every collective (:func:`payload_bytes`, from the shapes);
* the relative L2 gap between the int8 and fp32 outputs;
* the max abs gap between the fp32 2D output and the single-device output.

    python -m repro_torch.bench.gnn                     # graphcast, refinement 6, cuda
    python -m repro_torch.bench.gnn --device cpu --refine 2 --smoke

Every rank runs on the same card, one after another: a forward's time is
that of R*C ranks simulated on one card, not a multi-card figure.
Matrix products are float32 with TF32 off.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch

from repro_torch import kernels, resolve_device
from repro_torch.bench import distributed
from repro_torch.comm import Int8Format, SimGrid
from repro_torch.comm.grid import Grid
from repro_torch.configs import common as configs
from repro_torch.core import csr
from repro_torch.graphgen.builder import CSRGraph
from repro_torch.models import gnn, gnn_dist, icosahedron

ARCHS = ("graphcast", "gat-cora")


@dataclasses.dataclass
class GnnSetup:
    cfg: object  # model config (graphcast with edge_state off)
    grid: Grid  # a SimGrid, or this process's rank of a ProcessGrid
    bg: csr.BlockedGraph
    verts: np.ndarray  # (n, 3)
    edges: np.ndarray  # (m, 2) directed multimesh edges
    nf: np.ndarray  # (n_pad, d_in) fields, zero on the padded vertices
    params: dict
    src_l: list  # per-rank edge blocks on the device (the local ranks')
    dst_l: list
    h_own: list  # per-rank owned fields on the device
    mesh_s: float  # host seconds: multimesh + partition
    refine: int  # multimesh refinement

    @property
    def n(self) -> int:
        return self.verts.shape[0]


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def model_config(arch: str, smoke: bool, layers: int | None = None):
    """The arch's published (or smoke) config, ``n_layers`` cut to
    ``layers`` where given."""
    spec = configs.get(arch)
    cfg = spec.smoke_config() if smoke else spec.model_config()
    if isinstance(cfg, gnn.GraphCastConfig):  # the 2D path recomputes messages
        cfg = dataclasses.replace(cfg, edge_state=False)
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    return cfg


def multimesh_graph(refine: int) -> tuple[np.ndarray, np.ndarray, CSRGraph]:
    """The multimesh and its edges as a CSR graph (unique, both directions,
    no self loops: ``faces_to_edges`` makes them so)."""
    verts, edges = icosahedron.multimesh(refine)
    n = verts.shape[0]
    src, dst = edges[:, 0].astype(np.int32), edges[:, 1].astype(np.int32)
    row_ptr = np.concatenate([[0], np.cumsum(np.bincount(src, minlength=n))]).astype(np.int64)
    g = CSRGraph(n=n, row_ptr=row_ptr, col_idx=dst, src=src, dst=dst, m_input=len(edges))
    return verts, edges, g


def synthetic_fields(verts: np.ndarray, n_vars: int, seed: int) -> np.ndarray:
    """Smooth fields: a random linear function of position per variable,
    plus 0.1 noise."""
    rng = np.random.default_rng(seed)
    base = np.stack([verts @ rng.normal(size=3) for _ in range(n_vars)], 1)
    return (base + 0.1 * rng.normal(size=(verts.shape[0], n_vars))).astype(np.float32)


def setup(arch: str = "graphcast", refine: int = 6, grid: tuple[int, int] | Grid = (2, 2),
          seed: int = 0, smoke: bool = False, device=None,
          layers: int | None = None) -> GnnSetup:
    """The multimesh partitioned onto ``grid`` — an R x C shape, simulated
    on ``device`` (a :class:`SimGrid`), or a grid to run on (this
    process's rank of a ``ProcessGrid``, on its device) — with the fields,
    the parameters and the local ranks' blocks on the device."""
    if isinstance(grid, Grid):
        sim, dev = grid, grid.device
    else:
        dev = resolve_device(device)
        sim = SimGrid(*grid, device=dev)
    if dev.type == "cuda":  # full float32 products: the gaps below assume them
        torch.backends.cuda.matmul.allow_tf32 = False
    cfg = model_config(arch, smoke, layers)
    t0 = time.perf_counter()
    verts, edges, g = multimesh_graph(refine)
    bg = csr.partition_2d(g, sim.rows, sim.cols, chunk_multiple=1024)
    mesh_s = time.perf_counter() - t0
    part = bg.part
    nf = np.zeros((part.n, cfg.d_in), np.float32)
    nf[: g.n] = synthetic_fields(verts, cfg.d_in, seed)
    params = gnn.init(cfg, torch.Generator().manual_seed(seed), dev)
    return GnnSetup(cfg=cfg, grid=sim, bg=bg, verts=verts, edges=edges, nf=nf,
                    params=params, src_l=gnn_dist.shard_edges(sim, bg.src_local),
                    dst_l=gnn_dist.shard_edges(sim, bg.dst_local),
                    h_own=gnn_dist.shard_nodes(sim, nf, part), mesh_s=mesh_s,
                    refine=refine)


def forward_2d(st: GnnSetup, quantize: bool) -> torch.Tensor:
    """One 2D forward -> the (n_pad, d_out) output, owner chunks in order."""
    dcfg = gnn_dist.Dist2DConfig(quantize_payload=quantize)
    with torch.inference_mode():
        out = gnn_dist.forward_2d(st.grid, st.cfg, st.params, st.h_own, st.src_l,
                                  st.dst_l, st.bg.part, dcfg)
    return torch.cat(out, dim=0)


def exchange_passes(cfg, params) -> list[tuple[int, int]]:
    """Each aggregation pass of one 2D forward as (d, dm): the gathered
    width and the message width.  GraphCast has one pass of width d_hidden
    per layer; GAT a max pass over the logits (d = heads x d_out, dm =
    heads) and an exp-sum pass (d = dm = heads x d_out + heads)."""
    if cfg.name == "graphcast":
        return [(cfg.d_hidden, cfg.d_hidden)] * len(params["layers"])
    passes = []
    for lyr in params["layers"]:
        heads, _, d_out = lyr["w"].shape
        passes += [(heads * d_out, heads), (heads * (d_out + 1),) * 2]
    return passes


def payload_bytes(cfg, params, part: csr.Partition2D) -> dict:
    """One 2D forward's feature exchanges, from the shapes.  Per aggregation
    pass (:func:`exchange_passes`), each rank sends three (s, d) payloads
    (the transpose, the row and the column all-gathers) and one (c, s, dm)
    all-to-all.  Returns the int8 (``Int8Format(n).wire_bytes``) and fp32
    (``4 n``) bytes summed over every rank and call, and the number of
    calls."""
    passes = exchange_passes(cfg, params)
    s, ranks = part.chunk, part.rows * part.cols
    sent = [n for d, dm in passes for n in (s * d, s * d, s * d, part.cols * s * dm)]
    return {"int8": ranks * sum(Int8Format(n).wire_bytes for n in sent),
            "fp32": ranks * sum(4 * n for n in sent), "calls": 4 * len(passes)}


def forward_single(st: GnnSetup) -> torch.Tensor:
    """The single-device forward on the whole (unpadded) multimesh."""
    dev = st.grid.device
    g = gnn.Graph(nf=torch.from_numpy(st.nf[: st.n]).to(dev),
                  src=torch.from_numpy(st.edges[:, 0]).to(dev),
                  dst=torch.from_numpy(st.edges[:, 1]).to(dev))
    with torch.inference_mode():
        return gnn.forward(st.cfg, st.params, g)


def _timed(dev, fn):
    _sync(dev)
    t0 = time.perf_counter()
    out = fn()
    _sync(dev)
    return out, time.perf_counter() - t0


def run(st: GnnSetup, requests: int = 4) -> dict:
    """Answer ``requests`` int8 forwards, one fp32 forward and the
    single-device forward; returns the timings, bytes, gaps, the launches
    of the int8 forwards and the outputs."""
    dev = st.grid.device
    n = st.n
    _timed(dev, lambda: forward_2d(st, True))  # warm-up
    before = dict(kernels.LAUNCHES)
    int8_s, out_q = [], None
    for _ in range(requests):
        out_q, sec = _timed(dev, lambda: forward_2d(st, True))
        int8_s.append(sec)
    launches = {k: v - before.get(k, 0) for k, v in kernels.LAUNCHES.items()
                if v - before.get(k, 0)}
    out_f, fp32_s = _timed(dev, lambda: forward_2d(st, False))
    out_1, single_s = _timed(dev, lambda: forward_single(st))
    q, f, one = out_q[:n].double(), out_f[:n].double(), out_1.double()
    wire = payload_bytes(st.cfg, st.params, st.bg.part)
    res = {
        "arch": st.cfg.name, "refine": st.refine, "n": n, "m": int(st.edges.shape[0]),
        "grid": [st.grid.rows, st.grid.cols], "chunk": st.bg.part.chunk,
        "n_pad": st.bg.part.n, "e_cap": int(st.bg.e_cap),
        "block_edges": st.bg.e_counts.ravel().tolist(),
        "layers": getattr(st.cfg, "n_layers", None), "d_hidden": st.cfg.d_hidden,
        "d_in": st.cfg.d_in, "d_out": st.cfg.d_out, "mesh_s": st.mesh_s,
        "int8_s": int8_s, "fp32_s": fp32_s, "single_s": single_s,
        "int8_payload_bytes": wire["int8"], "fp32_payload_bytes": wire["fp32"],
        "exchanges": wire["calls"],
        "int8_rel_l2": float((q - f).norm() / f.norm()),
        "fp32_vs_single_max_abs": float((f - one).abs().max()),
        "single_max_abs": float(one.abs().max()),
        "finite": bool(torch.isfinite(out_q).all() and torch.isfinite(out_f).all()
                       and torch.isfinite(out_1).all()),
        "launches_per_forward": {k: v / requests for k, v in launches.items()},
    }
    return {**res, "outputs": {"int8": out_q, "fp32": out_f, "single": out_1}}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="graphcast", choices=ARCHS)
    ap.add_argument("--refine", type=int, default=6)
    ap.add_argument("--grid", default="2x2", help="R x C of the simulated grid")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--smoke", action="store_true", help="the arch's smoke widths")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    rows, cols = distributed.parse_grid(args.grid)
    st = setup(args.arch, args.refine, (rows, cols), args.seed, args.smoke, args.device)
    res = run(st, args.requests)
    del res["outputs"]
    where = (torch.cuda.get_device_name(st.grid.device) if st.grid.device.type == "cuda"
             else "cpu")
    print(f"# {res['arch']} refinement {args.refine}: n={res['n']:,} m={res['m']:,} on a "
          f"{rows}x{cols} grid (chunk {res['chunk']:,}, e_cap {res['e_cap']:,}) on {where}")
    print(f"int8 forwards {[round(t, 4) for t in res['int8_s']]} s, fp32 {res['fp32_s']:.4f} s, "
          f"single-device {res['single_s']:.4f} s")
    print(f"payload bytes per forward: int8 {res['int8_payload_bytes']:,} vs fp32 "
          f"{res['fp32_payload_bytes']:,} "
          f"({res['fp32_payload_bytes'] / res['int8_payload_bytes']:.3f}x)")
    print(f"int8 vs fp32 relative L2 {res['int8_rel_l2']:.6e}; fp32 2D vs single-device max "
          f"abs {res['fp32_vs_single_max_abs']:.6e} (max |out| {res['single_max_abs']:.6e})")
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
