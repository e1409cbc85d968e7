"""The communication plane of the port: wire formats, bucket ladders, the
adaptive exchange engine and its byte ledger, over a simulated grid or
one process per rank.

* :mod:`.formats`     — wire-format geometry + pack/unpack (bitmap, PFOR16
  id stream, found-bitmap + parents, raw ids, dense, int8).
* :mod:`.ladder`      — bucket ladders pruned by word count and the
  :mod:`.threshold` break-even (paper §5.4.3).
* :mod:`.grid`        — the grid's geometry (local ranks, the row-axis
  fold), :class:`SimGrid`, R x C ranks in one process, and the
  differentiable collectives of the GNN's training step.
* :mod:`.procgrid`    — ``ProcessGrid``, one process per rank over
  ``torch.distributed`` (gloo or nccl), and ``spawn`` (imported on its own).
* :mod:`.engine`      — :class:`AdaptiveExchange`: per-group consensus,
  branch dispatch, byte-recording collectives.
* :mod:`.stats`       — :class:`CommStats`, the per-phase byte ledger.
* :mod:`.collectives` — the BFS column and row exchanges, and the int8
  gradient all-reduce.
* :mod:`.registry`    — the ``raw`` / ``bitmap`` / ``auto`` / ``btfly`` wire
  plans, the host codec factory, and the registration API of every axis.
* :mod:`.codecs`      — the paper's §5.2 host codecs (numpy: S4-BP128 with
  delta, PFOR, VByte, Bitmap, Copy) behind Tables 5.4/5.5.

Layering: core.distributed_bfs -> comm -> kernels (bitpack).
"""

from repro_torch.comm.engine import AdaptiveExchange  # noqa: F401
from repro_torch.comm.formats import (  # noqa: F401
    INF,
    BitmapFormat,
    BitmapParentFormat,
    DenseFormat,
    IdStreamFormat,
    IdStreamSpec,
    Int8Format,
    RawIdFormat,
    WireFormat,
    pack_bitmap,
    pack_id_stream,
    pack_plane_meta,
    plane_meta_words,
    plane_wire_bytes,
    unpack_bitmap,
    unpack_id_stream,
    unpack_plane_meta,
)
from repro_torch.comm.grid import SimGrid  # noqa: F401
from repro_torch.comm.ladder import BucketLadder, stream_stats  # noqa: F401
from repro_torch.comm.stats import CommStats, ExchangeRecord  # noqa: F401
from repro_torch.comm.threshold import ThresholdPolicy  # noqa: F401
