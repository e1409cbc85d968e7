"""Compression-threshold policy (paper §5.4.3): the port's copy of
``repro/comm/threshold.py``.

Compressing tiny messages costs more than it saves: the paper gates the
compression call on a minimum sequence length.  The in-graph wire formats
have static capacities, so the policy answers with plain bools when the
bucket ladders are built.

The defaults are the reference's *modelled TPU-link* constants (a 50 GB/s
link, a 50,000 MI/s on-device codec, 4096-int minimum), kept bit for bit:
they decide which ladder buckets exist, hence which bytes the port moves,
and byte parity with the reference depends on them.  They are not this
card's numbers; a policy calibrated to NVLink and the H100's own codec
rate is later work.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ThresholdPolicy:
    """Decide whether a transfer should be compressed: the link model of the
    paper's Table 7.5 (``modeled_speedup``) and the packed wire formats'
    break-even (``should_pack``).

    Attributes:
      min_ints: minimum element count before compression pays off.
      same_host_bandwidth_gBps: modelled intra-host bandwidth (GB/s).
      link_bandwidth_gBps: modelled link bandwidth, GB/s (the reference's
        TPU ICI figure).
      codec_speed_mips: compression speed in millions of ints/second (the
        reference's modelled TPU bitpack kernel).
      codec_dspeed_mips: decompression speed.
    """

    min_ints: int = 4096
    same_host_bandwidth_gBps: float = 200.0
    link_bandwidth_gBps: float = 50.0
    codec_speed_mips: float = 50_000.0
    codec_dspeed_mips: float = 50_000.0

    def modeled_speedup(self, n_ints: int, ratio: float, same_host: bool = False) -> float:
        """Transfer-time speedup of compressed against plain under this model."""
        bw = (self.same_host_bandwidth_gBps if same_host else self.link_bandwidth_gBps) * 1e9
        plain_s = n_ints * 4 / bw
        comp_s = (
            n_ints / (self.codec_speed_mips * 1e6)
            + n_ints * 4 / (ratio * bw)
            + n_ints / (self.codec_dspeed_mips * 1e6)
        )
        return plain_s / comp_s

    def should_pack(
        self,
        n_values: int,
        packed_words: int,
        dense_words: int,
        stream_len: int | None = None,
        same_host: bool = False,
    ) -> bool:
        """Static-shape break-even for the packed wire formats: the codec
        touches ``n_values`` bucket slots and ships ``packed_words`` words
        against a dense fallback of ``dense_words``; ``stream_len`` (the
        chunk width ``s``) gates the §5.4.3 minimum-size rule.  Consulted
        by :meth:`repro_torch.comm.ladder.BucketLadder.default`."""
        if stream_len is not None and stream_len < self.min_ints:
            return False
        bw = (self.same_host_bandwidth_gBps if same_host else self.link_bandwidth_gBps) * 1e9
        plain_s = dense_words * 4 / bw
        comp_s = (
            n_values / (self.codec_speed_mips * 1e6)
            + packed_words * 4 / bw
            + n_values / (self.codec_dspeed_mips * 1e6)
        )
        return comp_s < plain_s
