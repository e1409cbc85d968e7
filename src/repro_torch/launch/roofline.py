"""Roofline terms of one cell on the H100.

The port's counterpart of ``repro/launch/roofline.py``: the card's peaks
and :class:`RooflineTerms`, three terms per (arch x shape x mesh), in
seconds:

    compute    = FLOPs / peak FLOP/s
    memory     = bytes / HBM bytes/s
    collective = collective bytes / link bytes/s

Hardware: NVIDIA H100 SXM5 80 GB (NVIDIA's H100 datasheet): 989 TFLOP/s
dense bf16 on the tensor cores, 3.35 TB/s of HBM3, and NVLink's 900 GB/s
over 18 fourth-generation links, 50 GB/s a link.  ``HBM_BW`` is the rate
the kernel bounds of ``chip_smoke.py`` use.

What stays in the reference: ``_shape_bytes`` and ``parse_collectives``
read XLA's HLO text, which a PyTorch program does not have, so they have
no counterpart.  ``terms_from_compiled`` (FLOPs and bytes from XLA's
``cost_analysis``) and ``compare_comm_stats`` (the ledger against the
collectives parsed from HLO) wait for a port of ``launch/dryrun.py``.
"""

from __future__ import annotations

import dataclasses

PEAK_FLOPS = 989e12  # bf16 dense, tensor cores / card
HBM_BW = 3.35e12  # bytes / s / card (HBM3)
LINK_BW = 50e9  # bytes / s / NVLink link (900 GB/s over 18 links)


@dataclasses.dataclass
class RooflineTerms:
    compute_s: float
    memory_s: float
    collective_s: float
    hlo_flops: float  # loop-scaled, per device
    hlo_bytes: float
    collective_bytes: float
    model_flops: float  # analytic (6ND etc.), GLOBAL
    chips: int

    @property
    def dominant(self) -> str:
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        return max(terms, key=terms.get)  # type: ignore[arg-type]

    @property
    def useful_flop_ratio(self) -> float:
        """MODEL_FLOPS / (program FLOPs x chips): recomputation, dispatch
        and mask waste."""
        total_hlo = self.hlo_flops * self.chips
        return self.model_flops / total_hlo if total_hlo else 0.0

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def roofline_fraction(self) -> float:
        """Useful-compute roofline fraction if the program ran at its bound:
        (MODEL_FLOPS / peak-of-all-chips) / bound-time."""
        ideal_s = self.model_flops / (self.chips * PEAK_FLOPS)
        return ideal_s / self.bound_s if self.bound_s else 0.0
