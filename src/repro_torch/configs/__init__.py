"""Architecture configs of the ported models (``graphcast``, ``gat-cora``).

``get(arch_id)`` / ``list_archs()`` — see :mod:`repro_torch.configs.common`.
"""

from repro_torch.configs.common import ArchSpec, ShapeSpec, get, list_archs  # noqa: F401
