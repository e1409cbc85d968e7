"""Architecture configs of the ported models (``graphcast``, ``gat-cora``,
``egnn``, ``nequip``, and the LM archs ``gemma-2b``, ``minicpm-2b``,
``deepseek-coder-33b``, ``deepseek-v2-236b``, ``dbrx-132b``).

``get(arch_id)`` / ``list_archs()`` — see :mod:`repro_torch.configs.common`.
"""

from repro_torch.configs.common import ArchSpec, ShapeSpec, get, list_archs  # noqa: F401
