"""Architecture configs of the ported models (``graphcast``, ``gat-cora``,
``egnn``, ``nequip``, the LM archs ``gemma-2b``, ``minicpm-2b``,
``deepseek-coder-33b``, ``deepseek-v2-236b``, ``dbrx-132b``, the recsys arch
``autoint``) and of the paper's own workload (``graph500``).

``get(arch_id)`` / ``list_archs()`` — see :mod:`repro_torch.configs.common`.
"""

from repro_torch.configs.common import ArchSpec, ShapeSpec, get, list_archs  # noqa: F401
