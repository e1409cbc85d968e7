"""Production mesh geometry, with no device behind it.

The port's counterpart of ``repro/launch/mesh.py``.  A :class:`Mesh` is
axis names and sizes only: 16x16 = 256 chips ``("data", "model")`` for one
pod, (2, 16, 16) = 512 chips ``("pod", "data", "model")`` for two.
Importing this module touches no device.  The grid of the 2D partition
folds every axis but ``model`` into its row axis, so the same mesh serves
the models (FSDP x TP) and the paper's 2D graph partition
(:func:`grid_rows_cols`).

A placement spec is the counterpart of a ``PartitionSpec``: a plain tuple
with one entry per leading dimension, each ``None``, an axis name or a
tuple of axis names (dimensions past its length are not split).
:func:`shard_shape` gives one rank's shard of a global shape under a spec,
as ``NamedSharding(mesh, spec).shard_shape`` does.
"""

from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class Mesh:
    axis_names: tuple[str, ...]
    axis_sizes: tuple[int, ...]

    def __post_init__(self):
        if len(self.axis_names) != len(self.axis_sizes) or len(set(self.axis_names)) != len(
                self.axis_names) or any(k < 1 for k in self.axis_sizes):
            raise ValueError(f"mesh axes {self.axis_names} of sizes {self.axis_sizes}")

    @property
    def shape(self) -> dict[str, int]:
        """Axis name -> size, in axis order (as ``jax.sharding.Mesh.shape``)."""
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)


def make_mesh(axis_sizes: tuple[int, ...], axis_names: tuple[str, ...]) -> Mesh:
    """A mesh of the given geometry (``jax.make_mesh``'s argument order)."""
    return Mesh(tuple(axis_names), tuple(axis_sizes))


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    if multi_pod:
        return make_mesh((2, 16, 16), ("pod", "data", "model"))
    return make_mesh((16, 16), ("data", "model"))


def fsdp_axes(mesh: Mesh) -> tuple[str, ...]:
    """Data-parallel / FSDP axes = everything except the tensor axis."""
    return tuple(a for a in mesh.axis_names if a != "model")


def grid_rows_cols(mesh: Mesh) -> tuple[int, int]:
    """BFS / 2D-GNN grid geometry: rows = product of FSDP axes, cols = TP."""
    rows = 1
    for a in fsdp_axes(mesh):
        rows *= mesh.shape[a]
    return rows, mesh.shape["model"]


def spec_axes(entry) -> tuple[str, ...]:
    """The mesh axes of one spec entry (``None`` -> none)."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def shard_shape(global_shape, spec: tuple, mesh: Mesh) -> tuple[int, ...]:
    """One rank's shard of ``global_shape`` under ``spec`` on ``mesh``: each
    dimension divided by the product of its axes' sizes (entries past the
    shape's rank must be ``None``).  An axis used twice or not on the mesh,
    a split entry past the rank, or a dimension its axes do not divide
    raises ``ValueError``."""
    shape = tuple(int(d) for d in global_shape)
    used = [a for e in spec for a in spec_axes(e)]
    if len(set(used)) != len(used) or any(a not in mesh.shape for a in used):
        raise ValueError(f"spec {spec} on mesh axes {mesh.axis_names}")
    if any(spec_axes(e) for e in spec[len(shape):]):
        raise ValueError(f"spec {spec} splits more dimensions than shape {shape} has")
    out = list(shape)
    for i, e in enumerate(spec[:len(shape)]):
        k = math.prod(mesh.shape[a] for a in spec_axes(e))
        if out[i] % k:
            raise ValueError(f"dimension {i} of {shape} is not divisible by {k} "
                             f"(spec {spec})")
        out[i] //= k
    return tuple(out)


def spec_leaves(specs) -> list:
    """The specs of a spec tree in the order :func:`repro_torch.tree.leaves`
    gives the leaves of the tree they place: dict keys sorted, lists and
    ``NamedTuple`` fields in order, a plain tuple a spec, ``None`` no
    leaf."""
    if specs is None:
        return []
    if isinstance(specs, dict):
        return [x for k in sorted(specs) for x in spec_leaves(specs[k])]
    if isinstance(specs, list) or hasattr(specs, "_fields"):
        return [x for v in specs for x in spec_leaves(v)]
    return [specs]


def map_specs(fn, specs):
    """``fn`` over every spec of a spec tree (structure as
    :func:`spec_leaves`)."""
    if specs is None:
        return None
    if isinstance(specs, dict):
        return {k: map_specs(fn, v) for k, v in specs.items()}
    if isinstance(specs, list):
        return [map_specs(fn, v) for v in specs]
    if hasattr(specs, "_fields"):
        return type(specs)(*(map_specs(fn, v) for v in specs))
    return fn(specs)
