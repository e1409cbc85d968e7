"""Single-device BFS: expansion backends, traversal policies, the level
loop and the Graph500 validator.

The name tables of the registry axes (``traversal.POLICIES``,
``expand.BACKENDS``, ``algebra.ALGEBRAS``, and the wire plans of
:mod:`repro_torch.comm.registry`) are plain dicts, read through
:func:`lookup` and extended through :func:`register`.
"""


class UnknownName(KeyError, ValueError):
    """A name no table holds: a ``KeyError``, as the reference's registry
    raises, and a ``ValueError``, as the port's resolvers raise for any
    argument they refuse."""


def lookup(table: dict, what: str, name):
    """``table[name]``, or :class:`UnknownName` naming the known names."""
    try:
        return table[name]
    except KeyError:
        raise UnknownName(f"unknown {what} {name!r}; known: {sorted(table)}") from None


def register(table: dict, what: str, obj) -> None:
    """Add ``obj`` under ``obj.name``; a name held already raises
    ``ValueError``."""
    if obj.name in table:
        raise ValueError(f"{what} {obj.name!r} already registered")
    table[obj.name] = obj
