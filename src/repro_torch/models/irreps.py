"""E(3)-equivariant feature algebra up to l=2, in the Cartesian basis.

The port's counterpart of ``repro/models/irreps.py``.  NequIP composes
features that transform as irreps of O(3); the l<=2 content is carried in
Cartesian form (exactly equivalent for l<=2):

* l=0: scalars  (n, c)
* l=1: vectors  (n, c, 3)
* l=2: traceless symmetric matrices (n, c, 3, 3)  (5 dof embedded in 9)

Tensor-product paths are the classical vector-algebra identities: dot,
cross, symmetric-traceless outer product, matrix-vector action, Frobenius
contraction.  Equivariance is exact in exact arithmetic; the tests hold it
under rotations (``tests/test_torch_equivariant.py``).  The identity is
made on each input's device and dtype.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F


def _eye3(like: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=like.dtype, device=like.device)


class Irreps(NamedTuple):
    """A (scalars, vectors, tensors) feature triple; any member may be None."""

    s: torch.Tensor | None  # (n, c0)
    v: torch.Tensor | None  # (n, c1, 3)
    t: torch.Tensor | None  # (n, c2, 3, 3)

    def map(self, fn):
        return Irreps(*(None if x is None else fn(x) for x in self))


def sph_l1(rhat: torch.Tensor) -> torch.Tensor:
    """(m, 3) unit displacement -> l=1 'spherical harmonic' (itself)."""
    return rhat


def sph_l2(rhat: torch.Tensor) -> torch.Tensor:
    """(m, 3) -> (m, 3, 3) traceless symmetric outer product."""
    outer = rhat[:, :, None] * rhat[:, None, :]
    return outer - _eye3(rhat) / 3.0


def traceless_sym(m: torch.Tensor) -> torch.Tensor:
    """Project (..., 3, 3) onto its traceless symmetric part (l=2)."""
    sym = 0.5 * (m + m.transpose(-1, -2))
    tr = sym.diagonal(dim1=-2, dim2=-1).sum(-1)[..., None, None]
    return sym - tr * _eye3(m) / 3.0


# --- product paths (each output is an irrep of the stated l) ---------------


def p_vv_s(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """1 (x) 1 -> 0 : dot product. (., c, 3) x (., c, 3) -> (., c)."""
    return torch.sum(a * b, dim=-1)


def p_vv_v(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """1 (x) 1 -> 1 : cross product."""
    return torch.linalg.cross(a, b, dim=-1)


def p_vv_t(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """1 (x) 1 -> 2 : symmetric traceless outer product."""
    return traceless_sym(a[..., :, None] * b[..., None, :])


def p_tv_v(t: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """2 (x) 1 -> 1 : matrix-vector action."""
    return torch.einsum("...ij,...j->...i", t, v)


def p_tt_s(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """2 (x) 2 -> 0 : Frobenius contraction."""
    return torch.einsum("...ij,...ij->...", a, b)


def p_tt_t(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """2 (x) 2 -> 2 : traceless symmetric part of the matrix product."""
    return traceless_sym(torch.einsum("...ik,...kj->...ij", a, b))


# --- linear self-interactions (per-l channel mixing) ------------------------


def linear(x: Irreps, w_s, w_v, w_t) -> Irreps:
    """Channel-mixing linear map; acts per-l (equivariance-preserving)."""
    return Irreps(
        s=None if x.s is None else x.s @ w_s,
        v=None if x.v is None else torch.einsum("ncd,ce->ned", x.v, w_v),
        t=None if x.t is None else torch.einsum("ncij,ce->neij", x.t, w_t),
    )


def gate(x: Irreps, gates_v: torch.Tensor, gates_t: torch.Tensor) -> Irreps:
    """Gated nonlinearity: silu on scalars; vectors/tensors scaled by a
    sigmoid of dedicated scalar gates (Weiler-style, equivariant)."""
    return Irreps(
        s=None if x.s is None else F.silu(x.s),
        v=None if x.v is None else x.v * torch.sigmoid(gates_v)[..., None],
        t=None if x.t is None else x.t * torch.sigmoid(gates_t)[..., None, None],
    )


def rotate(x: Irreps, rot: torch.Tensor) -> Irreps:
    """Apply a rotation matrix to every feature (for equivariance tests)."""
    return Irreps(
        s=x.s,
        v=None if x.v is None else torch.einsum("ij,ncj->nci", rot, x.v),
        t=None if x.t is None else torch.einsum("ik,nckl,jl->ncij", rot, x.t, rot),
    )


def bessel_rbf(r: torch.Tensor, n_rbf: int, cutoff: float) -> torch.Tensor:
    """Sinc-like radial Bessel basis with smooth polynomial cutoff envelope
    (NequIP eq. 6).  r: (m,) distances -> (m, n_rbf)."""
    r = torch.clamp(r, min=1e-9)
    n = torch.arange(1, n_rbf + 1, dtype=torch.float32, device=r.device)
    basis = math.sqrt(2.0 / cutoff) * torch.sin(n * math.pi * r[:, None] / cutoff) / r[:, None]
    x = torch.clamp(r / cutoff, 0.0, 1.0)
    envelope = 1.0 - 10.0 * x**3 + 15.0 * x**4 - 6.0 * x**5  # C2-smooth
    return basis * envelope[:, None]
