"""Refined icosahedral multimesh for GraphCast (numpy, host-side).

GraphCast's processor runs on the union of edges from every refinement level
("multimesh").  Refinement r splits each triangle into 4; refinement 6 gives
40,962 nodes and 81,920 faces.
"""

from __future__ import annotations

import numpy as np


def icosahedron() -> tuple[np.ndarray, np.ndarray]:
    """Unit icosahedron: (12, 3) vertices, (20, 3) faces."""
    phi = (1 + 5**0.5) / 2
    v = np.array(
        [
            [-1, phi, 0], [1, phi, 0], [-1, -phi, 0], [1, -phi, 0],
            [0, -1, phi], [0, 1, phi], [0, -1, -phi], [0, 1, -phi],
            [phi, 0, -1], [phi, 0, 1], [-phi, 0, -1], [-phi, 0, 1],
        ],
        dtype=np.float64,
    )
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    f = np.array(
        [
            [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
            [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
            [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
            [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
        ],
        dtype=np.int64,
    )
    return v, f


def subdivide(verts: np.ndarray, faces: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """One 4-way triangle subdivision, projecting midpoints to the sphere."""
    edge_mid: dict[tuple[int, int], int] = {}
    verts = list(verts)

    def midpoint(a: int, b: int) -> int:
        key = (min(a, b), max(a, b))
        if key not in edge_mid:
            m = verts[a] + verts[b]
            m = m / np.linalg.norm(m)
            edge_mid[key] = len(verts)
            verts.append(m)
        return edge_mid[key]

    new_faces = []
    for a, b, c in faces:
        ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
        new_faces += [[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]]
    return np.asarray(verts), np.asarray(new_faces, dtype=np.int64)


def faces_to_edges(faces: np.ndarray) -> np.ndarray:
    """Unique directed edges (both directions) of a triangle mesh."""
    e = np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]])
    e = np.concatenate([e, e[:, ::-1]])
    return np.unique(e, axis=0)


def multimesh(refinement: int) -> tuple[np.ndarray, np.ndarray]:
    """(verts (n,3), edges (m,2)) — union of edges over all refinement levels."""
    verts, faces = icosahedron()
    all_edges = [faces_to_edges(faces)]
    for _ in range(refinement):
        verts, faces = subdivide(verts, faces)
        all_edges.append(faces_to_edges(faces))
    edges = np.unique(np.concatenate(all_edges), axis=0)
    return verts, edges
