"""Catmull-Clark subdivision of a quad cage to a uniform level, and the
limit position of every vertex of the result, in plain torch.

Written from the published rules, for manifold quad cages with borders
(no creases, no holes, no n-gons: the cages this benchmark reads have
none, and anything else is refused):

  refinement (Catmull and Clark 1978; the border as a cubic B-spline
  curve and a border vertex of one face pinned, the "edge and corner"
  boundary interpolation of OpenSubdiv and Embree's default mode)
    face point    the mean of the face's four vertices
    edge point    inside: (a + b + f1 + f2) / 4; border: (a + b) / 2
    vertex point  inside, n edges: (n - 2) / n v + (sum e + sum f) / n^2
                  (e its edge neighbours, f the new face points around it)
                  border: (b1 + 6 v + b2) / 8 (b its border neighbours)
                  corner: v
  limit (Halstead, Kass and DeRose 1993)
    inside        (n^2 v + 4 sum e + sum d) / (n (n + 5)), d the vertex
                  opposite v in each quad around it
    border        (b1 + 4 v + b2) / 6
    corner        v

A face's vertices are kept as a grid `G` of (2^L + 1)^2 vertex ids:
G[0, 0], G[s, 0], G[s, s], G[0, s] are its corners 0, 1, 2, 3, so the
first index runs from corner 0 to corner 1 (the patch's u) and the
second from corner 0 to corner 3 (its v). Refinement keeps a vertex's
id, so a cage vertex is vertex i at every level.
"""
from __future__ import annotations

import torch


def _quads(grids):
    """(F s^2, 4) vertex ids of every cell of grids (F, s + 1, s + 1),
    in the order (face, i, j), wound as the face."""
    return torch.stack([grids[:, :-1, :-1], grids[:, 1:, :-1],
                        grids[:, 1:, 1:], grids[:, :-1, 1:]],
                       -1).reshape(-1, 4)


def _edges(quads, n):
    """Unique undirected edges of `quads` over `n` vertices: (keys (E,)
    sorted, ends (E, 2), number of quads on each (E,), edge of each quad
    side (Q, 4)); refuses a non-manifold edge."""
    a, b = quads, quads.roll(-1, dims=1)
    key = torch.minimum(a, b) * n + torch.maximum(a, b)
    keys, side, count = torch.unique(key.reshape(-1), return_inverse=True,
                                     return_counts=True)
    if bool((count > 2).any()):
        raise ValueError("an edge of more than two faces")
    return keys, torch.stack([keys // n, keys % n], 1), count, \
        side.reshape(-1, 4)


def _rings(p, quads, ends, count):
    """Per vertex: number of edges, of faces and of border edges, the sums
    of its edge neighbours and of its border neighbours; refuses a border
    vertex that does not have exactly two border edges."""
    n = p.shape[0]
    flat = quads.reshape(-1)
    valence = torch.bincount(ends.reshape(-1), minlength=n)
    faces = torch.bincount(flat, minlength=n)
    esum = torch.zeros_like(p)
    esum.index_add_(0, ends[:, 0], p[ends[:, 1]])
    esum.index_add_(0, ends[:, 1], p[ends[:, 0]])
    border = ends[count == 1]
    nb = torch.bincount(border.reshape(-1), minlength=n)
    bsum = torch.zeros_like(p)
    bsum.index_add_(0, border[:, 0], p[border[:, 1]])
    bsum.index_add_(0, border[:, 1], p[border[:, 0]])
    if bool(((nb != 0) & (nb != 2)).any()):
        raise ValueError("a border vertex without two border edges")
    return valence, faces, nb, esum, bsum


def _by_rule(p, valence, faces, nb, inside, border):
    """`inside` where the vertex has no border edge, `border` where it has,
    the vertex itself at a corner (a border vertex of one face) and where
    no edge meets it."""
    out = torch.where((nb > 0)[:, None], border, inside)
    keep = ((nb > 0) & (faces == 1)) | (valence == 0)
    return torch.where(keep[:, None], p, out)


def refine(p, grids):
    """One level: (positions (V', 3), grids (F, 2s + 1, 2s + 1)) of
    positions (V, 3) and grids (F, s + 1, s + 1). The new vertices are
    [vertex points (V) | edge points (E) | face points (F s^2)]."""
    n = p.shape[0]
    quads = _quads(grids)
    keys, ends, count, side = _edges(quads, n)
    E = ends.shape[0]
    fp = p[quads].mean(1)
    fsum = torch.zeros((E, 3), dtype=p.dtype, device=p.device)
    fsum.index_add_(0, side.reshape(-1), fp.repeat_interleave(4, 0))
    pa, pb = p[ends[:, 0]], p[ends[:, 1]]
    ep = torch.where((count == 1)[:, None], 0.5 * (pa + pb),
                     0.25 * (pa + pb + fsum))
    valence, faces, nb, esum, bsum = _rings(p, quads, ends, count)
    vfsum = torch.zeros_like(p)
    vfsum.index_add_(0, quads.reshape(-1), fp.repeat_interleave(4, 0))
    k = valence.clamp_min(1).to(p.dtype)[:, None]
    vp = _by_rule(p, valence, faces, nb,
                  (k - 2.0) / k * p + (esum + vfsum) / (k * k),
                  (bsum + 6.0 * p) / 8.0)

    def edge_id(a, b):
        return n + torch.searchsorted(keys, torch.minimum(a, b) * n
                                      + torch.maximum(a, b))

    F, s = grids.shape[0], grids.shape[1] - 1
    g2 = torch.empty((F, 2 * s + 1, 2 * s + 1), dtype=grids.dtype,
                     device=grids.device)
    g2[:, ::2, ::2] = grids
    g2[:, 1::2, ::2] = edge_id(grids[:, :-1, :], grids[:, 1:, :])
    g2[:, ::2, 1::2] = edge_id(grids[:, :, :-1], grids[:, :, 1:])
    g2[:, 1::2, 1::2] = n + E + torch.arange(
        F * s * s, device=grids.device).reshape(F, s, s)
    return torch.cat([vp, ep, fp]), g2


def limit(p, grids):
    """The limit position of every vertex (V, 3) of the mesh."""
    n = p.shape[0]
    quads = _quads(grids)
    _, ends, count, _ = _edges(quads, n)
    valence, faces, nb, esum, bsum = _rings(p, quads, ends, count)
    dsum = torch.zeros_like(p)
    for c in range(4):
        dsum.index_add_(0, quads[:, c], p[quads[:, (c + 2) % 4]])
    k = valence.clamp_min(1).to(p.dtype)[:, None]
    return _by_rule(p, valence, faces, nb,
                    (k * k * p + 4.0 * esum + dsum) / (k * (k + 5.0)),
                    (bsum + 4.0 * p) / 6.0)


def cage_grids(face_counts, face_indices, device):
    """(F, 2, 2) grids of a quad cage's faces; refuses other faces."""
    fc = torch.as_tensor(face_counts)
    if not bool((fc == 4).all()):
        raise ValueError("the reference covers quad faces only")
    q = torch.as_tensor(face_indices, dtype=torch.int64,
                        device=device).reshape(-1, 4)
    return torch.stack([torch.stack([q[:, 0], q[:, 3]], 1),
                        torch.stack([q[:, 1], q[:, 2]], 1)], 1)


def limit_grids(vertices, face_counts, face_indices, level, device,
                dtype=torch.float64):
    """(limit positions (V, 3), grids (F, 2^level + 1, 2^level + 1)) of the
    cage refined `level` times, computed in `dtype`."""
    p = torch.as_tensor(vertices, device=device).to(dtype)
    grids = cage_grids(face_counts, face_indices, device)
    for _ in range(level):
        p, grids = refine(p, grids)
    return limit(p, grids), grids
