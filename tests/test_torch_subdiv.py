"""The port's host subdivision code (embree_tpu_torch/subdiv) against
embree_tpu/subdiv on the same numpy inputs: plans, evaluated and
limit-projected vertices, patch grids and the eager tessellation are
byte-equal (both are the same numpy arithmetic); the tessellation cache
hits, reuses and evicts as the reference's does."""
import dataclasses

import numpy as np
import pytest

import embree_tpu_torch as ett
from embree_tpu.scene.geometry import SubdivMesh as RefSubdivMesh
from embree_tpu.subdiv import core as ref_core
from embree_tpu.subdiv import tessellate as ref_tess
from embree_tpu_torch.subdiv import core, tessellate
from embree_tpu_torch.subdiv.cache import (SharedLazyTessellationCache,
                                           global_cache, plan_nbytes,
                                           topology_key)
from embree_tpu_torch.verify.fixtures import quad_sphere, subdiv_cube


def crease_args(kind):
    """Crease keyword arguments by case name."""
    if kind == "smooth":
        return {}
    edges = np.array([[0, 1], [1, 2], [2, 3], [3, 0]], np.int32)
    if kind == "hard_edges":
        return dict(edge_creases=edges,
                    edge_crease_weights=np.full(4, np.inf, np.float32))
    if kind == "semi_sharp":
        return dict(edge_creases=edges,
                    edge_crease_weights=np.array([1.5, 2.5, 0.5, 3.0],
                                                 np.float32),
                    vertex_creases=np.array([6], np.int32),
                    vertex_crease_weights=np.array([np.inf], np.float32))
    raise ValueError(kind)


def same_bytes(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, what
    assert a.tobytes() == b.tobytes(), what


def same_dataclass(a, b, what):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray):
            same_bytes(x, y, f"{what}.{f.name}")
        else:
            assert x == y or (x is None and y is None), f"{what}.{f.name}"


CASES = [("smooth", 2), ("smooth", 3), ("hard_edges", 3), ("semi_sharp", 3)]


@pytest.mark.parametrize("kind,level", CASES)
def test_plan_evaluate_limit_grids_byte_equal(kind, level):
    verts, counts, indices = subdiv_cube()
    kw = crease_args(kind)
    rp = ref_core.plan_subdivision(counts, indices, len(verts), level, **kw)
    pp = core.plan_subdivision(counts, indices, len(verts), level, **kw)
    assert len(rp.levels) == len(pp.levels) == level
    for k, (a, b) in enumerate(zip(rp.levels, pp.levels)):
        same_dataclass(a, b, f"level {k}")
    same_bytes(rp.final_quads, pp.final_quads, "final_quads")
    rv = ref_core.evaluate_plan(rp, verts)
    pv = core.evaluate_plan(pp, verts)
    same_bytes(rv, pv, "evaluate_plan")
    same_bytes(ref_core.limit_project(rp, rv), core.limit_project(pp, pv),
               "limit_project")
    for a, b in zip(ref_core.limit_stencil(rp), core.limit_stencil(pp)):
        same_bytes(a, b, "limit_stencil")
    rg, pg = ref_tess.build_patch_grids(rp), tessellate.build_patch_grids(pp)
    same_dataclass(rg, pg, "patch grids")
    assert (pg.grids >= 0).all() and pg.grid_res == 1 << level
    same_bytes(ref_tess.vertex_normals(rv, rp.final_quads),
               tessellate.vertex_normals(pv, pp.final_quads), "normals")


def displ(p, ng, u, v):
    return (p + 0.15 * ng * np.sin(5 * p[..., :1])).astype(np.float32)


@pytest.mark.parametrize("kind,displacement", [
    ("smooth", None), ("hard_edges", None), ("smooth", displ)])
def test_tessellate_mesh_to_triangles_byte_equal(kind, displacement):
    verts, counts, indices = subdiv_cube()
    kw = crease_args(kind)
    ref = ref_tess.tessellate_mesh_to_triangles(
        RefSubdivMesh(verts, counts, indices, displacement=displacement,
                      **kw), 3, with_uv=True)
    got = tessellate.tessellate_mesh_to_triangles(
        ett.SubdivMesh(verts, counts, indices, displacement=displacement,
                       **kw), 3, with_uv=True)
    assert len(ref) == len(got) == 5
    for name, a, b in zip(("v0", "v1", "v2", "prim", "uv3"), ref, got):
        same_bytes(a, b, name)
    assert got[0].shape == (2 * 6 * 64, 3)


def test_ngon_cage_grids_byte_equal():
    """A cage with triangles: every n-gon corner becomes a half-resolution
    sub-patch."""
    verts = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
                      [0.5, 1.7, 0.3]], np.float32)
    counts = np.array([4, 3], np.int32)
    indices = np.array([0, 1, 2, 3, 3, 2, 4], np.int32)
    rp = ref_core.plan_subdivision(counts, indices, 5, 3)
    pp = core.plan_subdivision(counts, indices, 5, 3)
    same_dataclass(ref_tess.build_patch_grids(rp),
                   tessellate.build_patch_grids(pp), "patch grids")
    same_bytes(ref_core.limit_project(rp, ref_core.evaluate_plan(rp, verts)),
               core.limit_project(pp, core.evaluate_plan(pp, verts)),
               "limit_project")


def _commit_subdiv(level):
    verts, counts, indices = subdiv_cube()
    s = ett.Scene(ett.Device("ignore_config_files=1", device="cpu"))
    s.attach(ett.SubdivMesh(verts, counts, indices))
    s.set_levels(level, 2)
    s.commit()
    return s


def test_recommit_hits_cache():
    global_cache().clear()
    h0, m0 = global_cache().hits, global_cache().misses
    _commit_subdiv(3)
    m1 = global_cache().misses
    assert m1 > m0                      # the first commit misses
    _commit_subdiv(3)                   # same topology and level
    assert global_cache().hits > h0
    assert global_cache().misses == m1  # no new planning work


def test_different_level_is_different_entry():
    global_cache().clear()
    _commit_subdiv(2)
    m = global_cache().misses
    _commit_subdiv(3)
    assert global_cache().misses > m


def test_compressed_commit_shares_the_plan_with_the_eager_one():
    global_cache().clear()
    _commit_subdiv(3)
    m = global_cache().misses
    verts, counts, indices = subdiv_cube()
    s = ett.Scene(ett.Device(
        "ignore_config_files=1,subdiv_accel=bvh4.compressed.leaf",
        device="cpu"))
    s.attach(ett.SubdivMesh(verts, counts, indices))
    s.set_levels(3, 2)
    s.commit()
    assert global_cache().misses == m


def test_segmented_eviction():
    c = SharedLazyTessellationCache(max_bytes=1000)
    for i in range(20):
        c.get_or_build(i, lambda: np.zeros(50, np.uint8), lambda v: 200)
    assert c.bytes_used <= 1000
    assert c.evictions > 0
    c.set_size(100)
    assert c.bytes_used <= 100


def test_set_size_via_config():
    dev = ett.Device("ignore_config_files=1,tessellation_cache_size=64M",
                     device="cpu")
    assert dev.state.tessellation_cache_size == 64 * 1024 * 1024
    assert global_cache().max_bytes == 64 * 1024 * 1024
    ett.Device("ignore_config_files=1", device="cpu")  # the default size
    assert global_cache().max_bytes == 128 * 1024 * 1024


def test_topology_key_and_plan_bytes():
    verts, counts, indices = subdiv_cube()
    k1 = topology_key(counts, indices, 8, 3)
    assert k1 == topology_key(counts.copy(), indices.copy(), 8, 3)
    assert k1 != topology_key(counts, indices, 8, 4)
    assert k1 != topology_key(counts, indices, 8, 3,
                              **{k: v for k, v in
                                 crease_args("hard_edges").items()})
    plan = core.plan_subdivision(counts, indices, 8, 3)
    assert plan_nbytes(plan) > 6 * 64 * 4 * 8


def test_quad_sphere_fixture_matches_reference():
    from embree_tpu.verify.fixtures import quad_sphere as ref_quad_sphere
    from embree_tpu.verify.fixtures import subdiv_cube as ref_subdiv_cube
    for a, b in zip(ref_quad_sphere((0, 0, 0), 2.0, 8),
                    quad_sphere((0, 0, 0), 2.0, 8)):
        same_bytes(a, b, "quad_sphere")
    for a, b in zip(ref_subdiv_cube(), subdiv_cube()):
        same_bytes(a, b, "subdiv_cube")
