"""The motion-blur kernel's module (embree_tpu_torch/traverse/mb_kernel.py
and traverse/mb.py) against embree_tpu/traverse/pallas_mb.py and
traverse/mb.py: the packer and the converter byte for byte, the plain
version (`walk_mb`, closest and occluded) against the JAX package's
Pallas kernel in interpret mode and its XLA path on the same accel, the
counters and the stack, the JAX package's limits that the port does not
copy, and the wrappers' CPU dispatch.

Tolerances: valid masks and occlusion answers equal; t 5e-5 relative
(XLA:CPU contracts products into FMAs, the port rounds every product);
prim equal except on equal-t ties, counted and 0 on these shapes; the
walk over the accel's tensors and the walk over the packed rows bit
for bit."""
import numpy as np
import pytest
import torch

import embree_tpu as et
import embree_tpu_torch as ett
from embree_tpu.build.bvh import BVH as RefBVH
from embree_tpu.traverse import mb as ref_mb
from embree_tpu.traverse import pallas_mb as ref_pmb
from embree_tpu_torch.build.bvh import BVH
from embree_tpu_torch.convert import mb_accel_from_reference
from embree_tpu_torch.traverse import mb as port_mb
from embree_tpu_torch.traverse import mb_kernel as mk
from embree_tpu_torch.verify.fixtures import crossing_clusters, triangle_sphere
from test_torch_build import reference_native  # noqa: F401,E402

CFG = "ignore_config_files=1"
KINKED = ((0, 0, 0), (0.8, 0.3, 0.0), (1.6, -0.4, 0.0))
FIELDS = ("lower_ts", "upper_ts", "v0_ts", "v1_ts", "v2_ts", "geom_id",
          "prim_id", "uv_flip", "time_lo", "time_hi")



@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Six test processes share the cores: one intra-op thread a process
    keeps torch's parallel regions from spinning against each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

def ref_arrays(acc) -> dict:
    """The JAX package's MBAccel as the numpy dict the converter takes."""
    out = {f"bvh.{k}": np.asarray(getattr(acc.bvh, k))
           for k in ("lower", "upper", "child", "count", "prim_order")}
    out.update({k: None if getattr(acc, k) is None
                else np.asarray(getattr(acc, k)) for k in FIELDS})
    return out


def _scene(name):
    if name == "kinked":
        v, idx = triangle_sphere((0, 0, 0), 2.0, 12)
        ts = [v + np.float32(o) for o in KINKED]
    else:
        ts, idx = crossing_clusters(np.random.default_rng(0xB10))
    sc = et.Scene(et.Device(CFG))
    sc.attach(et.TriangleMeshMB(indices=idx, timesteps=ts))
    return sc.commit()


@pytest.fixture(scope="module")
def refs():
    cache = {}

    def get(name):
        if name not in cache:
            cs = _scene(name)
            accel, packed = mb_accel_from_reference(ref_arrays(cs.mb), "cpu")
            cache[name] = (cs, accel, packed)
        return cache[name]
    return get


def aimed_rays(rng, n, accel, spread):
    """Rays from random origins, every second one aimed at a random
    triangle where it is at the ray's time, and one time a ray (every
    seventh 0, every eleventh 1)."""
    tm = rng.uniform(0, 1, n).astype(np.float32)
    tm[::7] = 0.0
    tm[::11] = 1.0
    org = rng.uniform(-spread, spread, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    S = accel.num_timesteps
    x = tm * np.float32(S - 1)
    seg = np.clip(x.astype(np.int32), 0, S - 2)
    w = (x - seg)[:, None]
    k = rng.integers(0, accel.v0_ts.shape[1], n)
    cen = sum(v.numpy()[seg, k] * (1 - w) + v.numpy()[seg + 1, k] * w
              for v in (accel.v0_ts, accel.v1_ts, accel.v2_ts)) / 3
    d[::2] = (cen - org)[::2]
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return org, d, tm


def assert_hits_match(ref, port):
    """JAX Hits vs torch Hits; returns the number of ties."""
    rv = np.asarray(ref.valid)
    np.testing.assert_array_equal(port.valid.numpy(), rv)
    rt, pt = np.asarray(ref.t), port.t.numpy()
    np.testing.assert_allclose(pt[rv], rt[rv], rtol=5e-5)
    same = np.asarray(ref.gprim) == port.gprim.numpy()
    np.testing.assert_allclose(pt[~same], rt[~same], rtol=5e-5)
    return int((~same).sum())


@pytest.mark.parametrize("name", ["kinked", "cross"])
def test_pack_mb_and_converter_byte_equal(refs, name):
    """`pack_rows`, the reference-equal intermediate, byte for byte
    against the JAX package's `pack_mb` (from the port's accel and from
    the reference's arrays); the kernel's compact rows hold every float
    bit for bit where it came from, and zeros in the pads."""
    cs, accel, packed = refs(name)
    ref = ref_pmb.pack_mb(cs.mb)
    for rows in (mk.pack_rows(mk.accel_arrays(accel)),
                 mk.pack_rows(ref_arrays(cs.mb))):
        for a, b in ((rows["node_rows"], ref.node_rows),
                     (rows["tri_rows"], ref.tri_rows)):
            assert a.shape == np.shape(b) and a.shape[1] % 128 == 0
            np.testing.assert_array_equal(a.view(np.uint32),
                                          np.asarray(b).view(np.uint32))
        np.testing.assert_array_equal(rows["prim_order"],
                                      np.asarray(ref.prim_order))
    S, W = packed.S, packed.W
    used = 4 * W + 6 * W * S
    assert not rows["node_rows"][:, used:].any()
    assert not rows["tri_rows"][:, 9 * S:].any()
    for got in (packed, mk.pack_mb(accel)):
        assert (got.S, got.W, got.num_nodes, got.num_prims) == (
            ref.S, ref.W, ref.num_nodes, ref.num_prims)
        nr, tr = got.node_rows.numpy(), got.tri_rows.numpy()
        assert nr.shape == (ref.num_nodes, used) and used % 4 == 0
        assert tr.shape == (ref.num_prims, 12 * S)
        np.testing.assert_array_equal(
            nr.view(np.uint32), rows["node_rows"][:, :used].view(np.uint32))
        knots = tr.reshape(-1, S, 12)
        np.testing.assert_array_equal(
            knots[:, :, :9].view(np.uint32),
            rows["tri_rows"][:, :9 * S].reshape(-1, S, 9).view(np.uint32))
        assert not knots[:, :, 9:].any()
        np.testing.assert_array_equal(got.prim_order.numpy(),
                                      rows["prim_order"])
    assert accel.has_time_splits == (name == "cross")
    for f in FIELDS:
        a = getattr(cs.mb, f)
        if a is not None:
            np.testing.assert_array_equal(getattr(accel, f).numpy(),
                                          np.asarray(a))


@pytest.mark.parametrize("name", ["kinked", "cross"])
def test_walk_matches_pallas_interpret_and_xla(refs, rng, name):
    """One packet of 1,024 rays through the JAX package's kernel in
    interpret mode, its XLA path and the port's plain version, closest
    and occluded, on the same accel."""
    cs, accel, packed = refs(name)
    org, d, tm = aimed_rays(rng, 1024, accel, 3.0 if name == "kinked"
                            else 8.0)
    rr = et.make_rays(org, d)
    xla = ref_mb.intersect_mb(cs.mb, rr, tm)
    pal = ref_pmb.intersect_mb_pallas(cs.mb_pallas, cs.mb, rr, tm,
                                      interpret=True)
    pal_occ = np.asarray(ref_pmb.intersect_mb_pallas(
        cs.mb_pallas, cs.mb, rr, tm, occluded=True, interpret=True))
    rays = ett.make_rays(org, d, device="cpu")
    got = mk.intersect_mb_kernel(packed, accel, rays, torch.from_numpy(tm))
    assert np.asarray(xla.valid).sum() >= 100
    assert assert_hits_match(xla, got) == 0
    assert assert_hits_match(pal, got) == 0
    occ = mk.occluded_mb_kernel(packed, rays, torch.from_numpy(tm))
    np.testing.assert_array_equal(occ.numpy(), pal_occ)
    np.testing.assert_array_equal(occ.numpy(), got.valid.numpy())
    # the walk over the accel's own tensors: the same floats, bit for bit
    own = port_mb.intersect_mb(accel, rays, torch.from_numpy(tm))
    for a, b in zip(own, got):
        assert torch.equal(a, b)


def _leaf_paths(rows):
    """For every triangle, the (node, slot) pairs from the root down to
    its leaf: (T, depth) node and slot arrays, -1 past the path's end."""
    child, count = rows.child.numpy(), rows.count.numpy()
    T, D = rows.tris.shape[0], rows.depth
    po = rows.prim_order.numpy()
    nodes = np.full((T, D), -1)
    slots = np.full((T, D), -1)
    todo = [(0, [])]
    while todo:
        m, path = todo.pop()
        for c in range(rows.W):
            if count[m, c] == 0:
                todo.append((child[m, c], path + [(m, c)]))
            elif count[m, c] > 0:
                for p in po[child[m, c]:child[m, c] + count[m, c]]:
                    nodes[p, :len(path) + 1] = [q[0] for q in path] + [m]
                    slots[p, :len(path) + 1] = [q[1] for q in path] + [c]
    assert (nodes[:, 0] == 0).all()
    return nodes, slots


@pytest.mark.parametrize("name", ["kinked", "cross"])
def test_lerped_boxes_contain_lerped_triangles(refs, rng, name):
    """Every box on a triangle's path, lerped to a time with the walk's
    expression, holds the triangle lerped to the same time, exactly in
    float32, wherever the path's time gates admit the time: at 64 random
    times a triangle and at every knot. The box of knot `seg` alone does
    not (the triangles move), so the lerp is what keeps the hits."""
    _cs, _accel, packed = refs(name)
    rows = mk.packed_rows(packed)
    S = rows.S
    nodes, slots = _leaf_paths(rows)
    T, D = nodes.shape
    times = np.concatenate([rng.uniform(0, 1, (T, 64)),
                            np.tile(np.linspace(0, 1, S), (T, 1))], 1)
    tm = torch.from_numpy(times.astype(np.float32))         # (T, R)
    x = tm * float(S - 1)
    seg = x.to(torch.int32).clamp(0, S - 2).long()
    w = x - seg.to(torch.float32)
    omw = 1.0 - w
    p = torch.arange(T)[:, None]
    tri = (rows.tris[p, seg] * omw[..., None]
           + rows.tris[p, seg + 1] * w[..., None]).view(T, -1, 3, 3)
    on = torch.from_numpy(nodes >= 0)
    m = torch.from_numpy(nodes.clip(0))[:, :, None]          # (T, D, 1)
    c = torch.from_numpy(slots.clip(0))[:, :, None]
    box = lambda k: rows.boxes[m, k, :, c]                   # (T, D, R, 6)
    sg = seg[:, None, :]
    lerped = (box(sg) * omw[:, None, :, None]
              + box(sg + 1) * w[:, None, :, None])
    gates = rows.gates[m[..., 0], :, c[..., 0]]              # (T, D, 2)
    admit = (on[..., None] & (tm[:, None] >= gates[..., 0:1])
             & (tm[:, None] <= gates[..., 1:2])) | ~on[..., None]
    admit = admit.all(dim=1)                                 # (T, R)
    checked = 0
    for lo_hi in (lerped, box(sg)):
        lo = lo_hi[..., None, 0:3]                           # (T,D,R,1,3)
        hi = lo_hi[..., None, 3:6]
        inside = ((lo <= tri[:, None]) & (tri[:, None] <= hi)).all(-1)
        inside = inside.all(-1) | ~on[..., None]             # (T, D, R)
        ok = inside.all(dim=1) | ~admit
        if lo_hi is lerped:
            assert ok.all(), f"{int((~ok).sum())} (triangle, time) pairs"
            checked = int(admit.sum())
        else:
            assert not ok.all()
    assert checked >= T * 20


def test_counters_stack_and_times(refs, rng):
    cs, accel, packed = refs("kinked")
    org, d, tm = aimed_rays(rng, 500, accel, 3.0)
    rays = ett.make_rays(org, d, device="cpu")
    t, prim, st = mk.mb_plain(packed, rays, torch.from_numpy(tm), stats=True)
    n = 500
    assert st["rays"] == n and st["dropped_pushes"] == 0
    assert n <= st["node_visits"] <= st["slab_tests"] <= 4 * st["node_visits"]
    assert 0 < st["prims_touched"] <= packed.num_prims
    assert 0 < st["nodes_touched"] <= packed.num_nodes
    # a stack too small for the tree drops pushes, and they are counted
    t2, p2, st2 = mk.mb_plain(packed, rays, torch.from_numpy(tm),
                              stats=True, stack_depth=2)
    assert st2["dropped_pushes"] > 0 and (p2 != prim).any()
    # a scalar time is each ray's time
    a = mk.mb_trace(packed, rays, 0.25)[:2]
    b = mk.mb_trace(packed, rays, torch.full((n,), 0.25))[:2]
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    with pytest.raises(ValueError, match="times"):
        mk.mb_trace(packed, rays, torch.zeros(3))


def _box_accel(child, count, lower, upper, tris, S=2):
    """A hand-made MB accel: node boxes fixed over the knots, triangles
    `tris` (T, 3, 3) not moving."""
    M, W = child.shape
    T = tris.shape[0]
    lo = np.broadcast_to(lower, (S, M, W, 3)).astype(np.float32)
    hi = np.broadcast_to(upper, (S, M, W, 3)).astype(np.float32)
    v = [np.broadcast_to(tris[:, k], (S, T, 3)).astype(np.float32)
         for k in range(3)]
    arrays = {"bvh.lower": lo[0], "bvh.upper": hi[0],
              "bvh.child": child.astype(np.int32),
              "bvh.count": count.astype(np.int32),
              "bvh.prim_order": np.arange(T, dtype=np.int32),
              "lower_ts": lo, "upper_ts": hi, "v0_ts": v[0], "v1_ts": v[1],
              "v2_ts": v[2], "geom_id": np.zeros(T, np.int32),
              "prim_id": np.arange(T, dtype=np.int32),
              "uv_flip": np.zeros(T, np.int32), "time_lo": None,
              "time_hi": None}
    return arrays


def _ref_accel(arrays):
    f = {k: None if arrays[k] is None else np.asarray(arrays[k])
         for k in arrays}
    bvh = RefBVH(*(f[f"bvh.{k}"] for k in ("lower", "upper", "child",
                                           "count", "prim_order")))
    return ref_mb.MBAccel(bvh=bvh, **{k: f[k] for k in FIELDS})


def _port_accel(arrays):
    bvh = BVH(*(torch.from_numpy(np.ascontiguousarray(arrays[f"bvh.{k}"]))
                for k in ("lower", "upper", "child", "count", "prim_order")))
    return port_mb.MBAccel(bvh=bvh, **{
        k: None if arrays[k] is None
        else torch.from_numpy(np.ascontiguousarray(arrays[k]))
        for k in FIELDS})


def _one_ray():
    org = np.array([[0.0, 0.0, 5.0]], np.float32)
    d = np.array([[0.0, 0.0, -1.0]], np.float32)
    return org, d


def _tri_at(z, size=1.0):
    return np.array([[-size, -size, z], [size, -size, z], [0, size, z]],
                    np.float32)


def test_reference_cuts_leaves_beyond_eight_the_port_refuses_them():
    """One leaf of ten triangles, only the tenth in the ray's way: the JAX
    package's kernel and XLA path test the first eight and miss; the
    port's packer refuses the leaf and its walk finds the hit."""
    tris = np.stack([_tri_at(1.0 + k, 0.01) + np.float32([3, 3, 0])
                     for k in range(9)] + [_tri_at(0.5)])
    child = np.array([[0, 0, 0, 0]])
    count = np.array([[10, -1, -1, -1]])
    big = np.array([[-9.0, -9.0, -9.0]] * 4), np.array([[9.0, 9.0, 9.0]] * 4)
    arrays = _box_accel(child, count, big[0][None], big[1][None], tris)
    ref = _ref_accel(arrays)
    org, d = _one_ray()
    rr = et.make_rays(org, d)
    xla = ref_mb.intersect_mb(ref, rr, 0.5)
    pal = ref_pmb.intersect_mb_pallas(ref_pmb.pack_mb(ref), ref, rr, 0.5,
                                      interpret=True)
    assert not bool(xla.valid[0]) and not bool(pal.valid[0])
    with pytest.raises(ValueError, match="leaf of 10 triangles"):
        mk.pack_rows(arrays)
    h = port_mb.intersect_mb(_port_accel(arrays),
                             ett.make_rays(org, d, device="cpu"), 0.5)
    assert bool(h.valid[0]) and int(h.prim_id[0]) == 9
    assert abs(float(h.t[0]) - 4.5) < 1e-5


def _chain(levels):
    """A chain of `levels` nodes, each with three empty inner children in
    slots 0-2 (pushed and left on the stack) and the next chain node in
    slot 3 (popped first: by the JAX package's kernel as the last slot
    pushed, by the port's walk as the nearest child); the last chain node
    holds one leaf with the only triangle. Every box holds the ray; the
    ray (from z = 5 along -z) enters the chain's boxes at once and the
    empty children's boxes (z up to 4) at t = 1."""
    M = 4 * levels
    child = np.zeros((M, 4), np.int64)
    count = np.full((M, 4), -1, np.int64)
    nxt = levels
    for i in range(levels):
        if i < levels - 1:
            child[i, :3] = [nxt, nxt + 1, nxt + 2]
            count[i, :3] = 0
            nxt += 3
            child[i, 3] = i + 1
            count[i, 3] = 0
        else:
            child[i, 0], count[i, 0] = 0, 1
    lo = np.full((M, 4, 3), -9.0)
    hi = np.full((M, 4, 3), 9.0)
    hi[:levels - 1, :3, 2] = 4.0
    return child[:nxt], count[:nxt], lo[:nxt], hi[:nxt]


def test_reference_stack_drops_pushes_the_port_does_not():
    """A chain of 40 nodes needs 3 * 39 + 1 = 118 stack entries; the JAX
    package's kernel holds 96, drops the deepest pushes silently and
    misses the triangle at the bottom; the port's walk sizes its stack
    from the tree's depth and finds it, and a short stack counts drops."""
    child, count, lo, hi = _chain(40)
    arrays = _box_accel(child, count, lo, hi, _tri_at(0.5)[None])
    ref = _ref_accel(arrays)
    org, d = _one_ray()
    pal = ref_pmb.intersect_mb_pallas(ref_pmb.pack_mb(ref), ref,
                                      et.make_rays(org, d), 0.5,
                                      interpret=True)
    assert not bool(pal.valid[0])
    packed = mk.packed_from_rows(mk.pack_rows(arrays), 2, 4, child, count,
                                 "cpu")
    assert packed.depth == 40
    rays = ett.make_rays(org, d, device="cpu")
    t, prim, st = mk.mb_plain(packed, rays, 0.5, stats=True)
    assert prim.tolist() == [0] and st["dropped_pushes"] == 0
    assert abs(float(t[0]) - 4.5) < 1e-5
    _t, p96, st96 = mk.mb_plain(packed, rays, 0.5, stats=True,
                                stack_depth=96)
    assert p96.tolist() == [-1] and st96["dropped_pushes"] > 0


def test_cpu_tensors_take_plain_version_without_a_launch(monkeypatch, refs):
    cs, accel, packed = refs("kinked")

    def no_kernel(*a, **k):
        raise AssertionError("the kernel path was taken for a CPU tensor")

    monkeypatch.setattr(mk, "_load_kernel", no_kernel)
    before = dict(mk.launches)
    org, d = _one_ray()
    rays = ett.make_rays(org * np.float32(0.1), d, device="cpu")
    h = mk.intersect_mb_kernel(packed, accel, rays, 0.3)
    occ = mk.occluded_mb_kernel(packed, rays, 0.3)
    sc = ett.Scene(ett.Device(CFG, device="cpu"))
    v, idx = triangle_sphere((0, 0, 0), 2.0, 6)
    sc.attach(ett.TriangleMeshMB(v, v + np.float32([0.5, 0, 0]), idx))
    sc.commit()
    assert h.valid.item() and occ.item() and sc.intersect(rays).valid.item()
    assert mk.launches == before == {"closest": 0, "occluded": 0}


def test_wrapper_rejects_what_the_kernel_does_not_take(refs):
    _cs, _accel, packed = refs("kinked")
    org, d = _one_ray()
    rays = ett.make_rays(org, d, device="cpu")
    with pytest.raises(ValueError, match="node width"):
        mk.mb_trace(packed._replace(W=8), rays, 0.5)
    with pytest.raises(ValueError, match="knots"):
        mk.mb_trace(packed._replace(S=66), rays, 0.5)
    with pytest.raises(ValueError, match="levels"):
        mk.mb_trace(packed._replace(depth=65), rays, 0.5)
    with pytest.raises(ValueError, match="shape"):
        mk.mb_trace(packed._replace(num_nodes=packed.num_nodes + 1), rays,
                    0.5)
    with pytest.raises(ValueError, match="dtype"):
        mk.mb_trace(packed, ett.Rays(rays.org.double(), rays.dir,
                                     rays.tnear, rays.tfar), 0.5)
