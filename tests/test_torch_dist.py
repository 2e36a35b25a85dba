"""The distribution layer (embree_tpu_torch/dist/, verify/scalebench.py,
verify/benchmarks.py) against the JAX package's (tests/test_dist.py's
scenes and contracts).

One module fixture starts a gloo world of 4 ranks on the CPU once
(`run_world`: spawned processes, a FileStore under the test's temporary
directory) and runs every scenario in it; the rank function sits at
module level and imports only numpy, torch and the port, and the JAX
package is imported inside the fixtures and tests, so the spawned ranks
never load it. The JAX side runs on the conftest's 8-device CPU mesh
with `make_mesh(4)`.

Tolerances: ray blocks and the primitive-sharded build byte for byte;
DP hits valid equal, t 5e-5 relative, prim_id equal but on ties (the
JAX walk orders children by a packet's nearest ray, the port by each
ray's own distance); the ring, on shards carried across from the JAX
package, valid, prim_id and gprim equal and t 1e-5 relative (the
contract of tests/test_dist.py::test_prim_sharded_ring); the train step's
losses, scale trajectory and gradients 1e-5 relative."""
import types

import numpy as np
import pytest
import torch

import embree_tpu_torch as ett
from embree_tpu_torch.convert import prim_sharded_from_reference
from embree_tpu_torch.diff.hit import intersect_diff
from embree_tpu_torch.dist.prim_shard import (build_prim_sharded,
                                              place_prim_sharded,
                                              prim_sharded_intersect)
from embree_tpu_torch.dist.sharding import (all_reduce_grads, gather_hits,
                                            make_mesh,
                                            make_sharded_train_step,
                                            run_world, shard_rays,
                                            sharded_intersect)
from embree_tpu_torch.verify import benchmarks, scalebench
from embree_tpu_torch.verify.fixtures import triangle_sphere

WORLD = 4
DP_RAYS, TRAIN_RAYS, RING_RAYS = 1024, 512, 1022   # 1022: padded lanes
STEPS, LR = 5, 2e-4


def inputs():
    """The numpy inputs of every scenario, from one seed."""
    rng = np.random.default_rng(0xD157)
    out = {}
    out["dp_org"] = rng.uniform(-3, 3, (DP_RAYS, 3)).astype(np.float32)
    out["dp_dir"] = rng.normal(size=(DP_RAYS, 3)).astype(np.float32)
    d = rng.normal(size=(TRAIN_RAYS, 3)).astype(np.float32)
    out["train_dir"] = d / np.linalg.norm(d, axis=1, keepdims=True)
    T = 800
    c = rng.random((T, 3)).astype(np.float32) * 4
    out["tris"] = (c, c + rng.random((T, 3)).astype(np.float32) * 0.4,
                   c + rng.random((T, 3)).astype(np.float32) * 0.4,
                   np.zeros(T, np.int32), np.arange(T, dtype=np.int32),
                   np.zeros(T, np.int32))
    out["ring_org"] = rng.random((RING_RAYS, 3)).astype(np.float32) * 4
    d = rng.standard_normal((RING_RAYS, 3)).astype(np.float32)
    out["ring_dir"] = d / np.linalg.norm(d, axis=1, keepdims=True)
    return out


def sphere_scene():
    s = ett.Scene(ett.Device("ignore_config_files=1", device="cpu"))
    s.attach(ett.TriangleMesh(*triangle_sphere((0, 0, 0), 1.0, 24)))
    return s.commit()


def scale_loss(cs):
    """tests/test_dist.py's loss: the sphere scaled by `scale`, hits
    pulled toward `target`."""
    def loss_fn(scale, rays, target):
        tris = cs.tris._replace(v0=cs.tris.v0 * scale, v1=cs.tris.v1 * scale,
                                v2=cs.tris.v2 * scale)
        h = intersect_diff(cs._replace(tris=tris), rays)
        return torch.where(h.valid, (h.t - target) ** 2, 0.0).sum()
    return loss_fn


def numpy_hits(h, r):
    return {k: v.numpy()[:r] for k, v in h._asdict().items()}


def _rank(rank, world, inp, ring_arrays):
    """Every scenario on one rank of the gloo world (CPU tensors)."""
    out = {}
    cs = sphere_scene()
    mesh = make_mesh()
    # data-parallel intersect
    rays = ett.make_rays(inp["dp_org"], inp["dp_dir"], device="cpu")
    block, r = shard_rays(rays, mesh)
    out["block"] = tuple(a.numpy() for a in block)
    out["dp"] = numpy_hits(gather_hits(sharded_intersect(cs, block, mesh),
                                       mesh), r)
    # the train step
    loss_fn = scale_loss(cs)
    step = make_sharded_train_step(mesh, loss_fn)
    full = ett.make_rays(np.zeros((TRAIN_RAYS, 3), np.float32),
                         inp["train_dir"], device="cpu")
    srays, _ = shard_rays(full, mesh)
    target = torch.full(srays.tnear.shape, 0.9)
    scale, losses, scales = torch.tensor(1.0), [], []
    for _ in range(STEPS):
        loss, scale = step(scale, srays, target, lr=LR)
        losses.append(float(loss))
        scales.append(float(scale))
    out["losses"], out["scales"] = losses, scales
    one = torch.tensor(1.0, requires_grad=True)
    g_local = torch.autograd.grad(loss_fn(one, srays, target), one)[0]
    out["grad"] = float(all_reduce_grads(g_local, mesh))
    l0, _ = step(torch.tensor(1.0), srays, target, lr=0.0)
    out["loss_at_1"] = float(l0)
    one = torch.tensor(1.0, requires_grad=True)
    lf = loss_fn(one, full, torch.full((TRAIN_RAYS,), 0.9))
    out["unsharded"] = (lf.item(), torch.autograd.grad(lf, one)[0].item())
    # the primitive-sharded ring: shards carried across from the JAX
    # package, then the port's own build, then one shard on rank 0
    ring = make_mesh(world, "sp")
    rays = ett.make_rays(inp["ring_org"], inp["ring_dir"], device="cpu")
    block, r = shard_rays(rays, ring, "sp")
    shard = prim_sharded_from_reference(ring_arrays[world], "cpu", rank)
    out["ring"] = numpy_hits(gather_hits(
        prim_sharded_intersect(shard, block, ring, "sp"), ring, "sp"),
        block.tnear.shape[0] * world)
    own = place_prim_sharded(build_prim_sharded(*inp["tris"], world), ring,
                             "sp", device="cpu")
    out["ring_own"] = numpy_hits(gather_hits(
        prim_sharded_intersect(own, block, ring, "sp"), ring, "sp"), r)
    alone = make_mesh(1, "sp")
    if alone.get_coordinate() is not None:
        b1, r1 = shard_rays(rays, alone, "sp")
        one_shard = prim_sharded_from_reference(ring_arrays[1], "cpu", 0)
        out["ring_1"] = numpy_hits(
            prim_sharded_intersect(one_shard, b1, alone, "sp"), r1)
    out["scale_keys"] = sorted(scalebench.run(4096, 1, device="cpu"))
    return out


@pytest.fixture(scope="module")
def ref_native(tmp_path_factory):
    from test_torch_build import ensure_reference_native
    with pytest.MonkeyPatch.context() as mp:
        ensure_reference_native(mp, tmp_path_factory.mktemp("ref_native"))
        yield


@pytest.fixture(scope="module")
def world(tmp_path_factory, ref_native):
    """(inputs, the JAX package's prim-sharded arrays, the ranks'
    results)."""
    from embree_tpu.dist.prim_shard import build_prim_sharded as ref_build

    inp = inputs()
    ring_arrays = {d: {k: np.asarray(v) for k, v in
                       ref_build(*inp["tris"], d)._asdict().items()}
                   for d in (1, WORLD)}
    res = run_world(_rank, WORLD, inp, ring_arrays,
                    workdir=str(tmp_path_factory.mktemp("world")))
    return inp, ring_arrays, res


@pytest.fixture(scope="module")
def jax_side():
    """The JAX package's scene of tests/test_dist.py and its 4-device
    mesh."""
    import embree_tpu as et
    from embree_tpu.dist.sharding import make_mesh as ref_make_mesh

    s = et.Scene(et.Device("ignore_config_files=1"))
    s.attach(et.TriangleMesh(*triangle_sphere((0, 0, 0), 1.0, 24)))
    return et, s.commit(), ref_make_mesh(WORLD)


def test_shard_rays_and_dp_intersect(world, jax_side):
    import jax

    from embree_tpu.dist.sharding import shard_rays as ref_shard
    from embree_tpu.dist.sharding import sharded_intersect as ref_dp

    inp, _, res = world
    et, cs, mesh = jax_side
    rays = et.make_rays(inp["dp_org"], inp["dp_dir"])
    srays, r = ref_shard(rays, mesh)
    B = srays.tnear.shape[0] // WORLD
    for k in range(WORLD):
        for got, ref in zip(res[k]["block"], srays):
            assert got.tobytes() == np.asarray(ref)[k * B:(k + 1) * B].tobytes()
    h = jax.tree.map(lambda x: np.asarray(x)[:r],
                     ref_dp(cs, srays, mesh, isa="xla"))
    for k in range(WORLD):      # every rank gathered the same batch
        for f, v in res[k]["dp"].items():
            np.testing.assert_array_equal(v, res[0]["dp"][f])
    got = res[0]["dp"]
    rv = h.valid
    np.testing.assert_array_equal(got["geom_id"] != -1, rv)
    assert rv.sum() > 40
    np.testing.assert_allclose(got["t"][rv], h.t[rv], rtol=5e-5)
    same = got["prim_id"] == h.prim_id
    np.testing.assert_allclose(got["t"][~same], h.t[~same], rtol=5e-5)
    assert (~same).sum() <= 2


def test_sharded_train_step(world, jax_side):
    import jax
    import jax.numpy as jnp

    from embree_tpu.diff.hit import intersect_diff as ref_diff
    from embree_tpu.dist.sharding import make_sharded_train_step as ref_make
    from embree_tpu.dist.sharding import shard_rays as ref_shard

    inp, _, res = world
    et, cs, mesh = jax_side

    def loss_fn(scale, rays, target):
        tris = cs.tris._replace(v0=cs.tris.v0 * scale, v1=cs.tris.v1 * scale,
                                v2=cs.tris.v2 * scale)
        h = ref_diff(cs._replace(tris=tris), rays, isa="xla")
        return jnp.sum(jnp.where(h.valid, (h.t - target) ** 2, 0.0))

    step = ref_make(mesh, loss_fn)
    rays = et.make_rays(np.zeros((TRAIN_RAYS, 3), np.float32),
                        inp["train_dir"])
    srays, _ = ref_shard(rays, mesh)
    target = jnp.full(srays.tnear.shape, 0.9)
    scale, losses, scales = jnp.float32(1.0), [], []
    for _ in range(STEPS):
        loss, scale = step(scale, srays, target, lr=LR)
        losses.append(float(loss))
        scales.append(float(scale))
    g_ref = float(jax.grad(loss_fn)(jnp.float32(1.0), srays, target))
    for k in range(WORLD):      # every rank took the same steps
        assert res[k]["scales"] == res[0]["scales"]
    got = res[0]
    np.testing.assert_allclose(got["losses"], losses, rtol=1e-5)
    np.testing.assert_allclose(got["scales"], scales, rtol=1e-5)
    assert got["losses"][-1] < got["losses"][0] * 0.9
    assert 0.88 < got["scales"][-1] < 1.0
    # the all-reduced gradient and loss equal the unsharded ones
    np.testing.assert_allclose(got["grad"], got["unsharded"][1], rtol=1e-5)
    np.testing.assert_allclose(got["loss_at_1"], got["unsharded"][0],
                               rtol=1e-5)
    np.testing.assert_allclose(got["grad"], g_ref, rtol=1e-5)


def test_prim_sharded_build_and_ring(world):
    import jax.numpy as jnp

    from embree_tpu.core.rayhit import Rays as RefRays
    from embree_tpu.dist.prim_shard import place_prim_sharded as ref_place
    from embree_tpu.dist.prim_shard import (prim_sharded_intersect
                                            as ref_ring)
    from embree_tpu.dist.sharding import make_mesh as ref_make_mesh
    from embree_tpu.dist.sharding import shard_rays as ref_shard

    inp, ring_arrays, res = world
    for d in (1, WORLD):
        own = build_prim_sharded(*inp["tris"], d)
        for k, ref in ring_arrays[d].items():
            got = getattr(own, k)
            assert got.dtype == ref.dtype and got.shape == ref.shape, k
            assert got.tobytes() == ref.tobytes(), k
    mesh = ref_make_mesh(WORLD, "sp")
    rays = RefRays(jnp.asarray(inp["ring_org"]), jnp.asarray(inp["ring_dir"]),
                   jnp.zeros(RING_RAYS), jnp.full(RING_RAYS, np.inf))
    srays, r = ref_shard(rays, mesh, "sp")
    ps = ref_place(_ref_ps(ring_arrays[WORLD]), mesh, "sp")
    h = ref_ring(ps, srays, mesh, "sp", packet_size=256)
    got = res[0]["ring"]
    hv = np.asarray(h.valid)
    np.testing.assert_array_equal(got["geom_id"] != -1, hv)
    assert hv[:r].sum() > RING_RAYS // 4
    assert not hv[r:].any()                # padded lanes stay misses
    np.testing.assert_allclose(got["t"][hv], np.asarray(h.t)[hv], rtol=1e-5)
    for f in ("prim_id", "gprim"):
        np.testing.assert_array_equal(got[f][hv], np.asarray(getattr(h, f))[hv])
    # the port's own shards, the ring of one shard and every rank agree
    for k in range(WORLD):
        for f, v in got.items():
            np.testing.assert_array_equal(res[k]["ring"][f], v)
    for f, v in res[0]["ring_own"].items():
        np.testing.assert_array_equal(v, got[f][:r])
    for f, v in res[0]["ring_1"].items():
        np.testing.assert_array_equal(v, got[f][:r])


def _ref_ps(arrays):
    from embree_tpu.dist.prim_shard import PrimShardedScene
    import jax.numpy as jnp
    return PrimShardedScene(**{k: jnp.asarray(v) for k, v in arrays.items()})


def test_scalebench_and_benchmarks_keys(world, monkeypatch):
    """The port's scalebench (in the world of 4) and benchmark matrix (at
    a tiny size on the CPU) print the JAX modules' keys. The JAX matrix
    runs with its traversals and commits stubbed: only its keys are
    read."""
    import jax.numpy as jnp

    import embree_tpu
    from embree_tpu.verify import benchmarks as ref_bench
    from embree_tpu.verify import scalebench as ref_scale

    _, _, res = world
    ref_keys = sorted(ref_scale.run(1024, 1))
    assert res[0]["scale_keys"] == [k for k in ref_keys
                                    if int(k.split("_")[2][:-3]) <= WORLD]
    assert len(res[0]["scale_keys"]) == 6
    monkeypatch.setattr(embree_tpu, "scene_intersect",
                        lambda cs, rays: types.SimpleNamespace(
                            t=jnp.zeros(1)))
    monkeypatch.setattr(embree_tpu, "scene_occluded",
                        lambda cs, rays: jnp.zeros(1, bool))
    monkeypatch.setattr(embree_tpu.Scene, "commit", lambda self: None)
    ref = ref_bench.run(2000, 64, 1)
    got = benchmarks.run(2000, 64, 1, device="cpu")
    assert sorted(got) == sorted(ref) and len(got) == 20
    assert all(np.isfinite(v) and v > 0 for v in got.values())
