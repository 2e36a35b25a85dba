"""The port's public surface against the JAX package's, read with `ast`.

Every module under embree_tpu/ is parsed beside the module of the same
path under embree_tpu_torch/; neither package is imported. Every public
top-level name of a JAX module (a function, class or assignment; the
imports of an `__init__.py`, which are its exports), every public method
of its public classes and every public parameter of its public
functions, methods and constructors (`__init__`'s arguments, or a
NamedTuple's fields) must exist in the port's module, or stand in
DIFFERENCES with the reason the port differs. The reasons are of four
kinds only:

  * "TPU schedule": the machinery ROADMAP.md's North star lists as not
    ported (consensus turns, regroup sorts, unroll factors, the mid-word
    cap, shared-stack caps, interpret mode);
  * "JAX idiom": `key` arguments (the port takes samplers or uniforms),
    pytree methods, the `_jnp` functions (the port's take tensors), `app=`
    and config strings that became an explicit `device=`, jnp constants;
  * "Pallas module": the `pallas_*` modules, whose kernels live in
    embree_tpu_torch/csrc/ behind the `*_kernel.py` wrappers;
  * "refused": a documented refusal of ROADMAP.md C.2.

An entry that no longer differs fails the test as well, so the table
stays the list of what the port does not have.
"""
from __future__ import annotations

import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
JAX_PKG = ROOT / "embree_tpu"
PORT_PKG = ROOT / "embree_tpu_torch"
KINDS = ("TPU schedule", "JAX idiom", "Pallas module", "refused")

# "module:Name", "module:Name.method" or "module:function(param)" (a
# constructor's parameter: "module:Class(param)") -> (kind, reason)
DIFFERENCES = {
    "build/cbvh.py:CompressedTiles.tree_flatten":
        ("JAX idiom", "pytree method; the port's tiles are a NamedTuple"),
    "build/cbvh.py:CompressedTiles.tree_unflatten":
        ("JAX idiom", "pytree method; the port's tiles are a NamedTuple"),
    "build/treelets.py:TreeletScene.tree_flatten":
        ("JAX idiom", "pytree method; the port's scene is a NamedTuple"),
    "build/treelets.py:TreeletScene.tree_unflatten":
        ("JAX idiom", "pytree method; the port's scene is a NamedTuple"),
    "build/treelets.py:TreeletScene(blocks)":
        ("TPU schedule", "the 128-lane blocks Mosaic loads a row at a time; "
         "the port holds the same words as nodes, pairs and fan boxes"),
    "build/treelets.py:TreeletScene(tre_boxes)":
        ("TPU schedule", "per-mid 128-lane treelet planes; the port holds "
         "the same boxes as fan_boxes"),
    "scene/scene.py:CommittedScene.tree_flatten":
        ("JAX idiom", "pytree method; the port's scene is a NamedTuple"),
    "scene/scene.py:CommittedScene.tree_unflatten":
        ("JAX idiom", "pytree method; the port's scene is a NamedTuple"),
    "scene/scene.py:CommittedScene(user_bvhs)":
        ("JAX idiom", "the pytree-leaf half of `users`; the port's "
         "UserEntry holds the BVH beside the static fields"),
    "scene/scene.py:CommittedScene(hair_bvhs)":
        ("JAX idiom", "the pytree-leaf half of `hairs`; the port's "
         "HairEntry holds the BVH beside the static fields"),
    "scene/scene.py:CommittedScene(pallas)":
        ("Pallas module", "B2's packed rows; the port's `packet` holds "
         "csrc/packet.cu's compact form"),
    "scene/scene.py:CommittedScene(compressed_pallas)":
        ("Pallas module", "B4's and B5's rows; the port's "
         "`compressed_kernel` holds csrc/cbvh.cu's compact form"),
    "scene/scene.py:CommittedScene(mb_pallas)":
        ("Pallas module", "B6's rows; the port's `mb_kernel` holds "
         "csrc/mb.cu's compact form"),
    "scene/scene.py:CommittedScene(hair_pallas)":
        ("Pallas module", "B3's rows a cluster; the port's `hair_set` "
         "holds csrc/packet.cu's one set of every cluster"),
    "render/lights.py:LightTable.tree_flatten":
        ("JAX idiom", "pytree method; the port's table is a NamedTuple"),
    "render/lights.py:LightTable.tree_unflatten":
        ("JAX idiom", "pytree method; the port's table is a NamedTuple"),
    "core/device.py:Device(backend)":
        ("JAX idiom", "a JAX platform name; the port takes `device=`, a "
         "torch device"),
    "core/math.py:INF":
        ("JAX idiom", "a jnp.float32 constant; the port writes math.inf"),
    "core/math.py:NEG_INF":
        ("JAX idiom", "a jnp.float32 constant; the port writes -math.inf"),
    "traverse/cbvh.py:INF":
        ("JAX idiom", "a jnp.float32 constant; the port writes math.inf"),
    "render/lights.py:sample_light(key)":
        ("JAX idiom", "a PRNG key; the port takes the quad light's "
         "uniforms `uv`"),
    "render/materials.py:sample_bsdf(key)":
        ("JAX idiom", "a PRNG key; the port takes the uniforms `u`"),
    "render/materials.py:sample_bsdf_medium(key)":
        ("JAX idiom", "a PRNG key; the port takes the uniforms `u`"),
    "render/tutorials/motion_blur_geometry.py:render(key)":
        ("JAX idiom", "a PRNG key for the ray times; the port takes the "
         "times"),
    "render/tutorials/curve_geometry.py:build_scene(app)":
        ("JAX idiom", "`app=` became `device=`"),
    "render/tutorials/interpolation.py:build_scene(app)":
        ("JAX idiom", "`app=` became `device=`"),
    "render/tutorials/lazy_geometry.py:build_scene(app)":
        ("JAX idiom", "`app=` became `device=`"),
    "render/tutorials/motion_blur_geometry.py:build_scene(app)":
        ("JAX idiom", "`app=` became `device=`"),
    "render/tutorials/pathtracer.py:build_cornell_scene(device_cfg)":
        ("JAX idiom", "a Device config string became `device=`, a Device"),
    "subdiv/core.py:apply_stencil_jnp":
        ("JAX idiom", "the jnp stencil; the port's is apply_stencil_torch"),
    "subdiv/core.py:vertex_normals_jnp":
        ("JAX idiom", "the jnp normals; the port's is vertex_normals_torch"),
    "subdiv/core.py:evaluate_plan(use_jax)":
        ("JAX idiom", "selects the jnp stencil; the port follows the "
         "input's type (numpy or tensor)"),
    "traverse/mb.py:intersect_mb(stack_depth)":
        ("TPU schedule", "the shared stack's size; the port's walk sizes "
         "its stack from the tree"),
    "traverse/mb.py:intersect_mb(max_leaf)":
        ("TPU schedule", "a cap on the triangles tested a leaf; the port "
         "tests every one"),
    "traverse/mb.py:intersect_mb_curves(stack_depth)":
        ("TPU schedule", "the shared stack's size; the port's walk sizes "
         "its stack from the tree"),
    "traverse/mb.py:intersect_mb_curves(max_leaf)":
        ("TPU schedule", "a cap on the curves tested a leaf; the port "
         "tests every one"),
    "traverse/user.py:intersect_user(stack_depth)":
        ("TPU schedule", "the shared stack's size; the port's walk sizes "
         "its stack from the tree"),
    "traverse/user.py:intersect_user(max_leaf)":
        ("TPU schedule", "a cap on the prims tested a leaf; the port's is "
         "the fixed LEAF_MAX"),
    "traverse/rowtrace2.py:INF":
        ("TPU schedule", "a lane fill value of the Mosaic kernel's rows"),
    "traverse/rowtrace2.py:NINF":
        ("TPU schedule", "a lane fill value of the Mosaic kernel's rows"),
    "traverse/rowtrace2.py:MAX_MID_WORDS":
        ("TPU schedule", "the 768-mid compile cap"),
    "traverse/rowtrace2.py:BIG":
        ("TPU schedule", "a consensus-turn sort key"),
    "traverse/rowtrace2.py:DONE_KEY":
        ("TPU schedule", "a regroup sort key"),
    "traverse/rowtrace2.py:fits_rowtrace2":
        ("TPU schedule", "tests the 768-mid compile cap"),
    "traverse/rowtrace2.py:rowtrace2_schedule_stats":
        ("TPU schedule", "counts consensus turns and regroup rounds; the "
         "port's counters are rowtrace2_stats"),
    "traverse/rowtrace2.py:intersect_rowtrace2(interpret)":
        ("TPU schedule", "Pallas interpret mode; the port's CPU path is "
         "the plain version"),
    "traverse/rowtrace2.py:intersect_rowtrace2(max_rounds)":
        ("TPU schedule", "a cap on regroup rounds; the port walks each ray "
         "to its end"),
    "traverse/pallas_cbvh.py":
        ("Pallas module", "B4 and B5: csrc/cbvh.cu behind "
         "traverse/cbvh_kernel.py"),
    "traverse/pallas_hair.py":
        ("Pallas module", "B3: csrc/packet.cu behind "
         "traverse/hair_kernel.py"),
    "traverse/pallas_mb.py":
        ("Pallas module", "B6: csrc/mb.cu behind traverse/mb_kernel.py"),
    "traverse/pallas_packet.py":
        ("Pallas module", "B2: csrc/packet.cu behind "
         "traverse/packet_kernel.py"),
}

# the public entry points the port lacked before it closed these gaps
CLOSED = (
    "render/tutorials/viewer.py:render",
    "render/tutorials/viewer.py:render_frame(smooth_normals)",
    "render/tutorials/subdivision_geometry.py:render_frame(smooth_normals)",
    "verify/fixtures.py:triangle_plane",
    "traverse/stream.py:sort_rays",
    "traverse/stream.py:unsort_one",
    "traverse/stream.py:unsort",
    "core/math.py:AffineSpace.xfm_point",
    "core/math.py:AffineSpace.xfm_vector",
    "build/treelets.py:TreeletScene.hbm_bytes",
    "render/noise.py:P_TABLE",
    "render/noise.py:G3",
    "render/tutorials/user_geometry.py:sphere_intersect",
)


def _public(name: str) -> bool:
    return not name.startswith("_")


def _bindings(body, exports: bool) -> dict:
    """Top-level names of a module body -> their node: functions,
    classes, assignments (inside `if` / `try` too), and with `exports`
    the names it imports."""
    out = {}
    for node in body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            out[node.name] = node
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            for t in targets:
                for n in ast.walk(t):
                    if isinstance(n, ast.Name):
                        out.setdefault(n.id, node)
        elif isinstance(node, (ast.Import, ast.ImportFrom)) and exports:
            for a in node.names:
                out.setdefault((a.asname or a.name).split(".")[0], node)
        elif isinstance(node, (ast.If, ast.Try)):
            inner = list(node.body) + list(node.orelse)
            for h in getattr(node, "handlers", []):
                inner += h.body
            for k, v in _bindings(inner, exports).items():
                out.setdefault(k, v)
    return out


def _params(fn) -> list:
    a = fn.args
    names = [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs]
    names += [x.arg for x in (a.vararg, a.kwarg) if x is not None]
    return [p for p in names if p not in ("self", "cls")]


def _members(cls: ast.ClassDef, module: dict) -> dict:
    """Names a class body binds, its bases' in the same module after."""
    out = {}
    for node in cls.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out.setdefault(node.name, node)
        elif isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    out.setdefault(t.id, node)
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target,
                                                            ast.Name):
            out.setdefault(node.target.id, node)
    for b in cls.bases:
        base = module.get(b.id) if isinstance(b, ast.Name) else None
        if isinstance(base, ast.ClassDef) and base is not cls:
            for k, v in _members(base, module).items():
                out.setdefault(k, v)
    return out


def _ctor_params(cls: ast.ClassDef, module: dict) -> list:
    """`__init__`'s parameters, else the annotated fields (NamedTuple)."""
    members = _members(cls, module)
    init = members.get("__init__")
    if isinstance(init, ast.FunctionDef):
        return _params(init)
    return [k for k, v in members.items() if isinstance(v, ast.AnnAssign)]


def _differences() -> set:
    """Every public name, method and parameter of the JAX package that
    its port counterpart lacks, as DIFFERENCES keys."""
    gaps = set()
    for jf in sorted(JAX_PKG.rglob("*.py")):
        rel = jf.relative_to(JAX_PKG).as_posix()
        pf = PORT_PKG / rel
        if not pf.exists():
            gaps.add(rel)
            continue
        init = jf.name == "__init__.py"
        jmod = _bindings(ast.parse(jf.read_text()).body, init)
        pmod = _bindings(ast.parse(pf.read_text()).body, True)
        for name, node in jmod.items():
            if not _public(name):
                continue
            if name not in pmod:
                gaps.add(f"{rel}:{name}")
                continue
            pnode = pmod[name]
            fn_types = (ast.FunctionDef, ast.AsyncFunctionDef)
            if isinstance(node, fn_types) and isinstance(pnode, fn_types):
                have = set(_params(pnode))
                gaps.update(f"{rel}:{name}({p})" for p in _params(node)
                            if _public(p) and p not in have)
            if isinstance(node, ast.ClassDef) and isinstance(pnode,
                                                             ast.ClassDef):
                have = set(_ctor_params(pnode, pmod))
                gaps.update(f"{rel}:{name}({p})"
                            for p in _ctor_params(node, jmod)
                            if _public(p) and p not in have)
                pm = _members(pnode, pmod)
                for m, mnode in _members(node, jmod).items():
                    if not (_public(m) and isinstance(mnode, fn_types)):
                        continue
                    if m not in pm:
                        gaps.add(f"{rel}:{name}.{m}")
                    elif isinstance(pm[m], fn_types):
                        have = set(_params(pm[m]))
                        gaps.update(f"{rel}:{name}.{m}({p})"
                                    for p in _params(mnode)
                                    if _public(p) and p not in have)
    return gaps


@pytest.fixture(scope="module")
def gaps():
    return _differences()


def test_every_public_name_of_the_jax_package_is_ported_or_listed(gaps):
    """The port has every public name, method and parameter of the JAX
    package but those listed, and every listed entry still differs."""
    unlisted = sorted(gaps - DIFFERENCES.keys())
    stale = sorted(DIFFERENCES.keys() - gaps)
    assert not unlisted, f"missing from the port and not listed: {unlisted}"
    assert not stale, f"listed but present in the port: {stale}"


def test_every_listed_difference_has_an_allowed_reason():
    for key, (kind, reason) in DIFFERENCES.items():
        assert kind in KINDS, (key, kind)
        assert reason and "\n" not in reason, key


def test_the_closed_entry_points_exist_and_stay_unlisted(gaps):
    """The entry points that were the port's last gaps are in the port,
    and none of them is excused by the table."""
    for key in CLOSED:
        assert key not in DIFFERENCES, key
        assert key not in gaps, key
