#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (embree_tpu_torch).

    python3 chip_smoke.py            # needs one CUDA card, several minutes
    python3 chip_smoke.py --quick    # stop after the kernel-vs-plain phases

Builds every kernel from the sources in this checkout (one nvcc per
source, started together), holds each kernel against its plain PyTorch
version on the card, and drives the port's paths at full size through
the public entry points:

  * the treelet path (kernel `rowtrace2`): Device -> Scene -> attach ->
    commit -> intersect / occluded on a 998,284-triangle sphere with
    2^21 incoherent rays, every one of them held against the plain
    version over the compact treelet scene (0 ulp, counters equal);
  * the packet path (kernel `packet`): a 99,012-triangle scene of two
    masked geometries with 2^21 incoherent rays (plain, filtered and
    masked requests), the 998,284-triangle scene with a 1920x1080 frame
    of coherent camera rays and with 2^15 incoherent rays, and the
    `triangle_geometry` tutorial through `TutorialApplication.run`,
    its image held against the reference renderer's own 128x128 render;
  * the trainer: 5 steps of forward (treelet kernel, no gradient) +
    `hit_t_grad` + backward + a plain gradient step on the vertices;
  * the compressed subdivision path (kernels `cbvh` and `cbvh_occluded`):
    a 3,968-face quad sphere (without its degenerate pole faces)
    displaced by fBm noise, subdivided to level 5 and committed under
    `subdiv_accel=bvh4.compressed.leaf` as 63,488 tiles of 64 cells, with
    2^21 incoherent rays and a 1920x1080 frame through `scene.intersect`
    / `scene.occluded`, every ray held against the plain versions over the
    compact accel, and against the eager tessellation of the same
    mesh (8.1M triangles through the packet kernel); the other modes and
    node flavors on a 960-face cage; and the `displacement_geometry`
    tutorial; the same 3,968-face cage in the paper's other two leaf
    modes, `grid` and `box`, committed on the host by two worker
    processes of a pool while the card runs phase 5 on, through `scene_intersect`
    / `scene_occluded` on the same rays and frame, both kernels against
    their plain versions on 2^16 strided rays, `box` conservative
    against the leaf hits;
  * main-bvh8 (phase 8b): the 998,284-triangle sphere committed as a BVH8
    packet scene (`tri_accel=bvh8.triangle4.packet`), the packet kernel
    at W = 8 on the 2^21 rays and the frame, against its plain version,
    a brute force and the BVH4 scene's answer;
  * the motion-blur path (kernels `mb` and `mb_occluded`): the
    998,284-triangle sphere as one `TriangleMeshMB` with three timesteps
    (kinked motion), 2^21 incoherent rays and a 1920x1080 frame at
    random per-ray times through `scene.intersect(..., time=)` and
    `occluded_mb_kernel`, held against the static scenes of its first
    and last knot (packet kernel) and against a brute-force test of the
    lerped triangles; small MB scenes (two to five timesteps, temporal
    splits, quads, a subdivision mesh, beside static triangles and
    beside a compressed accel); and the `motion_blur_geometry` tutorial;
  * the hair path (kernel B3, `hair_cone` and `hair_ribbon`, each with an
    any-hit variant): the `hair_geometry` tutorial's fur at 2^18 strands
    (1,572,864 round sub-segments in strand-aligned clusters, over its
    ground plane) with 2^21 incoherent rays and a 1920x1080 frame, and
    2^16 random flat curves (524,288 ribbon sub-segments in 13 clusters),
    through `scene.intersect` / `scene.occluded` (one B3 launch a request
    over every cluster), held against B3's plain version, against the
    fold one cluster at a time (bit for bit) and against a brute force
    over every sub-segment; line segments, a segment soup and motion-blur
    curves on the torch-op walks against brute forces; the
    `hair_geometry` and `curve_geometry` tutorials;
  * the paper's demo (phase 23): `viewer -i tests/golden/bomberman.obj
    --compress.leaf --subdLvl 6 --compLvl 3 --size 1280 768` through
    `viewer.make_app().run` (kernel `cbvh`, smooth limit-surface normals
    through `Scene.interpolate_normal`), its commit, device bytes and
    frame split into B4, compressed_hits, the smooth-normal pass, shading
    and unsort; the geometric-normal frame (`viewer.render`, equal to
    `render_frame(smooth_normals=False)`) timed beside it and held
    against the CPU on a 64x48 crop; the 160x96 frame against the
    reference binaries' render (2.5 %), B4 against its plain version on its every ray, the normals
    against the CPU, and `Scene.interpolate` (derivatives, attributes) on
    2^20 random points; phase 24: the `subdivision_geometry` (B2, analytic
    patch derivatives; its 128x128 frame against the reference's render,
    0.2 %) and `interpolation` (B2 and B4) tutorials at 512x512;
  * instances and user geometry (phase 25, inst-grid): 64 rotated and
    scaled instances of (a)'s 99,012-triangle sphere, committed once,
    over a ground plane, with 2^21 incoherent rays and a 1920x1080 frame
    through `scene.intersect` / `scene.occluded` (one B2 launch an
    instance and one for the ground a request, each instance walking the
    rays it gathers through its entry cull, timed against every ray
    through every instance, bit for bit the same hits), the first 2^15
    rays held against the whole fold through the plain versions bit for
    bit, a brute force in every instance's space;
    an instance of main's sphere (B1 serves the child), two of a
    compressed child (B4, B5), four of a child that mixes triangles, user
    spheres and a compressed subdivision mesh (the whole fold against
    the plain versions, and the hits the entry cull drops counted); the
    `instanced_geometry`, `user_geometry`, `intersection_filter` and
    `lazy_geometry` tutorials (each card frame against the CPU's, each
    card scene's primary rays through the kernels against the plain
    fold), `bvh_builder` (in the host pool) and `bvh_access`;
  * the wavefront pathtracer (phase 26): the `pathtracer` tutorial's
    Cornell box through `make_app().run --benchmark` (256x256, 4 spp)
    and at 1024x1024 (B2), glass_sphere.xml through `load_xml` at 64x64,
    6 seeds x 8 spp held against the reference binary's render by
    16x16-block means, and the same scene with its glass sphere replaced
    by main's 998,284 triangles at 1024x1024 (B1 and B2): frame ms, rays
    traced, launches, the card's busy share; each 64x64 1-spp frame
    against this package's CPU render with the same uniforms, and every
    B1 and B2 launch of that frame against its plain version;
  * differentiable rendering (phase 27): `DiffSubdivRenderer` over
    bomberman.obj at subdivision level 4 (372,224 triangles) on the demo
    camera's 1280x768 frame (its selection through B1, checked against the
    plain version on a strided slice), render / backward / step ms, peak
    memory, 5 steps of `make_train_step`, finite differences of the
    displacement amplitude and of kd, the cube of tests/test_diff_render.py
    against grad_subdiv_cube.npz; `freeze_hits` on main's 2^21 rays (B1)
    and `material_grads` for five materials against the CPU's; `path_grads`
    on the Cornell box at 256x256, 4 spp (B2), its image equal to
    `render_pt`'s, against the CPU at 16x16 and by a finite difference;
  * dynamic scenes and builders (phase 28): `dynamic_scene` at 512x512 (a
    re-commit every frame) and `viewer_anim` on a 99,012-triangle OBJ
    (BuildQuality.LOW), the morton tree of main's mesh built on the card
    and walked by B2 against its plain version and the SAH scene, and
    `buildbench`;
  * distribution (phase 29): NCCL at world 1 in this process
    (`sharded_intersect` field for field against `scene.intersect`, 5
    steps of `make_sharded_train_step` against unsharded autograd, the
    primitive-sharded ring with one shard against B1), gloo at world 4
    with four spawned ranks on the one card (the ring over 4 morton
    shards of main, DP and the train step against world 1, scalebench),
    each rank's launches and checks reported back; `benchmarks.run()`;
  * rays with NaN and Inf lanes (and NaN, +-Inf and -0.5 times) through
    all ten kernel entries against their plain versions, and 100,000
    rays from inside closed surfaces through B2, B6, B1, B4 and B5, none
    of which may miss.

Answers are checked against the plain versions, against brute-force
tests of every primitive, between the two triangle kernels, and against
autograd;
kernels are timed with CUDA events. Any failed phase ends the run with a
non-zero exit code; there is no CPU fallback. The last line of the
output is `{"ok": true, "device": {...}}`; the line `{"kernels": [...]}`
before it reports each kernel's launches on the driven paths, its error
against the plain version, its time, the plain version's time and its
roofline bound.
"""
from __future__ import annotations

import argparse
import contextlib
import io
import json
import math
import multiprocessing
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
import types

import numpy as np
import torch

if not torch.cuda.is_available():
    sys.stderr.write("chip_smoke: no CUDA device is available\n")
    sys.exit(1)

import embree_tpu_torch as ett  # noqa: E402
from embree_tpu_torch.build import native as sah_native  # noqa: E402
from embree_tpu_torch.build.treelets import (BLOCK_ROWS,  # noqa: E402
                                             build_treelet_scene)
from embree_tpu_torch.build.sah import BuildSettings, build_sah  # noqa: E402
from embree_tpu_torch.core import nvcc  # noqa: E402
from embree_tpu_torch.core.profile import global_profiler  # noqa: E402
from embree_tpu_torch.core.rayhit import Rays  # noqa: E402
from embree_tpu_torch.diff.hit import hit_t_grad, reeval_hit_verts  # noqa: E402
from embree_tpu_torch.render.camera import (  # noqa: E402
    Camera, pixel_coords, pixel_morton_order_device, primary_rays)
from embree_tpu_torch.render.image import read_pfm  # noqa: E402
from embree_tpu_torch.render.noise import fbm_displacement  # noqa: E402
from embree_tpu_torch.render.tutorials import (  # noqa: E402
    displacement_geometry as displacement_tutorial)
from embree_tpu_torch.render.tutorials import (  # noqa: E402
    motion_blur_geometry as mb_tutorial)
from embree_tpu_torch.render.tutorials import (  # noqa: E402
    triangle_geometry as tutorial)
from embree_tpu_torch.scene.prims import prim_bounds_np  # noqa: E402
from embree_tpu_torch.scene.scene import _scene_bytes  # noqa: E402
from embree_tpu_torch.core.math import normalize, rows_times  # noqa: E402
from embree_tpu_torch.render.tutorials import (  # noqa: E402
    interpolation as interp_tutorial)
from embree_tpu_torch.render.tutorials import (  # noqa: E402
    subdivision_geometry as subdiv_tutorial)
from embree_tpu_torch.render.tutorials import (  # noqa: E402
    viewer as viewer_tutorial)
from embree_tpu_torch.scene.scene import (scene_intersect,  # noqa: E402
                                          scene_occluded)
from embree_tpu_torch.scene.subdiv_accel import (  # noqa: E402
    SubdivEval, fused_normal_table, sample_normal_fused)
from embree_tpu_torch.subdiv.patches import (  # noqa: E402
    eval_patch_table, patch_tensors)
from embree_tpu_torch.traverse.cbvh import compressed_hits  # noqa: E402
from embree_tpu_torch.render.tutorials import (  # noqa: E402
    curve_geometry as curve_tutorial)
from embree_tpu_torch.render.tutorials import (  # noqa: E402
    hair_geometry as hair_tutorial)
from embree_tpu_torch.scene.scene import _fold, _fold_hair  # noqa: E402
from embree_tpu_torch.scene import scene as scene_mod  # noqa: E402
from embree_tpu_torch.scene.scene import _entry_cull, _to_local  # noqa: E402
from embree_tpu_torch.traverse import cbvh as cbvh_mod  # noqa: E402
from embree_tpu_torch.render.tutorials import (  # noqa: E402
    bvh_access, bvh_builder, instanced_geometry, intersection_filter,
    lazy_geometry, user_geometry)
from embree_tpu_torch.render.tutorials import (  # noqa: E402
    pathtracer as pt_tutorial)
from embree_tpu_torch.render.materials import (  # noqa: E402
    MAT_DIELECTRIC_SOLID)
from embree_tpu_torch.render.xmlloader import load_xml  # noqa: E402
from embree_tpu_torch.traverse import cbvh_kernel as ck  # noqa: E402
from embree_tpu_torch.traverse import hair_kernel as hk  # noqa: E402
from embree_tpu_torch.traverse.hair import _cone_hit  # noqa: E402
from embree_tpu_torch.traverse import mb_kernel as mk  # noqa: E402
from embree_tpu_torch.traverse import packet_kernel as pk  # noqa: E402
from embree_tpu_torch.traverse import rowtrace2 as rt2  # noqa: E402
from embree_tpu_torch.traverse.moeller import intersect_triangle  # noqa: E402
from embree_tpu_torch.traverse.packet import _finalize_hits  # noqa: E402
from embree_tpu_torch.traverse.stream import (sort_rays_stream,  # noqa: E402
                                              unsort_by_perm)
from embree_tpu_torch.verify.fixtures import (  # noqa: E402
    crossing_clusters, hair_ball, quad_sphere, random_triangles,
    subdiv_cube, triangle_sphere)
from embree_tpu_torch.build.bvh import BVHArraysNP, sah_cost  # noqa: E402
from embree_tpu_torch.build.morton import build_morton  # noqa: E402
from embree_tpu_torch.diff.materials import (  # noqa: E402
    FLOAT_FIELDS, freeze_hits, material_grads, path_grads)
from embree_tpu_torch.diff.render import (  # noqa: E402
    DiffSubdivRenderer, make_train_step)
from embree_tpu_torch.render.lights import (  # noqa: E402
    LIGHT_POINT, make_light_table)
from embree_tpu_torch.render.materials import (  # noqa: E402
    MAT_MATTE, MAT_METAL, MAT_METALLIC_PAINT, MAT_OBJ, MAT_VELVET,
    make_material_table)
from embree_tpu_torch.render.objloader import load_obj  # noqa: E402
from embree_tpu_torch.render.tutorials import (  # noqa: E402
    dynamic_scene as ds_tutorial)
from embree_tpu_torch.render.tutorials import (  # noqa: E402
    viewer_anim as va_tutorial)
from embree_tpu_torch.verify import buildbench  # noqa: E402
import torch.distributed as dist  # noqa: E402
from embree_tpu_torch.diff.hit import intersect_diff  # noqa: E402
from embree_tpu_torch.dist.prim_shard import (  # noqa: E402
    PrimShardedScene, build_prim_sharded, place_prim_sharded,
    prim_sharded_intersect)
from embree_tpu_torch.dist.sharding import (  # noqa: E402
    all_reduce_grads, gather_hits, make_mesh, make_sharded_train_step,
    run_world, shard_rays, sharded_intersect)
from embree_tpu_torch.traverse.packet import (  # noqa: E402
    intersect_chunked, occluded_chunked)
from embree_tpu_torch.verify import benchmarks, scalebench  # noqa: E402

SCENE_RES = 707            # triangle_sphere(707) = 998,284 triangles
SMALL_RES = 223            # triangle_sphere(223) = 99,012: under ROWTRACE_MIN_PRIMS
LOG2_RAYS = 21
RAY_SEED = 0xBE7C4
BRUTE_RAYS = 1024
B1_PLAIN_LOG2 = LOG2_RAYS  # rays of the main path B1's plain version re-walks
B2_VS_B1_LOG2 = 18         # rays of the main path B2 is held against B1 on
B2_PLAIN_LOG2 = 16         # rays B2's plain version walks at full scene size
FRAME = (1920, 1080)
TRAIN_STEPS = 5
TRAIN_LR = 1e-6
# how far the trainer's analytic gradient may lie from autograd's (both
# float32), relative to the largest entry
GRAD_TOL = 2e-4
# the compressed subdivision path: cage, levels and mode of its full-size
# scene, and the smaller cage the other modes run on
SUBDIV_CAGE = 64           # sphere_cage(64) = 64 x 62 = 3,968 quad faces
SUBDIV_LEVELS = (5, 3)     # 1,024 cells a face in 16 tiles of 64 cells
SUBDIV_SMALL_CAGE = 32
SUBDIV_SMALL_LEVELS = (4, 3)
B4_PLAIN_LOG2 = LOG2_RAYS  # main-c rays B4's and B5's plain versions walk
B4_SMALL_LOG2 = 16         # rays of the other modes' plain comparisons
# a conservative mode may report a hit this far behind the exact surface
# (the JAX package's own bound for its conservative modes)
CONSERVATIVE_EPS = 2e-2
CAGE_MODES = ("grid", "box")   # main-c's cage in the paper's other leaves
CAGE_TIMEOUT_S = 900       # a host-pool job, at most
GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                      "golden", "ref_triangle_geometry_128.pfm")

# published H100 SXM peaks the roofline bound is stated against
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12
# float32 operations of one slab test (12 for the six plane distances, 10
# min/max, 2 robust factors, 1 tnear clamp, 2 compares) and of one
# triangle test (9 Ng, 3 C, 9 R, 5 den, 3 x 6 for U V T, 3 more products
# and sums, 6 compares)
SLAB_FLOPS = 27
TRI_FLOPS = 53
# the packed leaves of the packet kernel carry Ng: 9 operations fewer
PACKED_TRI_FLOPS = TRI_FLOPS - 9
# float32 operations of the compressed walk, counted from csrc/cbvh.cu:
# tile entry (30 frame, 6 z slab, 4 x 16 edge lines, 14 min/max, 2 x 19
# projection, 30 normalisation and factors, 8 reciprocals), one inner node
# (28 decode + 4 slab tests), and one leaf by mode (box: slab, uv, z
# factor; leaf: slab, 4 heights, 2 bilinear sums, secant, world distance;
# grid: two triangle tests without precomputed normals)
TILE_ENTRY_FLOPS = 190
QUAD_NODE_FLOPS = 28 + 4 * SLAB_FLOPS
LEAF_FLOPS = {"box": SLAB_FLOPS + 16, "leaf": SLAB_FLOPS + 95,
              "grid": 2 * TRI_FLOPS + 10}
# the motion-blur path: knots 1 and 2 of main-mb (knot 0 is the sphere of
# the treelet path), the seed of its per-ray times, the rays B6's plain
# version walks, and the small scenes' rays
MB_KNOTS = ((0.8, 0.3, 0.0), (1.6, -0.4, 0.0))
MB_TIME_SEED = 0x7135
MB_PLAIN_LOG2 = 16
MB_SMALL_RAYS = 1 << 16
# float32 operations of the MB walk, counted from csrc/mb.cu: a child's
# box lerped to the ray's time (6 components of 2 products and a sum),
# its slab test and its time gate; one triangle test (9 lerps of 3
# operations, then the Moeller test without precomputed edges)
MB_SLAB_FLOPS = 18 + SLAB_FLOPS + 2
MB_TRI_FLOPS = 27 + TRI_FLOPS
# the hair path (kernel B3): main-hair is the hair_geometry tutorial's fur
# at 2^18 strands, tessellation 6; hairball-flat 2^16 random flat curves,
# K = 8; the rays B3's plain version walks, and the brute force's rays
HAIR_FUR_STRANDS = 1 << 18
HAIR_BALL_CURVES = 1 << 16
HAIR_SEED = 0x4A1B
HAIR_PLAIN_LOG2 = 16
HAIR_BRUTE_RAYS = 1 << 12
SOUP_RAYS = 1 << 14        # rays of the segment-soup and MB-curve scenes
# float32 operations of one B3 leaf test, counted from csrc/packet.cu:
# cone_hit (3 axis, 5 aa, 1 rr, 3 q, 5 x 5 dot products, 33 for A, B, C,
# 4 disc, 1 sqrt, 1 select, 2 x 3 roots, 3 for s, 5 compares) and
# ribbon_hit (5 dd, 6 differences, 2 x 6 depths, 12 projections, 3 ab,
# 6 denom, 8 s, 6 closest point, 5 dist2, 1 + 3 + 3 radius and depth,
# 4 compares); a node's child slab tests as for B2
# the paper's demo (build/bomberman.ecs, test_ref_golden.py:72-84)
GOLDEN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "tests", "golden")
DEMO_OBJ = os.path.join(GOLDEN_DIR, "bomberman.obj")
DEMO_LEVELS = (6, 3)
DEMO_SIZE = (1280, 768)
DEMO_GOLDEN_SIZE = (160, 96)
DEMO_CAMERA = dict(from_=(18.21240425, 20.05745888, 15.46878433),
                   to=(0.0, 0.0, 0.0), fov=90.0)
DEMO_FRAMES = 3            # timed frames of the viewer's benchmark
DEMO_SEED = 0xB0B
DEMO_CROP = (64, 48)       # the geometric-normal frame's crop on the CPU
DEMO_INTERP_LOG2 = 20      # random (face, u, v) of Scene.interpolate
TUTORIAL_SIZE = 512        # the phase 24 tutorials' frames
# inst-grid (phase 25): (a)'s sphere committed once, 8 x 8 instances of
# it at spacing 3, each rotated and scaled in [0.5, 1.5] from a seed, over
# a ground plane; the rays the whole fold re-walks through the plain
# versions, the rays of the brute force in every instance's space, and
# the rays through one instance of main's sphere (B1 serves the child)
INST_GRID = 8
INST_SPACING = 3.0
INST_SEED = 0x1A57
INST_PLAIN_LOG2 = 15
INST_BRUTE_LOG2 = 12
INST_B1_LOG2 = 17
INST_TUTORIAL_SIZE = (64, 48)   # the card's frames held against the CPU's
MIXED_SPHERES = np.asarray([[-3.0, 0.0, 0.0, 0.8], [0.0, 0.0, 3.5, 0.6],
                            [0.0, 2.6, 0.0, 0.5]], np.float32)  # x y z r
MIXED_CAGE_OFFSET = np.float32([5.0, 0.0, 0.0])
MIXED_INSTANCES = 4
MIXED_SPACING = 12.0
CONE_FLOPS = 87
RIBBON_FLOPS = 74
# a ray rotated into a cluster's frame: origin and direction, 9 products
# and 6 sums each
ROT_FLOPS = 30
# the pathtracer (phase 26): pt-cornell (the tutorial's Cornell box at its
# default 256x256 and at 1024x1024), pt-glass (glass_sphere.xml at 64x64,
# 6 seeds x 8 spp against the reference binary's render) and
# pt-glass-main (its sphere replaced by main's 998,284 triangles: B1
# serves the incoherent bounces and the shadow rays); spp of a timed frame,
# the frames timed, and the 64x64 1-spp frame held card against CPU with
# every B1 and B2 launch against its plain version (there ROWTRACE_MIN_RAYS
# is lowered to PT_CHECK_MIN_RAYS so that B1 serves the incoherent bounces
# of a treelet scene at that size). Before it is timed, a 1-spp frame at
# the timed size, with the kernels chosen as the main path chooses them,
# holds every launch against its plain version on a strided slice of at
# most 2^PT_SLICE_LOG2 of its rays
PT_SIZES = ((256, 256), (1024, 1024))
PT_SPP = 4
PT_FRAMES = 5
PT_SLICE_LOG2 = 16
PT_SEED = 0x9A7
PT_GLASS_XML = os.path.join(GOLDEN_DIR, "glass_sphere.xml")
PT_GLASS_SIZE = 64
PT_GLASS_SEEDS = 6
PT_GLASS_SPP = 8
PT_GLASS_CAMERA = dict(from_=(0.0, 1.2, 2.6), to=(0.0, 0.6, 0.0), fov=90.0)
PT_MAIN_SPHERE = ((0.0, 0.75, 0.0), 0.7, SCENE_RES)
PT_CHECK_SIZE = 64
PT_CHECK_MIN_RAYS = 1024
# differentiable rendering (phase 27): (a) the trainer on the paper's model,
# bomberman.obj (727 quads) at subdivision level 4 = 186,112 quads =
# 372,224 triangles (a treelet scene), over the demo camera's 1280x768 frame
# (983,040 rays: B1), tests/test_diff_render.py's sin-cos displacement at
# an amplitude of 1 % of the model's box diagonal, the finite differences'
# step a share of each parameter; (b) material gradients on main (2^21
# rays, a point light above the sphere) for tests/test_diff_materials.py's
# five materials; (c) path_grads on pt-cornell at 256x256, 4 spp, 8
# bounces, held card against CPU at 16x16, 1 spp
DIFF_LEVEL = 4
DIFF_AMP_SHARE = 1e-2
DIFF_FD_SHARE = 1e-3
DIFF_KD = (0.8, 0.5, 0.3)
DIFF_STEPS = 5
DIFF_LR = 5e-3
DIFF_LIGHT_P = (0.0, 5.0, 0.0)
DIFF_LIGHT = (10.0, 10.0, 10.0)
DIFF_MATERIALS = (
    {"type": MAT_MATTE, "kd": (0.4, 0.6, 0.2)},
    {"type": MAT_OBJ, "kd": (0.5, 0.3, 0.2), "ks": (0.4, 0.4, 0.4),
     "ns": 12.0},
    {"type": MAT_METAL, "ks": (0.9, 0.7, 0.5), "eta": 1.4, "k": 3.0,
     "roughness": 0.2},
    {"type": MAT_VELVET, "kd": (0.6, 0.2, 0.2), "ks": (0.3, 0.3, 0.3),
     "ns": 8.0, "roughness": 6.0},
    {"type": MAT_METALLIC_PAINT, "kd": (0.7, 0.2, 0.2), "eta": 1.6})
PG_SIZE = (256, 256)
PG_SPP = 4
PG_REPS = 3
PG_CHECK_SIZE = 16
# dynamic scenes and builders (phase 28): dynamic_scene's frames at
# 512x512 (a re-commit each), viewer_anim on (a)'s sphere written as an OBJ
# (99,012 triangles, committed at LOW), the morton tree of main's mesh on
# the card walked by B2, and buildbench at 100,000 prims
DYN_SIZE = 512
DYN_FRAMES = 5
BUILD_PRIMS = 100_000
# distribution (phase 29): (a) NCCL at world 1 in this process, (b) gloo
# at world DIST_WORLD in spawned ranks that all compute on cuda:0, main's
# mesh in DIST_WORLD morton shards for the ring, 2^LOG2_RAYS rays; the
# train step pulls the sphere, from rays leaving its center, toward
# DIST_TARGET of its radius
DIST_BACKEND = "nccl"
DIST_WORLD = 4
DIST_TARGET = 0.9
DIST_STEPS = 5
DIST_REPS = 5
DIST_SLICE_LOG2 = 16       # rays of a checked launch compared with plain
DIST_SCALE_RAYS = 262144   # scalebench's default batch


T_START = time.perf_counter()
T_WALL = time.time()    # the same instant on the clock the pool's workers share
PHASES = []     # (id, seconds since the start) of each "[id] ..." heading


def log(msg: str) -> None:
    """Print a line; a phase's heading ("[n] ...") gets the seconds since
    the script started."""
    if msg.startswith("["):
        at = time.perf_counter() - T_START
        PHASES.append((msg[1:msg.index("]")], at))
        msg = f"{msg}  (at {at:.0f} s)"
    print(msg, flush=True)


def phase_seconds():
    """Seconds of each phase, from its heading to the next heading (the
    last one's to now)."""
    ends = [at for _, at in PHASES[1:]] + [time.perf_counter() - T_START]
    return [(k, end - at) for (k, at), end in zip(PHASES, ends)]


def unit_dirs(rng, n):
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return d


def ulp_distance(a: torch.Tensor, b: torch.Tensor) -> int:
    """Largest distance in float32 steps between a and b (equal
    infinities are 0 apart; a NaN or unequal infinities fail)."""
    if torch.isnan(a).any() or torch.isnan(b).any():
        raise AssertionError("NaN in a traversal result")
    ia = a.view(torch.int32).long()
    ib = b.view(torch.int32).long()
    # map the sign-magnitude float order onto a monotone integer order
    ia = torch.where(ia < 0, -(ia & 0x7FFFFFFF), ia)
    ib = torch.where(ib < 0, -(ib & 0x7FFFFFFF), ib)
    return int((ia - ib).abs().max().item()) if a.numel() else 0


def compare_kernel_plain(ts, rays, occluded, cull, label):
    """Kernel (main and counting build) and plain version (counting) on
    the same card tensors: prim equal, t at 0 ulp, counters equal.
    Returns (max_abs_err, plain_ms, counters)."""
    t_k, p_k = rt2.intersect_rowtrace2(ts, rays, occluded=occluded, cull=cull)
    t_s, p_s, st_k = rt2.rowtrace2_stats(ts, rays, occluded=occluded,
                                         cull=cull)
    torch.cuda.synchronize()
    ev0 = torch.cuda.Event(enable_timing=True)
    ev1 = torch.cuda.Event(enable_timing=True)
    ev0.record()
    t_p, p_p, st_p = rt2.rowtrace2_plain(ts, rays, occluded=occluded,
                                         cull=cull, stats=True)
    ev1.record()
    torch.cuda.synchronize()
    plain_ms = ev0.elapsed_time(ev1)
    ulps, err = check_close(label, t_k, t_p, p_k, p_p)
    ulps_s, _ = check_close(label + " (counting build)", t_s, t_p, p_s, p_p)
    if ulps or ulps_s:
        raise AssertionError(f"{label}: t differs by {max(ulps, ulps_s)} ulp")
    if st_k != st_p:
        raise AssertionError(f"{label}: counters differ: {st_k} vs {st_p}")
    n = rays.tnear.numel()
    hits = int((t_k == -math.inf).sum()) if occluded else int((p_k >= 0).sum())
    log(f"  {label}: {n} rays, {hits} hits, prim equal, t at 0 ulp (max abs "
        f"err {err:g}), counters equal (per ray {st_k['mids_entered'] / n:.2f}"
        f" mids, {st_k['treelets_walked'] / n:.2f} treelets, "
        f"{st_k['node_visits'] / n:.2f} node visits, "
        f"{st_k['pair_tests'] / n:.2f} pair tests); plain (counting) "
        f"{plain_ms:.0f} ms")
    return err, plain_ms, st_k


def small_scene_checks(device):
    """Phase 3: kernel vs plain version on small scenes that cover the
    branches, each for closest, occluded and cull."""
    rng = np.random.default_rng(0x5EED)
    cases = []

    def scene(name, verts, idx, fan, org, d):
        v = np.asarray(verts, np.float32)[np.asarray(idx)]
        ts = build_treelet_scene(v[:, 0], v[:, 1], v[:, 2],
                                 np.arange(len(idx)), fan=fan)
        cases.append((f"{name} fan {fan} ({ts.num_mids} mids)",
                      ts.to_device(device),
                      ett.make_rays(org, d, device=device)))

    n = 2048
    verts, idx = random_triangles(rng, 2500, extent=5.0, size=1.2)
    scene("random_triangles(2500)", verts, idx, 8,
          rng.uniform(-8, 8, (n, 3)).astype(np.float32), unit_dirs(rng, n))
    verts, idx = triangle_sphere((0, 0, 0), 2.0, 24)
    scene("triangle_sphere(24), origins inside", verts, idx, 4,
          rng.uniform(-3, 3, (n, 3)).astype(np.float32), unit_dirs(rng, n))
    verts, idx = triangle_sphere((0, 0, 0), 2.0, 100)
    scene("triangle_sphere(100)", verts, idx, 48,
          rng.uniform(-3, 3, (n, 3)).astype(np.float32), unit_dirs(rng, n))
    verts, idx = triangle_sphere((0, 0, 0), 2.0, 200)
    scene("triangle_sphere(200)", verts, idx, 1,
          rng.uniform(-3, 3, (n, 3)).astype(np.float32), unit_dirs(rng, n))
    verts, idx = random_triangles(rng, 3000, extent=1.5, size=0.9)
    d = unit_dirs(rng, n)
    scene("converging rays, random_triangles(3000)", verts, idx, 2,
          -d * 6.0, d)
    # more than 256 mids: the kernel stages them in two chunks
    if not any(ts.num_mids > 256 for _, ts, _ in cases):
        raise AssertionError("no small scene has more than 256 mids")
    # leaf pairs 128..255 of a treelet (the second chunk of a block row)
    if not any((ts.pairs[:, 128:, 18].view(torch.int32) >= 0).any()
               for _, ts, _ in cases):
        raise AssertionError("no small scene fills the second leaf chunk")
    if not any(ts.fan > 32 for _, ts, _ in cases):
        raise AssertionError("no small scene has a fan above 32")

    worst = 0.0
    for name, ts, rays in cases:
        for mode, occluded, cull in (("closest", False, False),
                                     ("occluded", True, False),
                                     ("cull", False, True)):
            err, _, _ = compare_kernel_plain(ts, rays, occluded, cull,
                                             f"{name}, {mode}")
            worst = max(worst, err)
    return worst


def time_ms(fn, reps: int = 5):
    """Median of `reps` CUDA-event timings after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        ev0 = torch.cuda.Event(enable_timing=True)
        ev1 = torch.cuda.Event(enable_timing=True)
        ev0.record()
        fn()
        ev1.record()
        torch.cuda.synchronize()
        out.append(ev0.elapsed_time(ev1))
    return float(np.median(out))


def roofline_bound(ts, stats):
    """Least time the card could take for what this run's rays needed:
    the larger of bytes / memory rate (rays in, (t, prim) out, the box
    tables and every touched block once) and counted float32 operations
    / the non-tensor fp32 peak.

    The bytes term still counts the JAX package's 128-lane blocks (a
    touched treelet's BLOCK_ROWS rows of 512 bytes, mid boxes as 6 rows
    of 128 lanes), not the compact records the kernel now reads (48-byte
    nodes, 80-byte pairs, 32-byte boxes). It is kept only so that the
    kernel before and after the compact form is held to one bound; the
    operations term is the larger today. Once the bound moves to bytes it
    has to count the compact records."""
    rays = stats["rays"]
    nbytes = (rays * (8 * 4 + 2 * 4)
              + stats["treelets_touched"] * BLOCK_ROWS * 128 * 4
              + ts.num_mids * 6 * 4 + ts.num_mids * 6 * 128 * 4)
    slabs = (rays * ts.num_mids + stats["mids_entered"] * ts.fan
             + stats["node_visits"] * 4)
    flops = slabs * SLAB_FLOPS + stats["pair_tests"] * 2 * TRI_FLOPS
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    flops_ms = flops / PEAK_FP32_PER_S * 1e3
    return {"bytes": nbytes, "flops": flops, "bytes_ms": bytes_ms,
            "flops_ms": flops_ms, "bound_ms": max(bytes_ms, flops_ms),
            "bound_by": "bytes" if bytes_ms >= flops_ms else "operations"}


def check_close(name, t_k, t_p, p_k, p_p):
    """prim equal, t within 1 ulp, same finite mask: (ulps, max abs err)
    of t. The callers that hold a kernel at 0 ulp raise on ulps > 0."""
    if not torch.equal(p_k, p_p):
        n = int((p_k != p_p).sum())
        raise AssertionError(f"{name}: prim differs on {n} rays")
    ulps = ulp_distance(t_k, t_p)
    if ulps > 1:
        raise AssertionError(f"{name}: t differs by {ulps} ulp")
    fin = torch.isfinite(t_k) & torch.isfinite(t_p)
    if not torch.equal(torch.isfinite(t_k), torch.isfinite(t_p)):
        raise AssertionError(f"{name}: finite masks differ")
    return ulps, float((t_k[fin] - t_p[fin]).abs().max()) if fin.any() else 0.0


def compare_packet_plain(ps, rays, occluded, cull, label, ray_mask=None):
    """Packet kernel (main and counting build) and plain version on the
    same card tensors: prim equal, t at 0 ulp, counters equal, no
    dropped push. Returns (max_abs_err, plain_ms)."""
    t_k, p_k, _ = pk.packet_trace(ps, rays, occluded, cull, ray_mask)
    t_s, p_s, st_k = pk.packet_trace(ps, rays, occluded, cull, ray_mask,
                                     stats=True)
    torch.cuda.synchronize()
    ev0 = torch.cuda.Event(enable_timing=True)
    ev1 = torch.cuda.Event(enable_timing=True)
    ev0.record()
    t_p, p_p, st_p = pk.packet_plain(ps, rays, occluded, cull,
                                     ray_mask=ray_mask, stats=True)
    ev1.record()
    torch.cuda.synchronize()
    plain_ms = ev0.elapsed_time(ev1)
    ulps, err = check_close(label, t_k, t_p, p_k, p_p)
    ulps_s, _ = check_close(label + " (counting build)", t_s, t_p, p_s, p_p)
    if ulps or ulps_s:
        raise AssertionError(f"{label}: t differs by {max(ulps, ulps_s)} ulp")
    if st_k != st_p:
        raise AssertionError(f"{label}: counters differ: {st_k} vs {st_p}")
    if st_k["dropped_pushes"] != 0:
        raise AssertionError(f"{label}: {st_k['dropped_pushes']} dropped "
                             "pushes")
    if occluded and not torch.equal(p_k, torch.full_like(p_k, -1)):
        raise AssertionError(f"{label}: the occluded variant wrote a prim")
    hits = int((t_k == -math.inf).sum()) if occluded else int((p_k >= 0).sum())
    log(f"  {label}: {rays.tnear.numel()} rays, {hits} hits, prim equal, "
        f"t at 0 ulp (max abs err {err:g}), counters equal "
        f"({st_k['node_visits']} node visits, {st_k['tri_tests']} triangle "
        f"tests, 0 dropped), plain {plain_ms:.0f} ms")
    return err, plain_ms


def packed_scene(verts, idx, width, device, prim_mask=None):
    v = np.asarray(verts, np.float32)[np.asarray(idx)]
    v0, v1, v2 = (np.ascontiguousarray(v[:, k]) for k in range(3))
    lo, hi = prim_bounds_np(v0, v1, v2)
    bvh = build_sah(lo, hi, BuildSettings(branching_factor=width))
    return pk.compact_scene(pk.pack_scene(bvh, (v0, v1, v2), "cpu",
                                          prim_mask=prim_mask), device)


def packet_small_scene_checks(device):
    """Packet kernel vs plain version on small scenes that cover: BVH4
    and BVH8, leaves that straddle two leaf rows, closest / occluded /
    cull, masks, a one-triangle scene, 7 and 1,025 rays, retired rays."""
    rng = np.random.default_rng(0xB2)
    worst = 0.0

    def rays_for(n, extent):
        org = rng.uniform(-extent, extent, (n, 3)).astype(np.float32)
        r = ett.make_rays(org, unit_dirs(rng, n), device=device)
        # every fifth ray is retired (tfar = -inf): one node visit each
        tf = r.tfar.clone()
        tf[::5] = -math.inf
        return r._replace(tfar=tf)

    scenes = []
    verts, idx = random_triangles(rng, 2500, extent=5.0, size=1.2)
    for w in (4, 8):
        scenes.append((f"random_triangles(2500) BVH{w}",
                       packed_scene(verts, idx, w, device), 8.0, 2048))
    verts, idx = triangle_sphere((0, 0, 0), 2.0, 24)
    for w in (4, 8):
        scenes.append((f"triangle_sphere(24) BVH{w}, origins inside",
                       packed_scene(verts, idx, w, device), 3.0, 1025))
    verts, idx = random_triangles(rng, 10, extent=5.0, size=2.0)
    scenes.append(("random_triangles(10) BVH4",
                   packed_scene(verts, idx, 4, device), 5.0, 7))
    scenes.append(("one triangle BVH4", packed_scene(
        np.array([[-1, -1, 0], [1, -1, 0], [0, 1, 0]], np.float32),
        np.array([[0, 1, 2]], np.int32), 4, device), 1.0, 1025))
    for name, ps, extent, n in scenes:
        rays = rays_for(n, extent)
        for mode, occluded, cull in (("closest", False, False),
                                     ("occluded", True, False),
                                     ("cull", False, True)):
            err, _ = compare_packet_plain(ps, rays, occluded, cull,
                                          f"{name}, {mode}")
            worst = max(worst, err)
    # a leaf whose triangles lay in two of the JAX package's leaf rows:
    # start % 10 + count > 10
    straddle = False
    for _name, ps, _e, _n in scenes:
        w = ps.width
        start, count = (x.cpu().numpy() for x in pk.pulled_refs(
            ps.nodes[:, 6 * w:7 * w].contiguous().view(torch.int32)))
        straddle |= bool(((count > 0) & (start % 10 + count > 10)).any())
    if not straddle:
        raise AssertionError("no small scene has a leaf over two leaf rows")
    # masks: two geometry masks over one soup, ray masks 0..3
    verts, idx = random_triangles(rng, 2500, extent=5.0, size=1.2)
    prim_mask = (1 + (np.arange(len(idx)) % 2)).astype(np.int32)
    for w in (4, 8):
        ps = packed_scene(verts, idx, w, device, prim_mask=prim_mask)
        rays = rays_for(2048, 8.0)
        rm = torch.from_numpy(
            rng.integers(0, 4, 2048).astype(np.int32)).to(device)
        for mode, occluded in (("closest", False), ("occluded", True)):
            err, _ = compare_packet_plain(
                ps, rays, occluded, False, f"masked BVH{w}, {mode}",
                ray_mask=rm)
            worst = max(worst, err)
        t_m, _p, _ = pk.packet_trace(ps, rays, ray_mask=rm)
        t_u, _p, _ = pk.packet_trace(ps, rays)
        if torch.equal(t_m, t_u):
            raise AssertionError("the masks changed no answer")
    return worst


def brute_check(label, tris, flat: Rays, valid, t, keep=None, ray_mask=None,
                prim_mask=None):
    """The first BRUTE_RAYS rays (evenly strided over the batch) against
    every triangle; `keep` (T,) bool drops triangles, the masks drop
    (triangle, ray) pairs."""
    n = flat.tnear.shape[0]
    sel = torch.linspace(0, n - 1, BRUTE_RAYS, device=t.device).long()
    br = Rays(*(a[sel].contiguous() for a in flat))
    best = br.tfar.clone()
    hit = torch.zeros(BRUTE_RAYS, dtype=torch.bool, device=t.device)
    for s in range(0, tris.num_prims, 65536):
        e = s + 65536
        ok, tt, _u, _v, _ng = intersect_triangle(
            br.org[:, None, :], br.dir[:, None, :], br.tnear[:, None],
            br.tfar[:, None], tris.v0[None, s:e], tris.v1[None, s:e],
            tris.v2[None, s:e])
        if keep is not None:
            ok &= keep[None, s:e]
        if ray_mask is not None:
            ok &= (prim_mask[None, s:e] & ray_mask[sel][:, None]) != 0
        tt = torch.where(ok, tt, torch.full_like(tt, math.inf)).min(dim=1)
        hit |= torch.isfinite(tt.values)
        best = torch.minimum(best, tt.values)
    k_valid, k_t = valid.reshape(-1)[sel], t.reshape(-1)[sel]
    if not torch.equal(hit, k_valid):
        raise AssertionError(f"{label}: brute force: valid masks differ on "
                             f"{int((hit != k_valid).sum())} rays")
    rel = (float(((best - k_t).abs() / k_t.abs())[k_valid].max())
           if k_valid.any() else 0.0)
    if not rel <= 1e-5:
        raise AssertionError(f"{label}: brute force: t differs by {rel:g} "
                             "relative")
    log(f"  {label}: brute force over all triangles, {BRUTE_RAYS} rays: same "
        f"valid mask ({int(hit.sum())} hits), t within {rel:g} relative")


class Launches:
    """Sets every kernel's launch count to 0 on entry, reads them on
    exit and adds them to the run's totals."""

    totals = {"rowtrace2": 0, "packet": 0, "cbvh": 0, "cbvh_occluded": 0,
              "mb": 0, "mb_occluded": 0, "hair_cone": 0, "hair_ribbon": 0,
              "hair_cone_occluded": 0, "hair_ribbon_occluded": 0}

    def __enter__(self):
        rt2.launches = 0
        pk.launches = 0
        ck.launches["closest"] = ck.launches["occluded"] = 0
        mk.launches["closest"] = mk.launches["occluded"] = 0
        for k in hk.launches:
            hk.launches[k] = 0
        return self

    def __exit__(self, *exc):
        self.rowtrace2, self.packet = rt2.launches, pk.launches
        self.cbvh = ck.launches["closest"]
        self.cbvh_occluded = ck.launches["occluded"]
        self.mb = mk.launches["closest"]
        self.mb_occluded = mk.launches["occluded"]
        for k, v in hk.launches.items():
            setattr(self, "hair_" + k, v)
        for k in Launches.totals:
            Launches.totals[k] += getattr(self, k)
        return False

    def expect_hair(self, what, cs, closest, occluded):
        """`closest` intersect and `occluded` occluded requests on `cs`:
        one B3 launch a request and leaf type, over all its clusters."""
        want = {k: 0 for k in hk.launches}
        for flat, _first, _count in cs.hair_set.packed.runs():
            leaf = "ribbon" if flat else "cone"
            want[leaf] += closest
            want[leaf + "_occluded"] += occluded
        got = {k: getattr(self, "hair_" + k) for k in hk.launches}
        if got != want:
            raise AssertionError(f"{what}: B3 launches {got}, expected {want}")

    def expect_mb(self, what, closest, occluded):
        if (self.mb, self.mb_occluded) != (closest, occluded):
            raise AssertionError(
                f"{what}: {self.mb} mb and {self.mb_occluded} mb_occluded "
                f"launches, expected {closest} and {occluded}")

    def expect_cbvh(self, what, closest, occluded):
        if (self.cbvh, self.cbvh_occluded) != (closest, occluded):
            raise AssertionError(
                f"{what}: {self.cbvh} cbvh and {self.cbvh_occluded} "
                f"cbvh_occluded launches, expected {closest} and {occluded}")

    def expect(self, what, rowtrace2, packet):
        if (self.rowtrace2, self.packet) != (rowtrace2, packet):
            raise AssertionError(
                f"{what}: {self.rowtrace2} rowtrace2 and {self.packet} "
                f"packet launches, expected {rowtrace2} and {packet}")


def flat_rays(rays: Rays) -> Rays:
    return Rays(rays.org.reshape(-1, 3).contiguous(),
                rays.dir.reshape(-1, 3).contiguous(),
                rays.tnear.reshape(-1).contiguous(),
                rays.tfar.reshape(-1).contiguous())


def check_hits(label, hits, shape):
    if hits.t.shape != shape or hits.ng.shape != shape + (3,):
        raise AssertionError(f"{label}: wrong output shapes")
    valid = hits.valid
    if not (torch.isfinite(hits.t[valid]).all()
            and torch.isfinite(hits.ng).all()
            and (hits.u[valid] >= 0).all() and (hits.v[valid] >= 0).all()
            and (hits.u[valid] + hits.v[valid] <= 1.0 + 1e-4).all()
            and torch.isinf(hits.t[~valid]).all()):
        raise AssertionError(f"{label}: hit fields out of range")


def packet_bound(ps, st):
    """Least time the card could take for what this run's rays needed
    of the packet kernel: the larger of bytes / memory rate (rays in,
    (t, prim) out, the used part of every touched node row and leaf row
    once) and counted float32 operations / the non-tensor fp32 peak.

    A touched leaf row is still counted as the ten triangles of a row of
    the JAX package's layout (`rows_touched`), which the compact form's
    back-to-back triangle records no longer group: kept so that the
    kernel before and after the compact form is held to one bound."""
    nbytes = (st["rays"] * (8 * 4 + 2 * 4)
              + st["nodes_touched"] * 8 * ps.width * 4
              + st["rows_touched"] * pk.NT_PER_ROW * pk.TRI_FLOATS * 4)
    flops = (st["node_visits"] * ps.width * SLAB_FLOPS
             + st["tri_tests"] * PACKED_TRI_FLOPS)
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    flops_ms = flops / PEAK_FP32_PER_S * 1e3
    return {"bytes": nbytes, "flops": flops, "bytes_ms": bytes_ms,
            "flops_ms": flops_ms, "bound_ms": max(bytes_ms, flops_ms),
            "bound_by": "bytes" if bytes_ms >= flops_ms else "operations"}


def packet_times(label, ps, flat, cull=False):
    """Times, counters and bound of the packet kernel on one batch."""
    out = {}
    n = flat.tnear.shape[0]
    for mode, occl in (("closest", False), ("occluded", True)):
        ms = time_ms(lambda: pk.packet_trace(ps, flat, occl, cull))
        _t, _p, st = pk.packet_trace(ps, flat, occl, cull, stats=True)
        if st["dropped_pushes"] != 0:
            raise AssertionError(f"{label}: dropped pushes")
        bound = packet_bound(ps, st)
        out[mode] = {"ms": ms, "stats": st, "bound": bound}
        log(f"  packet {mode}, {label}, {n} rays: {ms:.3f} ms, "
            f"{n / ms / 1e3:.1f} Mray/s; per ray "
            f"{st['node_visits'] / n:.2f} node visits, "
            f"{st['tri_tests'] / n:.2f} triangle tests; "
            f"{st['nodes_touched']} of {ps.num_nodes} node rows and "
            f"{st['rows_touched']} of {pk.leaf_rows(ps.num_prims)} leaf rows "
            "of ten triangles touched; "
            f"bound {bound['bound_ms']:.4f} ms by {bound['bound_by']} "
            f"(bytes {bound['bytes'] / 1e6:.1f} MB -> "
            f"{bound['bytes_ms']:.4f} ms, operations "
            f"{bound['flops'] / 1e9:.2f} GFLOP -> {bound['flops_ms']:.4f} ms)"
            f": {100 * bound['bound_ms'] / ms:.1f} % of the kernel's time")
    return out


def bvh8_phase(verts, idx, rays, frame, hits4):
    """Phase 8b, main-bvh8: main's mesh committed under
    `tri_accel=bvh8.triangle4.packet` (no treelet scene: B2 at W = 8
    serves every request) through the entry points on main's 2^21 rays
    (closest and any hit) and the coherent frame; B2 against its plain
    version at 0 ulp on 2^16 strided rays and the frame's, against a brute
    force, and against the BVH4 scene's answer `hits4` on the same rays
    (valid equal, t within 1e-6 relative, prim ties counted); node count,
    depth, bytes, times, visits and bounds. Returns B2's largest error."""
    dev = ett.Device("ignore_config_files=1,tri_accel=bvh8.triangle4.packet")
    scene8 = ett.Scene(dev)
    scene8.attach(ett.TriangleMesh(verts, idx))
    t0 = time.perf_counter()
    cs8 = scene8.commit()
    torch.cuda.synchronize()
    commit_s = time.perf_counter() - t0
    ps = cs8.packet
    if cs8.rowtrace is not None or ps.width != 8:
        raise AssertionError("main-bvh8 is not a BVH8 packet scene")
    log(f"  commit {commit_s:.2f} s")
    packet_bytes_line("main-bvh8 committed", ps)
    n = rays.tnear.numel()
    with Launches() as lc:
        h8 = scene8.intersect(rays)
        o8 = scene8.occluded(rays)
        hf8 = scene8.intersect(frame, coherent=True)
        torch.cuda.synchronize()
    lc.expect("main-bvh8: 2 intersect + 1 occluded requests", 0, 3)
    check_hits("main-bvh8", h8, (n,))
    check_hits("main-bvh8 frame", hf8, (FRAME[1], FRAME[0]))
    if not torch.equal(o8, h8.valid):
        raise AssertionError("main-bvh8: occluded disagrees with valid")
    v4 = hits4.valid
    if not torch.equal(h8.valid, v4):
        raise AssertionError(f"main-bvh8: valid differs from the BVH4 "
                             f"scene's on {int((h8.valid != v4).sum())} rays")
    rel = float(((h8.t - hits4.t).abs() / hits4.t.abs())[v4].max())
    ties = int((h8.prim_id != hits4.prim_id)[v4].sum())
    if not rel <= 1e-6:
        raise AssertionError(f"main-bvh8: t {rel:g} relative off the BVH4 "
                             "scene's")
    log(f"  main-bvh8 against the BVH4 scene (B1) on the 2^{LOG2_RAYS} "
        f"rays: valid equal ({int(v4.sum())} hits), t within {rel:g} "
        f"relative, prim differs on {ties} hits (ties)")
    step = max(1, n >> 16)
    strided = Rays(*(a[::step][:1 << 16].contiguous() for a in rays))
    err = 0.0
    for label, r, occl in (
            (f"2^16 rays of the main path (one in {step}), closest",
             strided, False),
            (f"2^16 rays of the main path (one in {step}), any hit",
             strided, True)):
        e, _ = compare_packet_plain(ps, r, occl, False, "main-bvh8, " + label)
        err = max(err, e)
    frame_flat = flat_rays(frame)
    nf = frame_flat.tnear.numel()
    fstep = max(1, nf >> 16)
    fr = Rays(*(a[::fstep][:1 << 16].contiguous() for a in frame_flat))
    e, _ = compare_packet_plain(ps, fr, False, False, "main-bvh8, 2^16 rays "
                                f"of the frame (one in {fstep}), closest")
    err = max(err, e)
    brute_check("main-bvh8", cs8.tris, rays, h8.valid, h8.t)
    packet_times("main-bvh8, 2^21 incoherent", ps, rays)
    packet_times("main-bvh8, coherent frame", ps, frame_flat)
    for label, fn in (
            ("intersect request, main-bvh8, 2^21 rays",
             lambda: scene8.intersect(rays)),
            ("occluded request, main-bvh8, 2^21 rays",
             lambda: scene8.occluded(rays)),
            ("intersect request, main-bvh8, coherent frame",
             lambda: scene8.intersect(frame, coherent=True))):
        log(f"  {label}: {time_ms(fn):.3f} ms")
    return err


def shell_rays(rng, n, radius, jitter, device, retire_every=0):
    """Rays from a shell of `radius` aimed at the origin with `jitter`;
    every `retire_every`-th ray is retired (tfar = -inf)."""
    org = rng.normal(size=(n, 3)).astype(np.float32)
    org = org / np.linalg.norm(org, axis=1, keepdims=True) * radius
    d = -org / radius + rng.normal(size=(n, 3)).astype(np.float32) * jitter
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    r = ett.make_rays(org, d, device=device)
    if retire_every:
        tf = r.tfar.clone()
        tf[::retire_every] = -math.inf
        r = r._replace(tfar=tf)
    return r


def sine_displacement(p, ng, u, v):
    return (p + 0.15 * ng * np.sin(5 * p[..., :1])).astype(np.float32)


def noise_displacement(p, ng, u, v):
    """fBm noise along the normal, as the displacement_geometry tutorial."""
    return (p + fbm_displacement(p)[..., None] * ng).astype(np.float32)


def sphere_cage(n, displacement):
    """quad_sphere((0,0,0), 2.0, n) without its two rows of pole faces, as
    a mesh tuple for `subdiv_scene`. A pole face has an edge of length 0;
    the compressed build (this package's and the JAX package's alike)
    gives the tiles at such an edge a degenerate frame and world boxes as
    large as the whole sphere (unbounded from n = 32 on), which every ray
    then enters and `occluded` reports for every ray (ROADMAP.md C). The
    open sphere has none."""
    verts, quads = quad_sphere((0.0, 0.0, 0.0), 2.0, n)
    quads = quads[n:-n]
    return (verts, np.full(len(quads), 4, np.int32), quads.reshape(-1),
            displacement)


def subdiv_scene(device_cfg, mesh, levels, mode=None, flavor="com",
                 plane=False):
    """Commit `mesh` = (verts, counts, indices, displacement) under the
    given compressed mode (None: eager tessellation through the packet
    kernel's BVH only)."""
    cfg = "ignore_config_files=1" + device_cfg
    cfg += (f",subdiv_accel=bvh4.compressed.{mode},compressed_node={flavor}"
            if mode else ",tri_accel=bvh4.triangle4.packet")
    scene = ett.Scene(ett.Device(cfg))
    if plane:
        scene.attach(ett.TriangleMesh(
            np.array([[-10, -3.5, -10], [-10, -3.5, 10], [10, -3.5, -10],
                      [10, -3.5, 10]], np.float32),
            np.array([[0, 1, 2], [1, 3, 2]], np.int32)))
    verts, counts, indices, displacement = mesh
    scene.attach(ett.SubdivMesh(verts, counts, indices,
                                displacement=displacement))
    scene.set_levels(*levels)
    scene.commit()
    return scene


def commit_cage(mode):
    """main-c's cage committed on the host (`device=cpu`) in `mode`; a job
    of the host pool, run beside the card's phases. Returns the committed
    scene as `torch.save` bytes and the wall-clock time it finished."""
    torch.set_num_threads(1)
    mesh = sphere_cage(SUBDIV_CAGE, noise_displacement)
    t0 = time.perf_counter()
    sc = subdiv_scene(",device=cpu", mesh, SUBDIV_LEVELS, mode)
    commit_s = time.perf_counter() - t0
    buf = io.BytesIO()
    torch.save({"cs": sc.committed, "commit_s": commit_s,
                "faces": len(mesh[1])}, buf)
    return buf.getvalue(), time.time()


def run_bvh_builder():
    """The `bvh_builder` tutorial (rtcBuildBVH over 20,000 boxes, host
    numpy, no kernel); a job of the host pool. Returns its exit code,
    its lines and its seconds."""
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = bvh_builder.main(["-rtcore", "ignore_config_files=1"])
    return rc, out.getvalue().splitlines(), time.perf_counter() - t0


def join_cage_commits(jobs, device):
    """Wait for the host pool's commits and load each committed scene onto
    `device`: {mode: (CommittedScene, commit s, load s, faces)}."""
    out = {}
    t0 = time.perf_counter()
    for mode, job in jobs.items():
        blob, done = job.get(timeout=CAGE_TIMEOUT_S)
        t1 = time.perf_counter()
        saved = torch.load(io.BytesIO(blob), map_location=device,
                           weights_only=False)
        torch.cuda.synchronize()
        out[mode] = (saved["cs"], saved["commit_s"],
                     time.perf_counter() - t1, saved["faces"])
        log(f"  the {mode} commit ({saved['commit_s']:.1f} s) finished "
            f"{done - T_WALL:.0f} s after the start")
    log(f"  waited {time.perf_counter() - t0:.1f} s for the host pool and "
        "the loads")
    return out


def cage_modes_phase(cages, rays, frame, leaf_hits, leaf_frame_hits,
                     eager_hits):
    """Phase 12b: main-c's cage in `grid` and `box` mode (committed by
    `start_cage_commits`) through `scene_intersect` / `scene_occluded` on
    main's 2^21 rays and the 1920x1080 frame: B4 and B5 against their
    plain versions at 0 ulp on 2^B4_SMALL_LOG2 strided rays, the hit
    fields, every hit occluded, `box` conservative against main-c's leaf
    hits, `grid` beside the eager triangles; commit s, device bytes,
    times, counters and bounds. Returns B4's and B5's largest errors."""
    n = rays.tnear.numel()
    step = n >> B4_SMALL_LOG2
    strided = Rays(*(a[::step][:1 << B4_SMALL_LOG2].contiguous()
                     for a in rays))
    frame_flat = flat_rays(frame)
    err = occ_err = 0.0
    for mode, (cs, commit_s, load_s, faces) in cages.items():
        pc = cs.compressed_kernel
        tiles_a_face = (1 << (SUBDIV_LEVELS[0] - SUBDIV_LEVELS[1])) ** 2
        if (pc is None or pc.mode != mode or cs.tris.num_prims != 0
                or pc.num_tiles != faces * tiles_a_face
                or cs.compressed.tiles.space is not None
                or pc.tiles.device.type != rays.tnear.device.type):
            raise AssertionError(f"{mode}: not main-c's cage as a compact "
                                 "accel on the card")
        log(f"  {mode}: commit {commit_s:.1f} s on the host (a worker of "
            f"the host pool), loaded onto the card in {load_s:.2f} s; "
            f"{pc.num_tiles} tiles, top BVH4 of {pc.num_nodes} nodes in "
            f"{pc.top_depth} levels; a tile uses {tile_used_bytes(pc)} B in "
            f"a compact record of {4 * pc.tiles.shape[1]} B (the JAX "
            f"package's rows: {tile_row_bytes(pc)} B); the compact accel "
            f"{pc.device_bytes / 1e6:.1f} MB (the rows "
            f"{packed_row_bytes(pc) / 1e6:.1f} MB), the committed scene "
            f"{_scene_bytes(cs) / 1e6:.1f} MB")
        with Launches() as lc:
            h = scene_intersect(cs, rays)
            o = scene_occluded(cs, rays)
            hf = scene_intersect(cs, frame, coherent=True)
            of = scene_occluded(cs, frame)
            torch.cuda.synchronize()
        lc.expect(f"{mode} requests", 0, 0)
        lc.expect_cbvh(f"{mode}: 2 intersect + 2 occluded requests", 2, 2)
        check_subdiv_hits(f"{mode}, incoherent", h, (n,), faces)
        check_subdiv_hits(f"{mode}, frame", hf, (FRAME[1], FRAME[0]), faces)
        for label, hh, oo in (("incoherent", h, o), ("frame", hf, of)):
            if (hh.valid & ~oo).any():
                raise AssertionError(f"{mode}, {label}: a hit is not "
                                     "occluded")
            frac = float(hh.valid.float().mean())
            if not 0.05 < frac < 0.9:
                raise AssertionError(f"{mode}, {label}: hit fraction {frac}")
            log(f"  {mode}, {label}: hit fraction {frac:.4f}, occluded "
                f"{float(oo.float().mean()):.4f}, occluded covers every hit")
        e, _, _, oe = compare_cbvh_plain(
            pc, strided, f"{mode}, {pc.num_tiles} tiles, 2^{B4_SMALL_LOG2} "
            f"rays of the main path (one in {step})")
        err, occ_err = max(err, e), max(occ_err, oe)
        if mode == "box":
            check_conservative("box vs main-c's leaf hits, incoherent",
                               leaf_hits, h)
            check_conservative("box vs main-c's leaf hits, frame",
                               leaf_frame_hits, hf)
        else:
            same = float((h.valid == eager_hits.valid).float().mean())
            both = h.valid & eager_hits.valid
            dabs = (h.t - eager_hits.t)[both].abs()
            log(f"  grid vs the eager triangles of phase 9: valid equal on "
                f"{100 * same:.4f} % of the rays, |dt| 99th percentile "
                f"{float(dabs.quantile(0.99)):.3g}, max "
                f"{float(dabs.max()):.3g} (cells split along the other "
                "diagonal)")
        cbvh_times(f"{pc.num_tiles} tiles {mode}, 2^{LOG2_RAYS} incoherent",
                   pc, rays)
        cbvh_times(f"{pc.num_tiles} tiles {mode}, {FRAME[0]}x{FRAME[1]} "
                   "coherent frame", pc, frame_flat)
        for label, fn in (
                ("intersect request, 2^21 rays",
                 lambda: scene_intersect(cs, rays)),
                ("occluded request, 2^21 rays",
                 lambda: scene_occluded(cs, rays)),
                ("intersect request, coherent frame",
                 lambda: scene_intersect(cs, frame, coherent=True))):
            log(f"  {mode} {label}: {time_ms(fn):.3f} ms")
    return err, occ_err


def compare_cbvh_plain(pc, rays, label, t_in=None):
    """Both compressed kernels (main and counting builds) and their plain
    versions on the same card tensors: tile equal, t, u, v at 0 ulp,
    occlusion equal, counters equal, no dropped push. Returns
    (max abs err of t, plain_ms closest, plain_ms occluded, rays whose
    occlusion answer differs)."""
    t_k, u_k, v_k, tile_k, _ = ck.cbvh_trace(pc, rays, t_in)
    t_s, u_s, v_s, tile_s, st_k = ck.cbvh_trace(pc, rays, t_in, stats=True)
    torch.cuda.synchronize()
    flat = Rays(rays.org.reshape(-1, 3), rays.dir.reshape(-1, 3),
                rays.tnear.reshape(-1),
                (rays.tfar if t_in is None else t_in).reshape(-1))
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    ev[0].record()
    t_p, u_p, v_p, tile_p, st_p = ck.cbvh_plain(pc, flat, stats=True)
    ev[1].record()
    occ_p, so_p = ck.cbvh_occluded_plain(pc, rays, stats=True)
    ev[2].record()
    torch.cuda.synchronize()
    plain_ms = ev[0].elapsed_time(ev[1])
    plain_occ_ms = ev[1].elapsed_time(ev[2])
    for name, tk, uk, vk, tilek in (("", t_k, u_k, v_k, tile_k),
                                    (" (counting build)", t_s, u_s, v_s,
                                     tile_s)):
        if not torch.equal(tilek, tile_p):
            raise AssertionError(f"{label}{name}: tile differs on "
                                 f"{int((tilek != tile_p).sum())} rays")
        for what, a, b in (("t", tk, t_p), ("u", uk, u_p), ("v", vk, v_p)):
            ulps = ulp_distance(a, b)
            if ulps != 0:
                raise AssertionError(f"{label}{name}: {what} differs by "
                                     f"{ulps} ulp")
    if st_k != st_p:
        raise AssertionError(f"{label}: counters differ: {st_k} vs {st_p}")
    occ_k, _ = ck.cbvh_occluded_trace(pc, rays)
    occ_s, so_k = ck.cbvh_occluded_trace(pc, rays, stats=True)
    occ_err = float(max((occ_k != occ_p).sum(), (occ_s != occ_p).sum()))
    if occ_err != 0:
        raise AssertionError(f"{label}: occlusion differs on {occ_err:.0f} "
                             "rays")
    if so_k != so_p:
        raise AssertionError(f"{label}: occlusion counters differ: {so_k} "
                             f"vs {so_p}")
    if st_k["dropped_pushes"] or so_k["dropped_pushes"]:
        raise AssertionError(f"{label}: dropped pushes")
    if t_in is None and (occ_k | (tile_k < 0)).logical_not().any():
        raise AssertionError(f"{label}: a ray that hit a tile is not occluded")
    n = flat.tnear.numel()
    log(f"  {label}: {n} rays, {int((tile_k >= 0).sum())} hits, "
        f"{int(occ_k.sum())} occluded; tile equal, t u v at 0 ulp, counters "
        f"equal (per ray {st_k['top_nodes'] / n:.2f} top nodes, "
        f"{st_k['tiles_entered'] / n:.2f} tiles, "
        f"{st_k['quad_nodes'] / n:.2f} quadtree nodes, "
        f"{st_k['leaf_tests'] / n:.2f} leaves; occlusion "
        f"{so_k['top_nodes'] / n:.2f} top nodes), 0 dropped; plain "
        f"{plain_ms:.0f} + {plain_occ_ms:.0f} ms")
    fin = torch.isfinite(t_k)
    err = float((t_k[fin] - t_p[fin]).abs().max()) if fin.any() else 0.0
    return err, plain_ms, plain_occ_ms, occ_err


def cbvh_small_scene_checks(device):
    """Compressed kernels vs plain versions: the subdivision cube at
    levels (2,2) and (4,3) and a displaced cube at (5,4), each in box,
    leaf and grid mode; rays from a shell with every seventh retired, and
    rays from inside the cage that start from a finite t. Returns (max abs
    err of t, rays whose occlusion answer differs), the worst of each."""
    rng = np.random.default_rng(0xB4)
    verts, counts, indices = subdiv_cube()
    worst = worst_occ = 0.0
    for name, levels, displacement in (
            ("subdiv_cube", (2, 2), None), ("subdiv_cube", (4, 3), None),
            ("displaced subdiv_cube", (5, 4), sine_displacement)):
        for mode in ck.MODES:
            sc = subdiv_scene("", (verts, counts, indices, displacement),
                              levels, mode)
            pc = sc.committed.compressed_kernel
            label = f"{name} {levels} {mode}"
            err, _, _, occ_err = compare_cbvh_plain(
                pc, shell_rays(rng, 2048, 4.0, 0.08, device, retire_every=7),
                label + ", shell")
            worst, worst_occ = max(worst, err), max(worst_occ, occ_err)
            org = rng.uniform(-1.5, 1.5, (1025, 3)).astype(np.float32)
            inner = ett.make_rays(org, unit_dirs(rng, 1025), device=device)
            t_in = torch.from_numpy(
                rng.uniform(0.2, 3.0, 1025).astype(np.float32)).to(device)
            err, _, _, occ_err = compare_cbvh_plain(
                pc, inner, label + ", inside, finite t", t_in=t_in)
            worst, worst_occ = max(worst, err), max(worst_occ, occ_err)
    return worst, worst_occ


def tile_used_bytes(pc):
    """Bytes of one tile that the walk can read: 44 header floats, the
    node words, and the leaf payload of the mode."""
    g = 1 << pc.comp_level
    elems = (4 ** pc.comp_level - 1) // 3
    leaf = {"box": 0, "leaf": 2 * g * g, "grid": 12 * (g + 1) * (g + 1)}
    return 44 * 4 + 4 * elems + leaf[pc.mode]


def tile_row_bytes(pc):
    """Bytes of one tile in the JAX package's rows: 3 rows of 512 B, 8
    more for a grid."""
    return 512 * (3 + (ck.GRID_ROWS if pc.mode == "grid" else 0))


def packet_row_bytes(ps):
    """Bytes of a packet scene in the JAX package's rows (`pack_scene`):
    512 B a node, 512 B a leaf row of ten triangles and the pad row,
    bvh_to_orig and the mask, as a committed scene held them before the
    compact form."""
    return (ps.num_nodes * 512 + pk.leaf_rows(ps.num_prims) * 512
            + ps.bvh_to_orig.numel() * 4
            + (ps.prim_mask.numel() * 4 if ps.prim_mask is not None else 0))


def packet_bytes_line(label, ps):
    """Log the committed compact bytes of a packet scene beside the rows'."""
    rows = packet_row_bytes(ps)
    nodes, tris = 4 * ps.nodes.numel(), 4 * ps.tdata.numel()
    log(f"  {label}: BVH{ps.width} of {ps.num_nodes} nodes in {ps.depth} "
        f"levels, {ps.num_prims} triangles; compact form "
        f"{ps.device_bytes / 1e6:.1f} MB on the card (nodes "
        f"{nodes / 1e6:.1f}, triangles {tris / 1e6:.1f}, ids and masks "
        f"{(ps.device_bytes - nodes - tris) / 1e6:.1f}), the JAX "
        f"package's rows {rows / 1e6:.1f} MB")
    return ps.device_bytes, rows


def packed_row_bytes(pc):
    """Bytes of the accel in the JAX package's rows (`pack_compressed`):
    512 B a top-level node, the tiles' rows, tile_of_leaf and the uv
    tables, as the packed accel held them before the compact form."""
    return (pc.num_nodes * 512 + pc.num_tiles * (tile_row_bytes(pc) + 4)
            + pc.uv0.numel() * 4 + pc.uvd.numel() * 4)


def cbvh_bound(pc, st, occluded):
    """Least time the card could take for what this run's rays needed of
    a compressed kernel: the larger of bytes / memory rate (rays in,
    results out, the used part of every touched node row and tile once)
    and counted float32 operations / the non-tensor fp32 peak."""
    out_bytes = 1 if occluded else 16
    nbytes = (st["rays"] * (8 * 4 + out_bytes) + st["nodes_touched"] * 128
              + st["tiles_touched"] * tile_used_bytes(pc))
    flops = (st["top_nodes"] * 4 * SLAB_FLOPS
             + st["tiles_entered"] * TILE_ENTRY_FLOPS
             + st["quad_nodes"] * QUAD_NODE_FLOPS
             + st["leaf_tests"] * LEAF_FLOPS[pc.mode])
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    flops_ms = flops / PEAK_FP32_PER_S * 1e3
    return {"bytes": nbytes, "flops": flops, "bytes_ms": bytes_ms,
            "flops_ms": flops_ms, "bound_ms": max(bytes_ms, flops_ms),
            "bound_by": "bytes" if bytes_ms >= flops_ms else "operations"}


def cbvh_times(label, pc, flat):
    """Times, counters and bound of both compressed kernels on a batch."""
    out = {}
    n = flat.tnear.shape[0]
    for mode, occl in (("closest", False), ("occluded", True)):
        if occl:
            ms = time_ms(lambda: ck.cbvh_occluded_trace(pc, flat))
            _o, st = ck.cbvh_occluded_trace(pc, flat, stats=True)
        else:
            ms = time_ms(lambda: ck.cbvh_trace(pc, flat))
            st = ck.cbvh_trace(pc, flat, stats=True)[4]
        if st["dropped_pushes"] != 0:
            raise AssertionError(f"{label}: dropped pushes")
        bound = cbvh_bound(pc, st, occl)
        out[mode] = {"ms": ms, "stats": st, "bound": bound}
        log(f"  cbvh {mode}, {label}, {n} rays: {ms:.3f} ms, "
            f"{n / ms / 1e3:.1f} Mray/s; per ray "
            f"{st['top_nodes'] / n:.2f} top nodes, "
            f"{st['tiles_entered'] / n:.2f} tiles entered, "
            f"{st['quad_nodes'] / n:.2f} quadtree nodes, "
            f"{st['leaf_tests'] / n:.2f} leaves; "
            f"{st['nodes_touched']} of {pc.num_nodes} node rows and "
            f"{st['tiles_touched']} of {pc.num_tiles} tiles touched; "
            f"bound {bound['bound_ms']:.4f} ms by {bound['bound_by']} "
            f"(bytes {bound['bytes'] / 1e6:.1f} MB -> "
            f"{bound['bytes_ms']:.4f} ms, operations "
            f"{bound['flops'] / 1e9:.2f} GFLOP -> {bound['flops_ms']:.4f} ms)"
            f": {100 * bound['bound_ms'] / ms:.1f} % of the kernel's time")
    return out


def check_subdiv_hits(label, hits, shape, faces):
    """Hit fields of a compressed or eager subdivision scene: patch uv in
    [0, 1], prim ids base faces."""
    if hits.t.shape != shape or hits.ng.shape != shape + (3,):
        raise AssertionError(f"{label}: wrong output shapes")
    valid = hits.valid
    if not (torch.isfinite(hits.t[valid]).all()
            and torch.isfinite(hits.ng).all()
            and (hits.u[valid] >= -1e-4).all()
            and (hits.u[valid] <= 1 + 1e-4).all()
            and (hits.v[valid] >= -1e-4).all()
            and (hits.v[valid] <= 1 + 1e-4).all()
            and (hits.prim_id[valid] >= 0).all()
            and (hits.prim_id[valid] < faces).all()
            and torch.isinf(hits.t[~valid]).all()):
        raise AssertionError(f"{label}: hit fields out of range")


def check_conservative(label, exact, approx, min_cover=0.995,
                       max_behind=0.005):
    """At least `min_cover` of the rays: a hit of the exact surface is a
    hit of the conservative mode; at most `max_behind` of the common hits
    lie more than CONSERVATIVE_EPS behind the exact one (quantized
    heights and the bilinear slab are not exact on a noisy surface)."""
    ve, vc = exact.valid, approx.valid
    cover = float((vc | ~ve).float().mean())
    both = ve & vc
    dt = (exact.t - approx.t)[both]
    behind = float((dt < -CONSERVATIVE_EPS).float().mean())
    if cover < min_cover or behind > max_behind:
        raise AssertionError(f"{label}: covers {cover:.5f} of the exact "
                             f"hits, {behind:.5f} lie behind the surface")
    log(f"  {label}: {int(ve.sum())} exact hits, {int(vc.sum())} "
        f"conservative; {100 * cover:.4f} % of the rays covered, "
        f"{100 * behind:.4f} % more than {CONSERVATIVE_EPS} behind the exact "
        f"hit; t_exact - t: min {float(dt.min()):.4g}, median "
        f"{float(dt.median()):.4g}, max {float(dt.max()):.4g}")


def hits_head(h, k):
    """The first k rays of flat hits."""
    return type(h)(*(a[:k] for a in h))


def mb_rays(rng, n, device, radius=6.0, jitter=0.3):
    """Rays from a shell aimed at the origin, every seventh retired, and
    one time a ray: uniform in [0, 1], every eleventh exactly 0 and
    every thirteenth exactly 1."""
    rays = shell_rays(rng, n, radius, jitter, device, retire_every=7)
    tm = rng.uniform(0.0, 1.0, n).astype(np.float32)
    tm[::11] = 0.0
    tm[::13] = 1.0
    return rays, torch.from_numpy(tm).to(device)


def compare_mb_plain(pm, rays, times, label):
    """The MB kernel, both variants, main and counting builds, against
    the plain version on the same card tensors: prim equal, t within 1
    ulp (0 expected), occlusion equal, counters equal, no dropped push.
    Returns (max abs err of t, ulps, plain ms closest, plain ms occluded,
    rays whose occlusion differs)."""
    t_k, p_k, _ = mk.mb_trace(pm, rays, times)
    t_s, p_s, st_k = mk.mb_trace(pm, rays, times, stats=True)
    o_k, _, _ = mk.mb_trace(pm, rays, times, occluded=True)
    o_s, _, so_k = mk.mb_trace(pm, rays, times, occluded=True, stats=True)
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    ev[0].record()
    t_p, p_p, st_p = mk.mb_plain(pm, rays, times, stats=True)
    ev[1].record()
    o_p, _, so_p = mk.mb_plain(pm, rays, times, occluded=True, stats=True)
    ev[2].record()
    torch.cuda.synchronize()
    plain_ms, plain_occ_ms = ev[0].elapsed_time(ev[1]), ev[1].elapsed_time(ev[2])
    ulps, err = check_close(label, t_k, t_p, p_k, p_p)
    ulps_s, _ = check_close(label + " (counting build)", t_s, t_p, p_s, p_p)
    if st_k != st_p or so_k != so_p:
        raise AssertionError(f"{label}: counters differ: {st_k} vs {st_p}, "
                             f"occlusion {so_k} vs {so_p}")
    occ_err = float(max((o_k != o_p).sum(), (o_s != o_p).sum()))
    if occ_err:
        raise AssertionError(f"{label}: occlusion differs on {occ_err:.0f} "
                             "rays")
    if st_k["dropped_pushes"] or so_k["dropped_pushes"]:
        raise AssertionError(f"{label}: dropped pushes")
    # any hit <=> a closest hit, or a ray retired with tfar = -inf
    tfar = rays.tfar.reshape(-1)
    if not torch.equal(o_k, (p_k >= 0) | (tfar == -math.inf)):
        raise AssertionError(f"{label}: occlusion disagrees with the hits")
    n = t_k.numel()
    log(f"  {label}: {n} rays, {int((p_k >= 0).sum())} hits; prim equal, "
        f"t within {max(ulps, ulps_s)} ulp, occlusion equal, counters equal "
        f"(per ray {st_k['node_visits'] / n:.2f} nodes, "
        f"{st_k['slab_tests'] / n:.2f} slab tests, "
        f"{st_k['tri_tests'] / n:.2f} triangle tests; occlusion "
        f"{so_k['node_visits'] / n:.2f} nodes), 0 dropped; plain "
        f"{plain_ms:.0f} + {plain_occ_ms:.0f} ms")
    return err, max(ulps, ulps_s), plain_ms, plain_occ_ms, occ_err


def mb_small_scenes(device_cfg=""):
    """(label, scene) of the small motion-blur scenes: the JAX package's
    test shapes (two to five timesteps, the last with temporal splits), a
    QuadMeshMB, a SubdivMeshMB, and MB beside static triangles and beside
    a compressed accel."""
    rng = np.random.default_rng(0xB6)
    v, idx = triangle_sphere((0.0, 0.0, 0.0), 2.0, 24)
    kinked = [v] + [v + np.float32(k) for k in MB_KNOTS]
    zigzag = [v + np.float32(o) for o in ((0, 0, 0), (0.5, 0, 0),
                                          (0.5, 0.7, 0), (-0.2, 0.7, 0.3))]
    cross_t, cross_idx = crossing_clusters(rng)
    qv, quads = quad_sphere((0.0, 0.0, 0.0), 2.0, 16)
    cv, cc, ci = subdiv_cube()
    plane = ett.TriangleMesh(
        np.array([[-10, -3.5, -10], [-10, -3.5, 10], [10, -3.5, -10],
                  [10, -3.5, 10]], np.float32),
        np.array([[0, 1, 2], [1, 3, 2]], np.int32))
    cases = [
        ("S=2 linear, triangle_sphere(24)", "",
         [ett.TriangleMeshMB(v, v + np.float32([1.0, 0.5, 0.0]), idx)]),
        ("S=3 kinked, triangle_sphere(24)", "",
         [ett.TriangleMeshMB(indices=idx, timesteps=kinked)]),
        ("S=4 zig-zag, triangle_sphere(24)", "",
         [ett.TriangleMeshMB(indices=idx, timesteps=zigzag)]),
        ("S=5 crossing clusters", "",
         [ett.TriangleMeshMB(indices=cross_idx, timesteps=cross_t)]),
        ("QuadMeshMB quad_sphere(16)", "",
         [ett.QuadMeshMB(qv, qv + np.float32([0.0, 0.8, 0.4]), quads)]),
        ("SubdivMeshMB subdiv_cube, level 3", "",
         [ett.SubdivMeshMB(cv, cv * np.float32(1.3) + np.float32(
             [0.3, 0.0, 0.0]), cc, ci)]),
        ("S=3 kinked beside static triangles", "",
         [plane, ett.TriangleMeshMB(indices=idx, timesteps=kinked)]),
        ("S=3 kinked beside a compressed leaf accel",
         ",subdiv_accel=bvh4.compressed.leaf",
         [ett.SubdivMesh(cv * np.float32(0.5), cc, ci),
          ett.TriangleMeshMB(indices=idx, timesteps=kinked)]),
    ]
    out = []
    for label, cfg, geoms in cases:
        sc = ett.Scene(ett.Device("ignore_config_files=1" + device_cfg + cfg))
        for g in geoms:
            sc.attach(g)
        sc.set_levels(3, 3)
        sc.commit()
        out.append((label, sc))
    return out


def mb_small_scene_checks(device):
    """Phase 3d: the MB kernel vs its plain version on the small scenes,
    and each scene's `intersect` through the kernel. Returns (max abs err
    of t, worst ulps, rays whose occlusion differs)."""
    rng = np.random.default_rng(0x3D)
    worst = worst_ulps = worst_occ = 0.0
    for label, sc in mb_small_scenes():
        cs = sc.committed
        pm = cs.mb_kernel
        if label.startswith("S=5") and not cs.mb.has_time_splits:
            raise AssertionError(f"{label}: the build made no temporal split")
        rays, times = mb_rays(rng, MB_SMALL_RAYS, device)
        err, ulps, _, _, occ_err = compare_mb_plain(
            pm, rays, times, f"{label} (S={pm.S}, {pm.num_prims} triangles, "
            f"{pm.num_nodes} nodes, splits {cs.mb.has_time_splits})")
        worst, worst_ulps = max(worst, err), max(worst_ulps, ulps)
        worst_occ = max(worst_occ, occ_err)
        with Launches() as lc:
            h = sc.intersect(rays, time=times)
            torch.cuda.synchronize()
        lc.expect_mb(f"{label}: intersect", 1, 0)
        if (cs.tris.num_prims and lc.packet != 1) or (
                cs.compressed is not None and lc.cbvh != 1):
            raise AssertionError(f"{label}: the other accels were not traced")
        t_k, p_k, _ = mk.mb_trace(pm, rays, times)
        if cs.tris.num_prims == 0 and cs.compressed is None:
            if not (torch.equal(h.gprim, p_k)
                    and torch.equal(h.t[h.valid], t_k[h.valid])):
                raise AssertionError(f"{label}: the request and the kernel "
                                     "disagree")
        on_mb = h.valid & (h.gprim == p_k) & (h.t == t_k)
        if int(on_mb.sum()) == 0 or (h.valid.sum() < (p_k >= 0).sum()):
            raise AssertionError(f"{label}: the request lost MB hits")
    return worst, worst_ulps, worst_occ


def mb_bound(pm, st, occluded):
    """Least time the card could take for what this run's rays needed of
    the MB kernel: the larger of bytes / memory rate (rays and times in,
    results out; of every touched node row its header, child and count,
    its time gates and two knot boxes of every child, of every touched
    triangle two knots and its prim_order entry, once) and counted
    float32 operations (the box lerp and slab test of every child tested,
    the vertex lerp and Moeller test of every triangle tested) / the
    non-tensor fp32 peak."""
    out_bytes = 1 if occluded else 8
    node_bytes = 4 * (4 * pm.W + 2 * 6 * pm.W)
    tri_bytes = 4 * 2 * 9 + 4
    nbytes = (st["rays"] * (9 * 4 + out_bytes)
              + st["nodes_touched"] * node_bytes
              + st["prims_touched"] * tri_bytes)
    flops = (st["slab_tests"] * MB_SLAB_FLOPS
             + st["tri_tests"] * MB_TRI_FLOPS)
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    flops_ms = flops / PEAK_FP32_PER_S * 1e3
    return {"bytes": nbytes, "flops": flops, "bytes_ms": bytes_ms,
            "flops_ms": flops_ms, "bound_ms": max(bytes_ms, flops_ms),
            "bound_by": "bytes" if bytes_ms >= flops_ms else "operations"}


def mb_times(label, pm, flat, times):
    """Times, counters and bound of both MB variants on one batch."""
    out = {}
    n = flat.tnear.shape[0]
    for mode, occl in (("closest", False), ("occluded", True)):
        ms = time_ms(lambda: mk.mb_trace(pm, flat, times, occluded=occl))
        st = mk.mb_trace(pm, flat, times, occluded=occl, stats=True)[2]
        if st["dropped_pushes"] != 0:
            raise AssertionError(f"{label}: dropped pushes")
        bound = mb_bound(pm, st, occl)
        out[mode] = {"ms": ms, "stats": st, "bound": bound}
        log(f"  mb {mode}, {label}, {n} rays: {ms:.3f} ms, "
            f"{n / ms / 1e3:.1f} Mray/s; per ray {st['node_visits'] / n:.2f} "
            f"nodes, {st['slab_tests'] / n:.2f} slab tests, "
            f"{st['tri_tests'] / n:.2f} triangle tests; "
            f"{st['nodes_touched']} of {pm.num_nodes} node rows and "
            f"{st['prims_touched']} of {pm.num_prims} triangle rows touched; "
            f"bound {bound['bound_ms']:.4f} ms by {bound['bound_by']} "
            f"(bytes {bound['bytes'] / 1e6:.1f} MB -> "
            f"{bound['bytes_ms']:.4f} ms, operations "
            f"{bound['flops'] / 1e9:.2f} GFLOP -> {bound['flops_ms']:.4f} ms)"
            f": {100 * bound['bound_ms'] / ms:.1f} % of the kernel's time")
    return out


def check_static_knot(label, h, t_s, p_s):
    """An MB request at a knot's time against the static scene of that
    knot through the packet kernel: valid equal, t within 1e-6 relative,
    prim equal except where both give the same t within that tolerance
    (ties, counted)."""
    valid = p_s >= 0
    if not torch.equal(h.valid, valid):
        raise AssertionError(f"{label}: valid masks differ on "
                             f"{int((h.valid != valid).sum())} rays")
    rel = ((h.t - t_s).abs() / t_s.abs())[valid]
    worst = float(rel.max()) if valid.any() else 0.0
    ties = int((h.gprim != p_s)[valid].sum())
    if not worst <= 1e-6:
        raise AssertionError(f"{label}: t differs by {worst:g} relative")
    log(f"  {label}: same valid mask ({int(valid.sum())} hits), t within "
        f"{worst:g} relative, prim differs on {ties} ties")
    return ties


def mb_brute_check(label, accel, flat: Rays, times, valid, t):
    """BRUTE_RAYS rays (evenly strided) against every triangle of the MB
    accel lerped at each ray's time: same valid mask, t within 1e-5
    relative."""
    n = flat.tnear.shape[0]
    sel = torch.linspace(0, n - 1, BRUTE_RAYS, device=t.device).long()
    S = accel.num_timesteps
    best = torch.full((BRUTE_RAYS,), math.inf, device=t.device)
    hit = torch.zeros(BRUTE_RAYS, dtype=torch.bool, device=t.device)
    for s in range(0, BRUTE_RAYS, 8):
        r = sel[s:s + 8]
        x = times[r].clamp(0.0, 1.0) * float(S - 1)
        seg = x.to(torch.int32).clamp(0, S - 2).long()
        w = (x - seg.to(torch.float32))[:, None, None]
        vs = [vt[seg] * (1.0 - w) + vt[seg + 1] * w
              for vt in (accel.v0_ts, accel.v1_ts, accel.v2_ts)]
        ok, tt, _u, _v, _ng = intersect_triangle(
            flat.org[r][:, None, :], flat.dir[r][:, None, :],
            flat.tnear[r][:, None], flat.tfar[r][:, None], *vs)
        tt = torch.where(ok, tt, torch.full_like(tt, math.inf)).amin(dim=1)
        hit[s:s + 8] = torch.isfinite(tt)
        best[s:s + 8] = tt
    k_valid, k_t = valid.reshape(-1)[sel], t.reshape(-1)[sel]
    if not torch.equal(hit, k_valid):
        raise AssertionError(f"{label}: brute force: valid masks differ on "
                             f"{int((hit != k_valid).sum())} rays")
    rel = (float(((best - k_t).abs() / k_t.abs())[k_valid].max())
           if k_valid.any() else 0.0)
    if not rel <= 1e-5:
        raise AssertionError(f"{label}: brute force: t differs by {rel:g} "
                             "relative")
    log(f"  {label}: brute force over all lerped triangles, {BRUTE_RAYS} "
        f"rays at their own times: same valid mask ({int(hit.sum())} hits), "
        f"t within {rel:g} relative")


def hair_rays(rng, n, device, packed_world, extent=3.0, retire_every=0):
    """Rays from origins uniform in +-extent: every second one aimed at
    a random point of a random segment of `packed_world` ((S, 8) world
    frame [p0 p1 r0 r1] on the card), the others uniform; every
    `retire_every`-th ray retired (tfar = -inf)."""
    org = rng.uniform(-extent, extent, (n, 3)).astype(np.float32)
    d = unit_dirs(rng, n)
    seg = packed_world.cpu().numpy()
    pick = seg[rng.integers(0, seg.shape[0], n)]
    w = rng.uniform(0, 1, (n, 1)).astype(np.float32)
    aim = pick[:, :3] * (1 - w) + pick[:, 3:6] * w - org
    aim /= np.linalg.norm(aim, axis=1, keepdims=True)
    d[::2] = aim[::2]
    r = ett.make_rays(org, d, device=device)
    if retire_every:
        tf = r.tfar.clone()
        tf[::retire_every] = -math.inf
        r = r._replace(tfar=tf)
    return r


def world_segments(cs):
    """Every hair cluster's segments rotated back to the world frame."""
    out = []
    for h in cs.hairs:
        g = h.packed.seg
        out.append(torch.cat([rows_times(g[:, 0:3], h.rot.T),
                              rows_times(g[:, 3:6], h.rot.T), g[:, 6:8]], 1))
    return torch.cat(out)


def cluster_rays(h, rays: Rays, t=None) -> Rays:
    """Flat rays rotated into hair cluster `h`'s frame."""
    f = flat_rays(rays)
    return Rays(rows_times(f.org, h.rot), rows_times(f.dir, h.rot),
                f.tnear, f.tfar if t is None else t)


def compare_hair_plain(hs, rays, label):
    """B3 over every cluster of a set in one launch (a run of one leaf
    type), main and counting builds, closest and any hit, against its
    plain version on the same card tensors (rays in the world frame): t
    at 0 ulp, slot and cluster equal, counters equal, no dropped push,
    any hit equal to (closest hit found or tfar = -inf). Returns (max abs
    err of t, plain ms closest, plain ms occluded, stats of the closest
    hit)."""
    (flat, first, count), = hs.runs()
    res = {}
    for occl in (False, True):
        t_k, s_k, c_k, _ = hk.hair_set_trace(hs, rays, first, count, occl)
        t_s, s_s, c_s, st_k = hk.hair_set_trace(hs, rays, first, count,
                                                occl, stats=True)
        torch.cuda.synchronize()
        ev0 = torch.cuda.Event(enable_timing=True)
        ev1 = torch.cuda.Event(enable_timing=True)
        ev0.record()
        t_p, s_p, c_p, st_p = hk.hair_set_plain(hs, rays, first, count, occl,
                                                stats=True)
        ev1.record()
        torch.cuda.synchronize()
        mode = "any hit" if occl else "closest"
        for tk, sk, ck_, what in ((t_k, s_k, c_k, ""),
                                  (t_s, s_s, c_s, " (counting build)")):
            ulps = ulp_distance(tk, t_p)
            if ulps != 0 or not torch.equal(sk, s_p) or not torch.equal(
                    ck_, c_p):
                raise AssertionError(
                    f"{label}, {mode}{what}: t {ulps} ulp apart, slot "
                    f"differs on {int((sk != s_p).sum())} rays, cluster on "
                    f"{int((ck_ != c_p).sum())}")
        if st_k != st_p:
            raise AssertionError(f"{label}, {mode}: counters differ: {st_k} "
                                 f"vs {st_p}")
        if st_k["dropped_pushes"]:
            raise AssertionError(f"{label}, {mode}: dropped pushes")
        fin = torch.isfinite(t_k) & torch.isfinite(t_p)
        err = float((t_k[fin] - t_p[fin]).abs().max()) if fin.any() else 0.0
        res[occl] = (t_k, s_k, st_k, ev0.elapsed_time(ev1), err)
    (t_c, s_c, st_c, ms_c, err), (t_o, s_o, st_o, ms_o, _) = \
        res[False], res[True]
    tfar = rays.tfar.reshape(-1)
    if not torch.equal(t_o == -math.inf, (s_c >= 0) | (tfar == -math.inf)):
        raise AssertionError(f"{label}: any hit disagrees with closest hit")
    if not torch.equal(s_o, torch.full_like(s_o, -1)):
        raise AssertionError(f"{label}: the any-hit variant wrote a slot")
    n = t_c.numel()
    log(f"  {label}: {n} rays, {count} clusters in one launch, "
        f"{int((s_c >= 0).sum())} hits; t at 0 ulp, slot and cluster "
        f"equal, counters equal (per ray {st_c['node_visits'] / n:.2f} "
        f"nodes, {st_c['seg_tests'] / n:.2f} segment tests; any hit "
        f"{st_o['node_visits'] / n:.2f} nodes), 0 dropped; plain {ms_c:.0f} "
        f"+ {ms_o:.0f} ms")
    return err, ms_c, ms_o, st_c


def check_fold_equal(label, cs, rays):
    """A request's hair fold (one launch a leaf type over every cluster,
    one finalize) against the fold one cluster at a time (a launch of the
    cluster alone with the rays rotated on the host, its finalize, Ng
    rotated back, the min-combine): t, u, v, Ng, prim_id, geom_id equal
    bit for bit, and occlusion equal."""
    flat = flat_rays(rays)
    n = flat.tnear.shape[0]
    start = ett.miss_hits((n,), flat.tfar, device=flat.tnear.device)
    one = _fold_hair(cs, flat, start)
    old = start
    occ = torch.zeros(n, dtype=torch.bool, device=flat.tnear.device)
    for h in cs.hairs:
        t, u, v, ng, m, hitm = hk.intersect_hair_kernel(
            h.packed, rows_times(flat.org, h.rot),
            rows_times(flat.dir, h.rot), flat.tnear, old.t.contiguous())
        old = _fold(old, hitm & (t < old.t), t, u, v,
                    rows_times(ng, h.rot.T),
                    h.members[m.clamp_min(0).long()], h.gid)
        occ = occ | hk.occluded_hair_kernel(
            h.packed, rows_times(flat.org, h.rot),
            rows_times(flat.dir, h.rot), flat.tnear,
            torch.where(occ, -math.inf, flat.tfar))
    for name in ("t", "u", "v", "ng", "prim_id", "geom_id"):
        a, b = getattr(one, name), getattr(old, name)
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        if not torch.equal(a, b):
            raise AssertionError(f"{label}: the one-launch fold differs from "
                                 f"the per-cluster fold in {name} on "
                                 f"{int((a != b).reshape(n, -1).any(1).sum())}"
                                 " rays")
    hs = cs.hair_set.packed
    occ_one = torch.zeros_like(occ)
    for _flat, first, count in hs.runs():
        occ_one = occ_one | hk.occluded_hair_set(
            hs, flat, torch.where(occ_one, -math.inf, flat.tfar), first,
            count)
    if not torch.equal(occ_one, occ):
        raise AssertionError(f"{label}: occlusion differs from the "
                             "per-cluster fold")
    log(f"  {label}: {n} rays, one launch == {len(cs.hairs)} launches "
        f"folded one cluster at a time, bit for bit (t, u, v, Ng, prim_id, "
        f"geom_id; {int(one.valid.sum())} hits), occlusion equal")


def hair_small_scenes(device_cfg=""):
    """(label, scene) of the small hair scenes: the JAX package's test hair
    ball (120 curves, random and diagonal, round and flat), its head-on
    ribbon, the tutorial's fur at 120 strands."""
    rng = np.random.default_rng(0xB3)
    cases = []
    for diagonal in (False, True):
        verts, idx = hair_ball(rng, 120, diagonal=diagonal)
        for flat in (False, True):
            cases.append((f"hair_ball(120{', diagonal' if diagonal else ''})"
                          f" {'flat' if flat else 'round'}",
                          [ett.BezierCurves(verts, idx, tessellation_rate=8,
                                            flat=flat)]))
    cases.append(("head-on ribbon", [ett.BezierCurves(
        np.array([[0, 0, 0, 0.1], [0, 0.33, 0, 0.1], [0, 0.66, 0, 0.1],
                  [0, 1, 0, 0.1]], np.float32), np.array([0], np.int32),
        flat=True)]))
    cps, idx = hair_tutorial.make_fur(120)
    cases.append(("make_fur(120), K = 6", [ett.BezierCurves(
        cps, idx, tessellation_rate=6)]))
    out = []
    for label, geoms in cases:
        sc = ett.Scene(ett.Device("ignore_config_files=1" + device_cfg))
        for g in geoms:
            sc.attach(g)
        sc.commit()
        out.append((label, sc))
    return out


def hair_small_scene_checks(device):
    """Phase 3e: B3 against its plain version over all clusters of each
    small hair scene, the one-launch fold against the per-cluster fold,
    and each scene's requests through the kernel. Returns {leaf: max abs
    err of t}."""
    rng = np.random.default_rng(0x3E)
    worst = {"cone": 0.0, "ribbon": 0.0}
    for label, sc in hair_small_scenes():
        cs = sc.committed
        hs = cs.hair_set.packed
        rays = hair_rays(rng, 4096, device, world_segments(cs),
                         retire_every=7)
        err, _, _, _ = compare_hair_plain(
            hs, rays, f"{label} ({'ribbon' if hs.flat[0] else 'cone'}, "
            f"{sum(hs.num_segments)} segments, {sum(hs.num_nodes)} nodes)")
        leaf = "ribbon" if hs.flat[0] else "cone"
        worst[leaf] = max(worst[leaf], err)
        check_fold_equal(label, cs, rays)
        with Launches() as lc:
            hits = sc.intersect(rays)
            occ = sc.occluded(rays)
            torch.cuda.synchronize()
        lc.expect_hair(f"{label}: intersect + occluded", cs, 1, 1)
        tfar = rays.tfar.reshape(-1)
        if not torch.equal(occ, hits.valid | (tfar == -math.inf)):
            raise AssertionError(f"{label}: occluded disagrees with intersect")
        if not hits.valid.any():
            raise AssertionError(f"{label}: no ray hit")
    return worst


def hair_bound(hs, st, rays):
    """Least time the card could take for what this run's rays needed of
    one B3 launch over every cluster of a set: the larger of bytes /
    memory rate (a ray's org, dir, tnear and tfar in and (t, slot,
    cluster) out once a request, the 8 x WIDTH floats of a touched node
    row that the walk reads, as `packet_bound` counts them, and 32 B a
    segment of a touched segment row, each once) and counted float32
    operations (a ray's rotation into each cluster it entered, which an
    any-hit ray that hits stops doing, the slab tests of every node
    visited, every segment test) / the non-tensor fp32 peak."""
    nbytes = (rays * (8 * 4 + 3 * 4)
              + st["nodes_touched"] * 8 * hk.WIDTH * 4
              + st["rows_touched"] * hk.NS_PER_ROW * 32)
    flops = ((0 if hs.rots is None else st["clusters_entered"] * ROT_FLOPS)
             + st["node_visits"] * hk.WIDTH * SLAB_FLOPS
             + st["seg_tests"] * (RIBBON_FLOPS if hs.flat[0]
                                  else CONE_FLOPS))
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    flops_ms = flops / PEAK_FP32_PER_S * 1e3
    return {"bytes": nbytes, "flops": flops, "bytes_ms": bytes_ms,
            "flops_ms": flops_ms, "bound_ms": max(bytes_ms, flops_ms),
            "bound_by": "bytes" if bytes_ms >= flops_ms else "operations"}


def hair_times(label, cs, rays):
    """Times, counters and bound of B3's one launch over every cluster of
    `cs` on one batch, closest and any hit, from tfar."""
    out = {}
    n = rays.tnear.numel()
    hs = cs.hair_set.packed
    flat = flat_rays(rays)
    for mode, occl in (("closest", False), ("occluded", True)):
        ms = time_ms(lambda: hk.hair_set_trace(hs, flat, occluded=occl))
        st = hk.hair_set_trace(hs, flat, occluded=occl, stats=True)[3]
        if st["dropped_pushes"]:
            raise AssertionError(f"{label}: dropped pushes")
        bound = hair_bound(hs, st, n)
        out[mode] = {"ms": ms, "bound": bound,
                     "nodes": st["node_visits"] / n,
                     "segs": st["seg_tests"] / n}
        log(f"  hair {mode}, {label}, {n} rays, 1 launch over "
            f"{hs.num_clusters} clusters: {ms:.3f} ms, "
            f"{n / ms / 1e3:.1f} Mray/s; per ray "
            f"{st['node_visits'] / n:.2f} node visits, "
            f"{st['seg_tests'] / n:.2f} segment tests; "
            f"bound {bound['bound_ms']:.4f} ms by {bound['bound_by']} "
            f"(bytes {bound['bytes'] / 1e6:.1f} MB -> "
            f"{bound['bytes_ms']:.4f} ms, operations "
            f"{bound['flops'] / 1e9:.2f} GFLOP -> {bound['flops_ms']:.4f} ms)"
            f": {100 * bound['bound_ms'] / ms:.1f} % of the kernel's time")
    return out


def check_curve_hits(label, hits, shape):
    """Shapes, and the fields of curve hits: t finite where valid and
    inf elsewhere (tfar = inf), Ng finite, u and v in [0, 1]."""
    if hits.t.shape != shape or hits.ng.shape != shape + (3,):
        raise AssertionError(f"{label}: wrong output shapes")
    valid = hits.valid
    if not (torch.isfinite(hits.t[valid]).all()
            and torch.isfinite(hits.ng).all()
            and (hits.u[valid] >= 0).all() and (hits.u[valid] <= 1).all()
            and (hits.v[valid] >= 0).all() and (hits.v[valid] <= 1).all()
            and torch.isinf(hits.t[~valid]).all()):
        raise AssertionError(f"{label}: hit fields out of range")


def hair_brute_check(label, cs, rays, n_rays):
    """`n_rays` rays (evenly strided) against every sub-segment of every
    hair cluster with the leaf's own arithmetic (hair_kernel's
    cone/ribbon candidates, chunked), the closest t a ray: equal to the
    t of the scene's hair fold (kernel B3) on all of them but at most
    0.01 %, each exception printed."""
    flat = flat_rays(rays)
    n = flat.tnear.shape[0]
    dev = flat.tnear.device
    sel = torch.linspace(0, n - 1, n_rays, device=dev).long()
    br = Rays(*(a[sel].contiguous() for a in flat))
    best = br.tfar.clone()
    for h in cs.hairs:
        cr = cluster_rays(h, br)
        o = tuple(cr.org[:, k:k + 1] for k in range(3))
        dv = tuple(cr.dir[:, k:k + 1] for k in range(3))
        test = (hk.ribbon_candidates if h.packed.flat
                else hk.cone_candidates)
        for s0 in range(0, h.packed.num_segments, 8192):
            ok, th = test(o, dv, cr.tnear[:, None], *hk.seg_fields(
                h.packed.seg[None, s0:s0 + 8192]))[:2]
            th = torch.where(ok & (th < best[:, None]), th,
                             torch.full_like(th, math.inf)).amin(dim=1)
            best = torch.minimum(best, th)
    fold = _fold_hair(cs, br, ett.miss_hits((n_rays,), br.tfar,
                                            device=dev))
    same = (best == fold.t) | (torch.isinf(best) & ~fold.valid)
    bad = torch.nonzero(~same).squeeze(1).tolist()
    for i in bad:
        log(f"  {label}: brute force exception at ray {int(sel[i])}: "
            f"brute t {float(best[i])!r}, kernel t {float(fold.t[i])!r}")
    if len(bad) > 1e-4 * n_rays:
        raise AssertionError(f"{label}: brute force differs on {len(bad)} "
                             f"of {n_rays} rays")
    nseg = sum(h.packed.num_segments for h in cs.hairs)
    log(f"  {label}: brute force over all {nseg} sub-segments, {n_rays} "
        f"rays: t equal on {n_rays - len(bad)} "
        f"({int(torch.isfinite(best).sum())} hits)")


def hair_full_checks(label, cs, rays):
    """B3's one launch against its plain version on the first
    2^HAIR_PLAIN_LOG2 rays of a full-size scene, every cluster, closest
    and any hit. Returns (max abs err of t, plain ms closest, plain ms
    any hit)."""
    nh = 1 << HAIR_PLAIN_LOG2
    head = Rays(*(a[:nh].contiguous() for a in flat_rays(rays)))
    hs = cs.hair_set.packed
    e, mc, mo, _st = compare_hair_plain(
        hs, head, f"{label}, {hs.num_clusters} clusters "
        f"({sum(hs.num_segments)} segments, {sum(hs.num_nodes)} nodes, "
        f"{max(hs.depth)} levels at most), the first 2^{HAIR_PLAIN_LOG2} "
        "rays")
    return e, mc, mo


def brute_user_check(label, entry, flat: Rays, hits, n_rays):
    """`n_rays` rays against every segment of a segment soup through the
    soup's own intersect function, the closest t a ray: the request's t
    where its hit is on this soup."""
    n = flat.tnear.shape[0]
    sel = torch.linspace(0, n - 1, n_rays, device=flat.tnear.device).long()
    br = Rays(*(a[sel].contiguous() for a in flat))
    best = br.tfar.clone()
    for p in range(entry.accel.num_prims):
        ok, th, _u, _v, _ng = entry.intersect_fn(p, br, best)
        best = torch.where(ok & (th < best) & (th > br.tnear), th, best)
    t_k = hits.t.reshape(-1)[sel]
    if not torch.equal(best, t_k):
        raise AssertionError(f"{label}: brute force differs on "
                             f"{int((best != t_k).sum())} of {n_rays} rays")
    log(f"  {label}: brute force over all {entry.accel.num_prims} segments, "
        f"{n_rays} rays: t equal ({int(torch.isfinite(best).sum())} hits)")


def nan_lanes(org, d):
    """The bad lanes of tests/test_torch_robust.py in the first six rays:
    a NaN origin, a NaN direction, an Inf direction, a zero direction, a
    NaN in one origin and in one direction component."""
    org, d = org.copy(), d.copy()
    org[0] = np.nan
    d[1] = np.nan
    d[2] = np.inf
    d[3] = 0.0
    org[4, 1] = np.nan
    d[5, 2] = np.nan
    return org, d


def nan_lane_checks(device):
    """Phase 3f: rays with NaN and Inf lanes (and, for B6, times of NaN,
    +-Inf and -0.5) through all ten kernel entries, each held against its
    plain version at 0 ulp with equal counters; the bad lanes miss (B5,
    as the JAX package, reports the Inf-direction lane occluded). Returns
    {kernel name: max abs err of t}."""
    rng = np.random.default_rng(0xBAD)
    n = 1024
    err = {}

    def lane_rays(extent, aim=None):
        org = rng.uniform(-extent, extent, (n, 3)).astype(np.float32)
        d = unit_dirs(rng, n)
        if aim is not None:
            d[::2] = aim(n)[::2] - org[::2]
        return ett.make_rays(*nan_lanes(org, d), device=device)

    def zero(name, e):
        if e != 0.0:
            raise AssertionError(f"{name}: t {e:g} off its plain version")
        err[name] = max(err.get(name, 0.0), e)

    def misses(name, hit):
        if hit[:6].any():
            raise AssertionError(f"{name}: a NaN or Inf lane hit: "
                                 f"{hit[:6].tolist()}")

    verts, idx = random_triangles(rng, 300, extent=5.0, size=1.2)
    v = np.asarray(verts, np.float32)[np.asarray(idx)]
    rays = lane_rays(6.0, lambda k: v[rng.integers(0, len(v), k)].mean(1))
    ts = build_treelet_scene(v[:, 0], v[:, 1], v[:, 2], np.arange(len(idx)),
                             fan=8).to_device(device)
    ps = packed_scene(verts, idx, 4, device)
    for occl in (False, True):
        mode = "occluded" if occl else "closest"
        for cull in (False, True):
            zero("rowtrace2", compare_kernel_plain(
                ts, rays, occl, cull,
                f"rowtrace2 {mode}{', cull' if cull else ''}, NaN/Inf "
                "lanes")[0])
        t, p = rt2.intersect_rowtrace2(ts, rays, occluded=occl)
        misses("rowtrace2", (t == -math.inf) | (p >= 0))
        zero("packet", compare_packet_plain(
            ps, rays, occl, False, f"packet {mode}, NaN/Inf lanes")[0])
        t, p, _ = pk.packet_trace(ps, rays, occl)
        misses("packet", (t == -math.inf) | (p >= 0))
    cv, cc, ci = subdiv_cube()
    pc = subdiv_scene("", (cv, cc, ci, None), (3, 2),
                      "leaf").committed.compressed_kernel
    crays = lane_rays(3.0, lambda k: np.zeros((k, 3), np.float32))
    e, _, _, occ_err = compare_cbvh_plain(pc, crays,
                                          "cbvh leaf, NaN/Inf lanes")
    zero("cbvh", e)
    zero("cbvh_occluded", occ_err)
    misses("cbvh", ck.cbvh_trace(pc, crays)[3] >= 0)
    occ = ck.cbvh_occluded_trace(pc, crays)[0]
    misses("cbvh_occluded", occ[[0, 1, 3, 4, 5]])
    if not occ[2]:
        raise AssertionError("cbvh_occluded: the Inf lane is no longer "
                             "occluded, unlike the JAX package")
    v2, idx2 = triangle_sphere((0.0, 0.0, 0.0), 2.0, 24)
    mbs = ett.Scene(ett.Device("ignore_config_files=1"))
    mbs.attach(ett.TriangleMeshMB(indices=idx2, timesteps=[v2] + [
        v2 + np.float32(k) for k in MB_KNOTS]))
    pm = mbs.commit().mb_kernel
    mrays = lane_rays(4.0, lambda k: np.zeros((k, 3), np.float32))
    tm = rng.uniform(0, 1, n).astype(np.float32)
    tm[6:10] = (np.nan, np.inf, -np.inf, -0.5)
    times = torch.from_numpy(tm).to(device)
    e, _, _, _, occ_err = compare_mb_plain(pm, mrays, times,
                                           "mb, NaN/Inf lanes and times")
    zero("mb", e)
    zero("mb_occluded", occ_err)
    t, p, _ = mk.mb_trace(pm, mrays, times)
    misses("mb", p >= 0)
    if p[6] >= 0:
        raise AssertionError("mb: the NaN-time lane hit")
    for flat in (False, True):
        hv, hi = hair_ball(rng, 60)
        hsc = ett.Scene(ett.Device("ignore_config_files=1"))
        hsc.attach(ett.BezierCurves(hv, hi, tessellation_rate=4, flat=flat))
        hcs_ = hsc.commit()
        seg = world_segments(hcs_).cpu().numpy()
        hrays = lane_rays(2.5, lambda k: seg[rng.integers(0, len(seg), k),
                                             :3])
        leaf = "ribbon" if flat else "cone"
        e = compare_hair_plain(hcs_.hair_set.packed, hrays,
                               f"hair {leaf}, NaN/Inf lanes")[0]
        zero(f"hair_{leaf}", e)
        zero(f"hair_{leaf}_occluded", 0.0)
        t, s, _c, _ = hk.hair_set_trace(hcs_.hair_set.packed, hrays)
        misses(f"hair_{leaf}", s >= 0)
    return err


def watertight_checks(device):
    """Phase 3g: tests/test_watertight_matrix.py's triangle, MB-triangle
    and subdivision cases at the reference's 100,000 rays from inside a
    closed surface, through the scene's kernels B2 and B6, the treelet
    kernel B1 and the compressed kernels B4 and B5 ('grid', 'box',
    'leaf'), B1, B4 and B5 held against their plain versions: no ray may
    miss. Returns the worst error of B1, B4 and B5 against their plain
    versions."""
    rng = np.random.default_rng(0x3A7)
    n = 100_000
    d = unit_dirs(rng, n)
    rays = ett.make_rays(np.zeros((n, 3), np.float32), d, device=device)
    verts, idx = triangle_sphere((0.0, 0.0, 0.0), 2.0, 60)
    sc = ett.Scene(ett.Device("ignore_config_files=1"))
    sc.attach(ett.TriangleMesh(verts, idx))
    sc.commit()
    with Launches() as lc:
        h = sc.intersect(rays)
        torch.cuda.synchronize()
    lc.expect("watertight triangles", 0, 1)
    # the same sphere as a treelet scene, through B1
    rts = ett.Scene(ett.Device(
        "ignore_config_files=1,tri_accel=bvh4.triangle4.rowtrace"))
    rts.attach(ett.TriangleMesh(verts, idx))
    ts = rts.commit().rowtrace
    errs = {"rowtrace2": 0.0, "cbvh": 0.0, "cbvh_occluded": 0.0}
    for occl in (False, True):
        e, _, _ = compare_kernel_plain(
            ts, rays, occl, False, "watertight triangle_sphere(60), "
            f"rowtrace2 {'occluded' if occl else 'closest'}")
        errs["rowtrace2"] = max(errs["rowtrace2"], e)
        t1, p1 = rt2.intersect_rowtrace2(ts, rays, occluded=occl)
        miss_b1 = int((~(t1 == -math.inf) if occl else (p1 < 0)).sum())
        if miss_b1:
            raise AssertionError(f"watertight: {miss_b1} of {n} rays missed "
                                 "the triangle sphere through B1")
    # the subdivision cube in the compressed kernels' modes, B4 and B5
    cv, cc, ci = subdiv_cube()
    for mode in ck.MODES:
        pc = subdiv_scene("", (cv, cc, ci, None), (4, 2),
                          mode).committed.compressed_kernel
        e, _, _, occ_err = compare_cbvh_plain(
            pc, rays, f"watertight subdiv_cube (4, 2) {mode}")
        errs["cbvh"] = max(errs["cbvh"], e)
        errs["cbvh_occluded"] = max(errs["cbvh_occluded"], occ_err)
        miss_c = int((ck.cbvh_trace(pc, rays)[3] < 0).sum())
        miss_o = int((~ck.cbvh_occluded_trace(pc, rays)[0]).sum())
        if miss_c or miss_o:
            raise AssertionError(f"watertight: {miss_c} and {miss_o} of {n} "
                                 f"rays missed the {mode} cube through B4 "
                                 "and B5")
    verts, idx = triangle_sphere((0.0, 0.0, 0.0), 2.0, 40)
    ms = ett.Scene(ett.Device("ignore_config_files=1"))
    ms.attach(ett.TriangleMeshMB(verts, verts + np.float32([0.3, 0, 0]),
                                 idx))
    ms.commit()
    times = torch.from_numpy(rng.uniform(0, 1, n).astype(np.float32)).to(
        device)
    with Launches() as lc:
        hm = ms.intersect(rays, time=times)
        torch.cuda.synchronize()
    lc.expect_mb("watertight motion blur", 1, 0)
    miss, miss_mb = int((~h.valid).sum()), int((~hm.valid).sum())
    if miss or miss_mb:
        raise AssertionError(f"watertight: {miss} of {n} rays missed the "
                             f"triangle sphere (B2), {miss_mb} the MB "
                             "sphere (B6)")
    log(f"  {n} rays from inside triangle_sphere(60) through B2 and B1, "
        f"inside the moving triangle_sphere(40) at random times through "
        f"B6, inside subdiv_cube() in box, leaf and grid mode through B4 "
        f"and B5: 0 misses each")
    return errs


def grid_triangles(pc):
    """The two triangles of every cell of a grid-mode accel (its compact
    form), with the kernel's diagonal and vertex order, as a mesh."""
    n = (1 << pc.comp_level) + 1
    _words, _node_ofs, leaf_ofs = ck.tile_layout(pc.comp_level, pc.mode)
    g = pc.tiles[:, leaf_ofs:leaf_ofs + 3 * n * n].cpu().numpy()
    T = g.shape[0]
    verts = g.reshape(-1, 3)
    i, j = np.meshgrid(np.arange(n - 1), np.arange(n - 1), indexing="ij")
    v00 = (i * n + j).reshape(-1)
    v10, v01, v11 = v00 + n, v00 + 1, v00 + n + 1
    cell = np.concatenate([np.stack([v00, v10, v01], 1),
                           np.stack([v11, v01, v10], 1)])
    idx = (cell[None] + (np.arange(T) * n * n)[:, None, None]).reshape(-1, 3)
    return verts, idx.astype(np.int32)



def ptxas_summary(text, names):
    """(kernel, registers, stack bytes, spill stores, spill loads) of every
    entry function of ptxas' report whose name contains one of `names`."""
    out, cur, frame = [], None, (0, 0, 0)
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = m.group(1)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            frame = tuple(int(x) for x in m.groups())
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and cur is not None:
            if any(nm in cur for nm in names):
                try:
                    shown = subprocess.run(
                        ["c++filt", cur], capture_output=True, text=True,
                        timeout=30).stdout.strip()
                    shown = shown.replace("(anonymous namespace)::",
                                          "").split("(")[0]
                except OSError:
                    shown = cur
                out.append((shown or cur, int(m.group(1))) + frame)
            cur, frame = None, (0, 0, 0)
    return out


def viewer_rays(camera, w, h, device, perm=None):
    """The viewer's primary rays (its `_trace`) as a flat batch, in the
    order of `perm` (image-row order without it)."""
    vx, vy, vz, p = camera.ispc_camera(w, h, device=device)
    x, y = pixel_coords(w, h, perm, device=device)
    d = normalize(x[..., None] * vx + y[..., None] * vy + vz)
    n = d.shape[0]
    return Rays(p.broadcast_to(d.shape).contiguous(), d,
                torch.zeros(n, dtype=torch.float32, device=device),
                torch.full((n,), math.inf, dtype=torch.float32,
                           device=device))


def golden_fraction(img, name):
    """Share of the pixels of `img` more than 1.5/255 off the reference
    binaries' render `name`, after the reference's RGBA8 quantization
    (tests/test_ref_golden.py's comparison)."""
    ref = read_pfm(os.path.join(GOLDEN_DIR, name))
    q = np.floor(255.0 * np.clip(img.cpu().numpy(), 0.0, 1.0)) / 255.0
    if q.shape != ref.shape:
        raise AssertionError(f"{name}: shape {q.shape}, expected {ref.shape}")
    return float((np.abs(q - ref).max(-1) > 1.5 / 255).mean())


def tensor_bytes(*tensors):
    return sum(a.numel() * a.element_size() for a in tensors)


def demo_crop_check(state, cam, w, h, device):
    """`viewer.render` (geometric normals) of a DEMO_CROP crop in the
    middle of the w x h frame, on the card and on the CPU (the committed
    scene and the viewer's tables moved there through torch.save): at
    most 0.5 % of the pixels more than 1.5/255 apart."""
    cw, ch = DEMO_CROP
    x0, y0 = (w - cw) // 2, (h - ch) // 2
    keys = ("cscene", "materials", "geom_mat", "textures", "kd_tex",
            "tri_uv", "prim_base")
    buf = io.BytesIO()
    torch.save([state[k] for k in keys], buf)
    buf.seek(0)
    cpu = torch.device("cpu")
    imgs = []
    for dv, sargs in ((device, [state[k] for k in keys]),
                      (cpu, torch.load(buf, map_location=cpu,
                                       weights_only=False))):
        vx, vy, vz, p = cam.ispc_camera(w, h, device=dv)
        perm, inv = pixel_morton_order_device(cw, ch, dv)
        imgs.append(viewer_tutorial.render(
            *sargs, vx, vy, vz + x0 * vx + y0 * vy, p, perm, inv,
            width=cw, height=ch).cpu().numpy())
    diff = np.abs(imgs[0] - imgs[1]).max(-1)
    bad = float((diff > 1.5 / 255).mean())
    lit = float((imgs[0].max(-1) > 0).mean())
    if not (np.isfinite(imgs[0]).all() and bad <= 0.005 and lit > 0.3):
        raise AssertionError(f"the geometric-normal crop: {bad:.4%} of the "
                             f"pixels differ from the CPU's, {lit:.2%} lit")
    log(f"  geometric-normal frame, the {cw}x{ch} crop at ({x0}, {y0}) of "
        f"the {w}x{h} frame: card against CPU {bad:.4%} of the pixels more "
        f"than 1.5/255 apart (budget 0.5 %), largest difference "
        f"{float(diff.max()):.3g}, {lit:.2%} lit")


def demo_phase(device, prof):
    """Phase 23: the paper's demo through `viewer.make_app().run`, its
    commit, device bytes, the frame split into its parts, B4 against its
    plain version, smooth normals against the CPU, the golden, and the
    times of `Scene.interpolate`. Returns (B4's worst |t| error, B4's
    plain ms)."""
    w, h = DEMO_SIZE
    app = viewer_tutorial.make_app()
    build = app.build_scene
    kept = {}

    def build_and_keep(a):
        t0 = time.perf_counter()
        kept["state"] = build(a)
        torch.cuda.synchronize()
        kept["build_s"] = time.perf_counter() - t0
        return kept["state"]

    app.build_scene = build_and_keep
    prof.samples.clear()
    out = io.StringIO()
    with Launches() as lc, contextlib.redirect_stdout(out):
        rc = app.run(["-i", DEMO_OBJ, "--compress.leaf",
                      "--subdLvl", str(DEMO_LEVELS[0]),
                      "--compLvl", str(DEMO_LEVELS[1]),
                      "--size", str(w), str(h),
                      "--vp", *map(str, DEMO_CAMERA["from_"]),
                      "--vi", "0", "0", "0", "--fov", "90",
                      "--benchmark", "1", str(DEMO_FRAMES),
                      "-rtcore", "ignore_config_files=1"])
        torch.cuda.synchronize()
    print(out.getvalue(), end="")
    if rc != 0:
        raise AssertionError(f"viewer returned {rc}")
    bench = dict(line.split() for line in out.getvalue().splitlines()
                 if line.startswith("BENCHMARK_RENDER_"))
    frames = DEMO_FRAMES + 2
    lc.expect(f"viewer: {frames} frames", 0, 0)
    lc.expect_cbvh(f"viewer: {frames} frames", frames, 0)
    state = kept["state"]
    scene, cs = state["scene"], state["cscene"]
    pc = cs.compressed_kernel
    (gid, g), = scene.geometries.items()
    log(f"  commit() {kept['build_s']:.1f} s (the whole build_scene): "
        + ", ".join(f"{k} {prof.stats(k)['avg']:.2f} s"
                    for k in prof.samples))
    ev = scene.subdiv_eval[gid]
    table = scene._attr_cache[("nrm_fused", gid)]
    cells = pc.num_tiles * (1 << pc.comp_level) ** 2
    log(f"  {g.num_prims} faces, {pc.num_tiles} tiles of "
        f"{(1 << pc.comp_level) ** 2} cells = {cells} cells, top BVH4 of "
        f"{pc.num_nodes} nodes in {pc.top_depth} levels; on the card: the "
        f"compact accel {pc.device_bytes / 1e6:.1f} MB, the committed scene "
        f"{_scene_bytes(cs) / 1e6:.1f} MB, the SubdivEval "
        f"{tensor_bytes(*ev[:5]) / 1e6:.1f} MB, the fused normal table "
        f"{tensor_bytes(table) / 1e6:.1f} MB")
    if cs.compressed.tiles.space is not None or ev.verts.device != device:
        raise AssertionError("the demo's committed scene is not compact or "
                             "its SubdivEval is not on the card")
    cam = Camera(**DEMO_CAMERA)
    # the frame, and each part of it on its own, CUDA events
    perm, inv = pixel_morton_order_device(w, h, device)
    rays = viewer_rays(cam, w, h, device, perm)
    args = (cs, state["materials"], state["geom_mat"], state["textures"],
            state["kd_tex"], state["tri_uv"], state["prim_base"],
            *cam.ispc_camera(w, h, device=device), perm)
    kd, valid, d, gidh, prim, u, v, ng = viewer_tutorial._trace(
        *args, width=w, height=h)
    st = ck.intersect_compressed_kernel(pc, rays, t_in=rays.tfar)
    nrm = viewer_tutorial.shade_normals(scene, valid, gidh, prim, u, v, ng)
    flat_img = viewer_tutorial._shade(kd, valid, d, nrm)
    # the geometric-normal frame: `render` and render_frame(smooth_normals=
    # False) give one image, B4's hits shaded with the raw Ng (1, 0, 0)
    geo_args = (*args[:7], *cam.ispc_camera(w, h, device=device), perm, inv)
    with Launches() as lc:
        geo = viewer_tutorial.render(*geo_args, width=w, height=h)
        geo_rf, _ = viewer_tutorial.render_frame(state, cam, (w, h),
                                                 smooth_normals=False)
        demo_crop_check(state, cam, w, h, device)
        torch.cuda.synchronize()
    lc.expect("the geometric-normal frames", 0, 0)
    lc.expect_cbvh("the geometric-normal frames and the crop", 3, 0)
    dummy = torch.tensor([1.0, 0.0, 0.0], device=device)
    if not (torch.equal(geo, geo_rf) and (ng[valid] == dummy).all()
            and geo.shape == (h, w, 3)):
        raise AssertionError("viewer.render and render_frame(smooth_normals="
                             "False) differ, or a hit's raw Ng is not B4's")
    log(f"  {w}x{h} geometric-normal frame: viewer.render equals "
        "render_frame(smooth_normals=False) bit for bit; every hit's raw Ng "
        "is B4's (1, 0, 0)")
    parts = {
        "frame (render_frame)": lambda: viewer_tutorial.render_frame(
            state, cam, (w, h)),
        "geometric-normal frame (render)": lambda: viewer_tutorial.render(
            *geo_args, width=w, height=h),
        "render_frame(smooth_normals=False)":
            lambda: viewer_tutorial.render_frame(state, cam, (w, h),
                                                 smooth_normals=False),
        "trace + materials (_trace)": lambda: viewer_tutorial._trace(
            *args, width=w, height=h),
        "B4 (cbvh kernel)": lambda: ck.intersect_compressed_kernel(
            pc, rays, t_in=rays.tfar),
        "compressed_hits": lambda: compressed_hits(cs.compressed, rays, st),
        "smooth normals (interpolate_normal)":
            lambda: viewer_tutorial.shade_normals(scene, valid, gidh, prim,
                                                  u, v, ng),
        "shading": lambda: viewer_tutorial._shade(kd, valid, d, nrm),
        "unsort": lambda: flat_img[inv],
    }
    ms = {k: time_ms(f) for k, f in parts.items()}
    frame_ms = ms["frame (render_frame)"]
    log(f"  {w}x{h} frame, {int(valid.sum())} of {w * h} rays hit: "
        + "; ".join(f"{k} {v:.3f} ms" for k, v in ms.items())
        + f"; {1e3 / frame_ms:.1f} frames/s by CUDA events, "
        f"BENCHMARK_RENDER_AVG {float(bench['BENCHMARK_RENDER_AVG']):.1f} "
        f"frames/s (host clock); B4 {w * h / ms['B4 (cbvh kernel)'] / 1e3:.1f}"
        " Mray/s")
    # the golden frame, B4 against its plain version on its every ray and
    # on 2^16 rays spread over the big frame (every k-th in Morton order)
    gw, gh = DEMO_GOLDEN_SIZE
    img, _ = viewer_tutorial.render_frame(state, cam, (gw, gh))
    frac = golden_fraction(img, "ref_bomberman_160.pfm")
    if frac > 0.025:
        raise AssertionError(f"bomberman: {frac:.4%} of the pixels differ "
                             "from the reference render (budget 2.5 %)")
    log(f"  {gw}x{gh} frame: {frac:.4%} of the pixels differ from "
        "ref_bomberman_160.pfm by more than 1.5/255 (budget 2.5 %)")
    grays = viewer_rays(cam, gw, gh, device)
    err, plain_ms, _, _ = compare_cbvh_plain(
        pc, grays, f"bomberman {gw}x{gh}, every ray")
    step = max(1, (w * h) >> 16)
    head = Rays(*(a[::step][:1 << 16].contiguous() for a in rays))
    e2, _, _, _ = compare_cbvh_plain(
        pc, head, f"bomberman {w}x{h}, 2^16 rays (every {step}th in Morton "
        "order)")
    # smooth normals on the card against the port on the CPU
    hg = scene_intersect(cs, grays, coherent=True)
    m = hg.valid
    n_card = scene.interpolate_normal(gid, hg.prim_id[m], hg.u[m], hg.v[m])
    ev_cpu = SubdivEval(*(a.cpu() for a in ev[:5]), ev.grid_res)
    n_cpu = sample_normal_fused(fused_normal_table(ev_cpu), ev_cpu,
                                hg.prim_id[m].cpu().clamp_min(0),
                                hg.u[m].cpu(), hg.v[m].cpu())
    nerr = float((n_card.cpu() - n_cpu).abs().max())
    if nerr > 1e-6:
        raise AssertionError(f"interpolate_normal: card and CPU {nerr:g} "
                             "apart")
    log(f"  interpolate_normal at the {int(m.sum())} hits of the {gw}x{gh} "
        f"frame: card and CPU within {nerr:.3g} (tolerance 1e-6)")
    # Scene.interpolate on 2^20 random (face, u, v)
    rng = np.random.default_rng(DEMO_SEED)
    nq = 1 << DEMO_INTERP_LOG2
    face = torch.from_numpy(rng.integers(0, g.num_prims, nq)).to(device)
    uq = torch.from_numpy(rng.random(nq, np.float32)).to(device)
    vq = torch.from_numpy(rng.random(nq, np.float32)).to(device)
    t0 = time.perf_counter()
    scene.interpolate(gid, face[:1], uq[:1], vq[:1], derivatives=True)
    pt_s = time.perf_counter() - t0
    pt, verts_iso = scene._patch_tables[gid]
    ptab = patch_tensors(pt, device)
    dv = scene.interpolate(gid, face, uq, vq, derivatives=True)
    if not all(torch.isfinite(x).all() for x in dv.values()):
        raise AssertionError("interpolate(derivatives=True): not finite")
    k = 4096
    dv_cpu = eval_patch_table(pt, verts_iso.cpu(), face[:k].cpu(),
                              uq[:k].cpu(), vq[:k].cpu())
    derr = {key: float((dv[key][:k].cpu() - x).abs().max()
                       / x.abs().max().clamp_min(1e-30))
            for key, x in dv_cpu.items()}
    # second derivatives and Ng at 5e-4: on points next to an EV they are
    # ill-conditioned in float32 (up to 2.4e-4 between card and CPU)
    dtol = {"P": 1e-5, "dPdu": 1e-4, "dPdv": 1e-4}
    if any(e > dtol.get(key, 5e-4) for key, e in derr.items()):
        raise AssertionError(f"interpolate(derivatives=True): card and CPU "
                             f"apart {derr}")
    g.vertex_attributes.append(
        rng.random((np.asarray(g.vertices).shape[0], 3), np.float32))
    scene.interpolate(gid, face[:1], uq[:1], vq[:1], slot=0)
    t_d = time_ms(lambda: scene.interpolate(gid, face, uq, vq,
                                            derivatives=True), reps=3)
    t_s = time_ms(lambda: scene.interpolate(gid, face, uq, vq, slot=0))
    t_n = time_ms(lambda: scene.interpolate(gid, face, uq, vq))
    log(f"  Scene.interpolate on 2^{DEMO_INTERP_LOG2} random (face, u, v): "
        f"derivatives=True {t_d:.3f} ms ({len(pt.ladders)} ladders of "
        f"{pt.kind.shape[0]} iso quads, "
        f"{tensor_bytes(*[x for x in ptab.lad.values()]) / 1e6:.1f} MB of "
        f"ladder tables; the patch table built in {pt_s:.1f} s on the host), "
        f"slot=0 {t_s:.3f} ms, (P, N) {t_n:.3f} ms; the first 4096 against "
        "the CPU: " + ", ".join(f"{a} {b:.2g}" for a, b in derr.items())
        + " of the largest entry (limits P 1e-5, dPdu and dPdv 1e-4, the "
        "rest 5e-4)")
    return max(err, e2), plain_ms


def tutorial_phase(device):
    """Phase 24: the subdivision_geometry and interpolation tutorials at
    512x512, their goldens or CPU frames, and B2 and B4 against their
    plain versions on each tutorial's primary rays. Returns (B2's worst
    error, B4's worst error)."""
    pk_err = cb_err = 0.0
    for name, mod, argv, packet, cbvh in (
            ("subdivision_geometry", subdiv_tutorial,
             ["--subdLvl", "6"], 2, 0),
            ("interpolation", interp_tutorial, [], 1, 1)):
        app = mod.make_app()
        app.default_size = (TUTORIAL_SIZE, TUTORIAL_SIZE)
        out = io.StringIO()
        with Launches() as lc, contextlib.redirect_stdout(out):
            rc = app.run(argv + ["--benchmark", "1", "3",
                                 "-rtcore", "ignore_config_files=1"])
            torch.cuda.synchronize()
        print(out.getvalue(), end="")
        if rc != 0:
            raise AssertionError(f"{name} returned {rc}")
        lc.expect(f"{name}: 5 frames", 0, 5 * packet)
        lc.expect_cbvh(f"{name}: 5 frames", 5 * cbvh, 0)
        fps = float(dict(line.split() for line in out.getvalue().splitlines()
                         if line.startswith("BENCHMARK_RENDER_"))
                    ["BENCHMARK_RENDER_AVG"])
        state = app.build_scene(app)
        cs = state["cscene"]
        rays = viewer_rays(app.camera, TUTORIAL_SIZE, TUTORIAL_SIZE, device)
        for occl in (False, True):
            e, _ = compare_packet_plain(
                cs.packet, rays, occl, False,
                f"{name} {TUTORIAL_SIZE}x{TUTORIAL_SIZE} primary rays, "
                f"{'occluded' if occl else 'closest'}")
            pk_err = max(pk_err, e)
        if cs.compressed_kernel is not None:
            e, _, _, _ = compare_cbvh_plain(
                cs.compressed_kernel, rays,
                f"{name} {TUTORIAL_SIZE}x{TUTORIAL_SIZE} primary rays")
            cb_err = max(cb_err, e)
        if name == "subdivision_geometry":
            # the app's scene: level 6, eager, as the reference's render
            img, _ = mod.render_frame(state, Camera(from_=(1.5, 1.5, -1.5),
                                                 to=(0, 0, 0)), (128, 128))
            frac = golden_fraction(img, "ref_subdivision_128.pfm")
            if frac > 0.002:
                raise AssertionError(f"{name}: {frac:.4%} of the pixels "
                                     "differ from the reference render")
            what = (f"128x128: {frac:.4%} of the pixels differ from "
                    "ref_subdivision_128.pfm (budget 0.2 %)")
        else:
            imgs = [mod.render_frame(mod.build_scene(rtcore=rt), app.camera,
                                     (64, 64))[0].cpu().numpy()
                    for rt in ("ignore_config_files=1", "device=cpu")]
            bad = float((np.abs(imgs[0] - imgs[1]).max(-1) > 1.5 / 255)
                        .mean())
            if bad > 0.005 or imgs[0].max() < 0.2:
                raise AssertionError(f"{name}: {bad:.4%} of the pixels "
                                     "differ from the CPU render")
            what = (f"64x64: {bad:.4%} of the pixels differ from this "
                    "package's CPU render (budget 0.5 %)")
        log(f"  {name} at {TUTORIAL_SIZE}x{TUTORIAL_SIZE}: {fps:.1f} frames/s "
            f"(BENCHMARK_RENDER_AVG, host clock); {what}")
    return pk_err, cb_err


@contextlib.contextmanager
def plain_kernels():
    """The scene's kernel entry points answered by the kernels' plain
    versions, on the card's tensors, while the block runs: a request then
    goes through the whole fold (transforms, entry cull, finalize) with
    the plain versions where the kernels were."""
    def packet_raw(ps, rays, cull=False, ray_mask=None):
        t, prim = pk.packet_plain(ps, rays, False, cull, ray_mask=ray_mask)
        return t, pk._to_orig(ps, prim)

    def packet_occluded(ps, rays, cull=False, ray_mask=None):
        t, _ = pk.packet_plain(ps, rays, True, cull, ray_mask=ray_mask)
        return (t == -math.inf).reshape(rays.batch_shape)

    def treelet(ts, rays, occluded=False, cull=False):
        return rt2.rowtrace2_plain(ts, rays, occluded, cull)

    def cbvh_closest(pc, rays, t_in=None):
        t, u, v, tile = ck.cbvh_plain(pc, Rays(
            rays.org, rays.dir, rays.tnear,
            rays.tfar if t_in is None else t_in.reshape(-1).contiguous()))
        u, v = cbvh_mod.remap_uv(pc.uv0, pc.uvd, u, v, tile)
        return cbvh_mod._CHit(t=t, u=u, v=v, tile=tile)

    def cbvh_occluded(pc, rays):
        return ck.cbvh_occluded_plain(pc, rays).reshape(rays.batch_shape)

    swap = {"intersect_packet_kernel_raw": packet_raw,
            "occluded_packet_kernel": packet_occluded,
            "intersect_rowtrace2": treelet,
            "intersect_compressed_kernel": cbvh_closest,
            "occluded_compressed_kernel": cbvh_occluded}
    saved = {k: getattr(scene_mod, k) for k in swap}
    for k, fn in swap.items():
        setattr(scene_mod, k, fn)
    try:
        yield
    finally:
        for k, fn in saved.items():
            setattr(scene_mod, k, fn)


def same_hits(label, a, b):
    """Two Hits equal bit for bit (floats compared as their bits); the
    largest |t| difference (0)."""
    n = a.t.numel()
    for name in a._fields:
        x, y = getattr(a, name), getattr(b, name)
        if x.dtype == torch.float32:
            x, y = x.view(torch.int32), y.view(torch.int32)
        if not torch.equal(x, y):
            raise AssertionError(
                f"{label}: {name} differs on "
                f"{int((x != y).reshape(n, -1).any(1).sum())} rays")
    return 0.0


def fold_against_plain(label, scene, rays, coherent=False):
    """A request through the kernels against the same request with the
    plain versions in their place, on the same card tensors: every field
    of the hits bit for bit (t at 0 ulp, prim_id, geom_id, inst_id
    equal), occlusion equal. Returns the largest error, 0.0."""
    h_k = scene.intersect(rays, coherent=coherent)
    o_k = scene.occluded(rays)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with plain_kernels():
        h_p = scene.intersect(rays, coherent=coherent)
        o_p = scene.occluded(rays)
        torch.cuda.synchronize()
    plain_ms = 1e3 * (time.perf_counter() - t0)
    err = same_hits(label, h_k, h_p)
    if not torch.equal(o_k, o_p):
        raise AssertionError(f"{label}: occlusion differs from the plain "
                             f"fold on {int((o_k != o_p).sum())} rays")
    # (conservative compressed modes may be occluded without a hit)
    if (h_k.valid & ~o_k).any():
        raise AssertionError(f"{label}: a hit is not occluded")
    log(f"  {label}: {rays.tnear.numel()} rays, {int(h_k.valid.sum())} hits "
        f"({int((h_k.inst_id >= 0).sum())} in instances): kernels == the "
        f"whole fold through the plain versions bit for bit (t, u, v, Ng, "
        f"prim_id, geom_id, gprim, inst_id), occlusion equal "
        f"({int(o_k.sum())} occluded); plain {plain_ms:.0f} ms")
    return err


def device_profile(fn):
    """One call of `fn` under torch.profiler (CUPTI): the summed device
    time of its kernels (ms), the device time (ms) of each PyTorch op and
    each kernel launched outside one (B1's and B2's through ctypes), most
    first, the profiled call's own wall time (ms, host clock,
    synchronized) and the number of kernels it launched; (0.0, [], ms, 0)
    where the profiler saw no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    rows = prof.key_averages()
    kernels = [e for e in rows if e.device_type == DeviceType.CUDA]
    by_op = sorted([(e.self_device_time_total / 1e3, e.key) for e in rows
                    if e.device_type == DeviceType.CPU
                    and e.self_device_time_total > 0]
                   + [(e.self_device_time_total / 1e3, e.key)
                      for e in kernels if "packet_kernel" in e.key
                      or "rowtrace2_kernel" in e.key],
                   reverse=True)
    return (sum(e.self_device_time_total for e in kernels) / 1e3, by_op,
            wall_ms, sum(e.count for e in kernels))


def grid_instances(rng):
    """(local -> world (3, 4) f32) of the inst-grid: 8 x 8 on a grid of
    spacing 3 in x and z, each a random rotation (a unit quaternion) and
    a uniform scale in [0.5, 1.5]."""
    out = []
    for i in range(INST_GRID):
        for k in range(INST_GRID):
            q = rng.normal(size=4)
            w, x, y, z = q / np.linalg.norm(q)
            R = np.array([
                [1 - 2 * (y * y + z * z), 2 * (x * y - z * w),
                 2 * (x * z + y * w)],
                [2 * (x * y + z * w), 1 - 2 * (x * x + z * z),
                 2 * (y * z - x * w)],
                [2 * (x * z - y * w), 2 * (y * z + x * w),
                 1 - 2 * (x * x + y * y)]])
            s = rng.uniform(0.5, 1.5)
            out.append(np.concatenate(
                [s * R, [[INST_SPACING * i], [0.0], [INST_SPACING * k]]],
                1).astype(np.float32))
    return out


def instance_brute_check(label, top_cs, child_cs, flat, hits):
    """2^INST_BRUTE_LOG2 rays (evenly strided) against every triangle of
    the child in every instance's local space and against the top level's
    triangles, the closest t a ray: valid equal, t within 1e-5 relative,
    inst_id equal where the best instance is not tied (within 1e-5)."""
    n = flat.tnear.shape[0]
    nb = 1 << INST_BRUTE_LOG2
    sel = torch.linspace(0, n - 1, nb, device=flat.tnear.device).long()
    br = Rays(*(a[sel].contiguous() for a in flat))
    inf = torch.full((nb,), math.inf, device=br.tnear.device)

    def closest(org, d, tris):
        best = inf.clone()
        for s in range(0, tris.num_prims, 4096):
            e = s + 4096
            ok, tt, _u, _v, _ng = intersect_triangle(
                org[:, None, :], d[:, None, :], br.tnear[:, None],
                br.tfar[:, None], tris.v0[None, s:e], tris.v1[None, s:e],
                tris.v2[None, s:e])
            tt = torch.where(ok, tt, math.inf).amin(dim=1)
            best = torch.minimum(best, tt)
        return best

    per = [closest(br.org, br.dir, top_cs.tris)]
    for inst in top_cs.instances:
        lorg, ldir = _to_local(inst, br)
        per.append(closest(lorg, ldir, child_cs.tris))
    per = torch.stack(per, dim=1)                   # (nb, 1 + instances)
    two = per.topk(2, dim=1, largest=False)
    best, who = two.values[:, 0], two.indices[:, 0]
    hit = torch.isfinite(best)
    k_valid, k_t = hits.valid.reshape(-1)[sel], hits.t.reshape(-1)[sel]
    if not torch.equal(hit, k_valid):
        raise AssertionError(f"{label}: brute force: valid masks differ on "
                             f"{int((hit != k_valid).sum())} rays")
    rel = (float(((best - k_t).abs() / k_t.abs())[hit].max())
           if hit.any() else 0.0)
    if not rel <= 1e-5:
        raise AssertionError(f"{label}: brute force: t differs by {rel:g} "
                             "relative")
    ids = torch.tensor([-1] + [i.inst_id for i in top_cs.instances],
                       device=who.device)[who]
    untied = hit & (two.values[:, 1] > best * (1 + 1e-5))
    k_inst = hits.inst_id.reshape(-1)[sel]
    if not torch.equal(ids[untied], k_inst[untied].long()):
        raise AssertionError(f"{label}: brute force: inst_id differs")
    log(f"  {label}: brute force over the child's {child_cs.tris.num_prims} "
        f"triangles in each of {len(top_cs.instances)} instances' spaces "
        f"and the top level's, {nb} rays: same valid mask "
        f"({int(hit.sum())} hits), t within {rel:g} relative, inst_id "
        f"equal on the {int(untied.sum())} untied hits")


def mixed_child_check(device, rng):
    """Phase 25's mixed child: one scene that holds a triangle sphere
    (B2), three user spheres (torch ops) and `sphere_cage(32)` in leaf
    mode (B4, B5), instanced MIXED_INSTANCES times. The request against
    the whole fold through the plain versions, bit for bit; then the
    child traced in every instance's space without the entry cull: the
    hits the cull drops are counted, and each must be a user or
    subdivision hit (ROADMAP.md C.2: the cull's boxes are the triangles'
    alone, as in the JAX package). Returns the largest error (0)."""
    child = ett.Scene(ett.Device(
        "ignore_config_files=1,subdiv_accel=bvh4.compressed.leaf"))
    tv, ti = triangle_sphere((0.0, 0.0, 0.0), 1.0, 60)
    child.attach(ett.TriangleMesh(tv, ti))                          # geom 0
    sph = MIXED_SPHERES
    child.attach(ett.UserGeometry(
        len(sph), lambda ids: (sph[ids, :3] - sph[ids, 3:],
                               sph[ids, :3] + sph[ids, 3:]),
        user_geometry.make_sphere_intersect(
            torch.from_numpy(sph).to(device))))                    # geom 1
    cv, cc, ci, disp = sphere_cage(SUBDIV_SMALL_CAGE, noise_displacement)
    child.attach(ett.SubdivMesh(cv + MIXED_CAGE_OFFSET, cc, ci,
                                displacement=disp))                # geom 2
    child.set_levels(*SUBDIV_SMALL_LEVELS)
    t0 = time.perf_counter()
    ccs = child.commit()
    torch.cuda.synchronize()
    child_s = time.perf_counter() - t0
    if (ccs.compressed_kernel is None or len(ccs.users) != 1
            or ccs.tris.num_prims != len(ti)):
        raise AssertionError("the mixed child is not triangles, a user "
                             "geometry and a compact compressed accel")
    top = ett.Scene(ett.Device("ignore_config_files=1"))
    xs = grid_instances(rng)[:MIXED_INSTANCES]
    for k, x in enumerate(xs):
        x[:, 3] = (0.0, 0.0, MIXED_SPACING * k)
        top.attach(ett.Instance(child, x))
    top_cs = top.commit()
    n = 1 << INST_PLAIN_LOG2
    centres = np.array([x[:, 3] for x in xs], np.float32)
    tgt = (centres[rng.integers(0, len(xs), n)]
           + rng.uniform(-6.0, 6.0, (n, 3))).astype(np.float32)
    org = rng.uniform((-12.0, -12.0, -12.0),
                      (12.0, 12.0, 12.0 + MIXED_SPACING * len(xs)),
                      (n, 3)).astype(np.float32)
    d = tgt - org
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    rays = ett.make_rays(org, d, device=device)
    label = (f"a mixed child ({len(ti)} triangles, {len(sph)} user "
             f"spheres, sphere_cage({SUBDIV_SMALL_CAGE}) leaf at levels "
             f"{SUBDIV_SMALL_LEVELS}; committed in {child_s:.1f} s), "
             f"{MIXED_INSTANCES} instances, 2^{INST_PLAIN_LOG2} rays")
    with Launches() as lc:
        err = fold_against_plain(label, top, rays)
    if lc.packet < 1 or lc.cbvh < 1 or lc.cbvh_occluded < 1:
        raise AssertionError(f"the mixed child: {lc.packet} B2, {lc.cbvh} "
                             f"B4 and {lc.cbvh_occluded} B5 launches")
    log(f"  the mixed child's requests (kernels, then the plain fold): "
        f"{lc.packet} B2, {lc.cbvh} B4, {lc.cbvh_occluded} B5 launches")
    hits = top.intersect(rays)
    flat = flat_rays(rays)
    best_t = torch.full_like(flat.tfar, math.inf)
    best_g = torch.full_like(hits.geom_id.reshape(-1), -1)
    for inst in top_cs.instances:
        lorg, ldir = _to_local(inst, flat)
        h = scene_intersect(ccs, Rays(lorg, ldir, flat.tnear, flat.tfar))
        closer = h.valid & (h.t < best_t)
        best_t = torch.where(closer, h.t, best_t)
        best_g = torch.where(closer, h.geom_id, best_g)
    seen = torch.isfinite(best_t)
    valid = hits.valid.reshape(-1)
    lost = seen & ~valid
    farther = seen & valid & (hits.t.reshape(-1) > best_t * (1 + 2e-2))
    dropped = lost | farther
    if (valid & ~seen).any():
        raise AssertionError("the mixed child: the fold hit where the child "
                             "without the cull has no hit")
    if (best_g[dropped] == 0).any():
        raise AssertionError("the mixed child: the cull dropped a triangle "
                             "hit")
    if not lost.any():
        raise AssertionError("the mixed child: the cull dropped no hit")
    log(f"  the mixed child without the entry cull (the child's own request "
        f"in each instance's space): {int(seen.sum())} hits; the fold has "
        f"{int(valid.sum())}: the cull drops {int(dropped.sum())} "
        f"({int(lost.sum())} rays left without a hit, {int(farther.sum())} "
        f"with a farther one), {int((best_g[dropped] == 1).sum())} on the "
        f"user spheres and {int((best_g[dropped] == 2).sum())} on the "
        "subdivision mesh, none on the triangles (ROADMAP.md C.2, as in the "
        "JAX package)")
    return err


def requests_of(state):
    """A tutorial state's committed scene answering `intersect` /
    `occluded` as a Scene does (its intersection filter included)."""
    cs, filter_fn = state["cscene"], state.get("filter_fn")
    return types.SimpleNamespace(
        intersect=lambda rays, coherent=False: scene_intersect(
            cs, rays, filter_fn=filter_fn, coherent=coherent),
        occluded=lambda rays: scene_occluded(cs, rays))


def instance_phase(device, main_scene, builder_job):
    """Phase 25: inst-grid (64 instances of (a)'s 99,012-triangle sphere,
    the child committed once, over a ground plane) through the entry
    points: request times, B2 launches a request, the share of rays each
    instance gathers and the share its entry cull retires, the gathered
    fold against every ray through every instance, device bytes, commit
    s; the kernels against the
    whole fold through the plain versions on 2^15 rays; a brute force in
    every instance's space; one instance of main's sphere (B1 serves the
    child) and two of a compressed child (B4, B5); the six tutorials of
    instances, user geometry and the rtcore facade (`bvh_builder` the
    host pool's `builder_job`). Returns the largest error of each kernel
    against its plain version (all 0)."""
    rng = np.random.default_rng(INST_SEED)
    dev = ett.Device("ignore_config_files=1")
    verts, idx = triangle_sphere((0.0, 0.0, 0.0), 1.0, SMALL_RES)
    child = ett.Scene(dev)
    child.attach(ett.TriangleMesh(verts, idx))
    t0 = time.perf_counter()
    child_cs = child.commit()
    torch.cuda.synchronize()
    child_s = time.perf_counter() - t0
    top = ett.Scene(dev)
    for x in grid_instances(rng):
        top.attach(ett.Instance(child, x))
    ext = INST_SPACING * (INST_GRID - 1)
    top.attach(ett.TriangleMesh(
        np.array([[-3, -2, -3], [ext + 3, -2, -3], [ext + 3, -2, ext + 3],
                  [-3, -2, ext + 3]], np.float32),
        np.array([[0, 1, 2], [0, 2, 3]], np.int32)))
    t0 = time.perf_counter()
    top_cs = top.commit()
    torch.cuda.synchronize()
    top_s = time.perf_counter() - t0
    n_inst = len(top_cs.instances)
    if n_inst != INST_GRID ** 2 or child_cs.tris.num_prims != len(idx):
        raise AssertionError(f"inst-grid: {n_inst} instances of "
                             f"{child_cs.tris.num_prims} triangles")
    if any(i.child is not child_cs for i in top_cs.instances):
        raise AssertionError("an instance holds a copy of the child")
    boxes = sum(i.cull_lower.shape[0] for i in top_cs.instances)
    table = tensor_bytes(*(a for i in top_cs.instances
                           for a in (i.cull_lower, i.cull_upper)))
    log(f"  commit: the child {child_s:.2f} s ({child_cs.tris.num_prims} "
        f"triangles, BVH{child_cs.packet.width} of "
        f"{child_cs.packet.num_nodes} nodes), the top {top_s:.2f} s "
        f"({n_inst} instances, {boxes} entry boxes, 2 ground triangles); "
        f"{n_inst * child_cs.tris.num_prims} instanced triangles")
    log(f"  device bytes: the child's compact packet scene "
        f"{child_cs.packet.device_bytes / 1e6:.1f} MB and its committed "
        f"scene {_scene_bytes(child_cs) / 1e6:.1f} MB, held once; the "
        f"top's own {_scene_bytes(top_cs) / 1e6:.3f} MB, of it the instance "
        f"tables {table / 1e3:.1f} kB; all "
        f"{_scene_bytes(top_cs, children=True) / 1e6:.1f} MB")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        top.print_statistics()
    log("  " + out.getvalue().strip())

    n = 1 << LOG2_RAYS
    lo = np.array([-3.0 - 3, -2.0 - 3, -3.0 - 3], np.float32)
    hi = np.array([ext + 6, 1.5 + 3, ext + 6], np.float32)
    org = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    rays = ett.make_rays(org, unit_dirs(rng, n), device=device)
    cam = Camera(from_=(ext / 2, 14.0, -7.0), to=(ext / 2, 0.0, ext / 2))
    frame = primary_rays(cam, FRAME[0], FRAME[1], device=device)
    nf = FRAME[0] * FRAME[1]
    want = n_inst + 1       # one B2 launch an instance, one for the ground
    with Launches() as lc:
        hits = top.intersect(rays)
        occ = top.occluded(rays)
        torch.cuda.synchronize()
    lc.expect("inst-grid: 1 intersect + 1 occluded request", 0, 2 * want)
    check_hits("inst-grid", hits, (n,))
    if not torch.equal(occ, hits.valid):
        raise AssertionError("inst-grid: occluded != valid")
    with Launches() as lc:
        fhits = top.intersect(frame, coherent=True)
        torch.cuda.synchronize()
    lc.expect("inst-grid: the coherent frame", 0, want)
    check_hits("inst-grid frame", fhits, (FRAME[1], FRAME[0]))
    # the rays each launch walks: the share of the request that the test
    # against the union of the instance's entry boxes gathers, and of the
    # request the share that passes the entry boxes themselves
    shares = []
    reaching = scene_mod._reaching

    def counting_reaching(inst, flat, tfar):
        sel, tfar_in = reaching(inst, flat, tfar)
        n_all = flat.tnear.shape[0]
        shares.append((sel.numel() / n_all,
                       float((tfar_in > -math.inf).sum()) / n_all))
        return sel, tfar_in

    scene_mod._reaching = counting_reaching
    try:
        top.intersect(rays)
        inc = np.array(shares)
        shares.clear()
        top.intersect(frame, coherent=True)
        frm = np.array(shares)
    finally:
        scene_mod._reaching = reaching
    for what, a in ((f"2^{LOG2_RAYS} incoherent rays", inc),
                    ("the frame", frm)):
        log(f"  rays a launch walks, {what}: gathered by the union box "
            f"mean {a[:, 0].mean():.4f} of the request (min "
            f"{a[:, 0].min():.4f}, max {a[:, 0].max():.4f}), of them "
            f"through the entry boxes mean {a[:, 1].mean():.4f}; the entry "
            f"cull retires {1 - a[:, 1].mean():.4f} (tfar = -inf or not "
            "gathered)")
    times = {}
    for label, fn, nr in (
            (f"intersect, 2^{LOG2_RAYS} incoherent rays",
             lambda: top.intersect(rays), n),
            (f"occluded, 2^{LOG2_RAYS} incoherent rays",
             lambda: top.occluded(rays), n),
            (f"intersect, {FRAME[0]}x{FRAME[1]} coherent frame",
             lambda: top.intersect(frame, coherent=True), nf),
            (f"occluded, {FRAME[0]}x{FRAME[1]} frame",
             lambda: top.occluded(frame), nf)):
        ms = time_ms(fn)
        times[label] = ms
        log(f"  inst-grid {label}: {ms:.3f} ms, {nr / ms / 1e3:.1f} Mray/s "
            f"({want} B2 launches a request)")
    # the same requests with every ray through every instance, the culled
    # ones at tfar = -inf (the JAX package's shape, and the port's fold
    # before it gathered), timed in turn with the gathered fold; the
    # answers equal bit for bit
    def every_ray(inst, flat, tfar):
        if inst.cull_lower is None:
            return None, tfar
        reach = _entry_cull(inst.cull_lower, inst.cull_upper, flat, tfar)
        return None, torch.where(reach, tfar, -math.inf)

    gathered = scene_mod._reaching
    for label, fn in ((f"2^{LOG2_RAYS} incoherent rays",
                       lambda: top.intersect(rays)),
                      (f"the {FRAME[0]}x{FRAME[1]} frame",
                       lambda: top.intersect(frame, coherent=True))):
        runs, out = [], {}
        for what in ("gathered", "every ray", "every ray", "gathered"):
            scene_mod._reaching = gathered if what == "gathered" else every_ray
            try:
                runs.append(time_ms(fn))
                out.setdefault(what, fn())
            finally:
                scene_mod._reaching = gathered
        same_hits(f"inst-grid {label}: gathered against every ray",
                  out["gathered"], out["every ray"])
        ms_g, ms_e = (runs[0] + runs[3]) / 2, (runs[1] + runs[2]) / 2
        log(f"  inst-grid intersect, {label}: the gathered fold "
            f"{ms_g:.3f} ms, every ray through every instance {ms_e:.3f} "
            f"ms ({ms_e / ms_g:.1f}x; runs gathered, every ray, every ray, "
            "gathered, each a median of 5: "
            + ", ".join(f"{x:.3f}" for x in runs) + "); hits equal bit for "
            "bit")
    label = f"intersect, 2^{LOG2_RAYS} incoherent rays"
    dev_ms, rows, _, _ = device_profile(lambda: top.intersect(rays))
    if dev_ms > 0:
        b2 = sum(ms for ms, k in rows if "packet_kernel" in k)
        log(f"  inst-grid {label} under torch.profiler: its kernels "
            f"{dev_ms:.1f} ms of the request's {times[label]:.1f} ms "
            f"unprofiled ({100 * dev_ms / times[label]:.0f} % busy), B2 "
            f"{b2:.1f} ms; by op: " + "; ".join(
                f"{k[:40]} {ms:.1f} ms" for ms, k in rows[:10]))
    else:
        log(f"  inst-grid {label}: device busy share not measured (the "
            "profiler saw no device time)")
    # one launch alone: the child's B2 over the incoherent rays that one
    # instance gathers, moved into its space; beside it the box test over
    # every ray, which the fold ran for each instance before it gathered
    flat = flat_rays(rays)
    inst = top_cs.instances[27]
    sel, tfar_in = scene_mod._reaching(inst, flat, flat.tfar)
    sub = Rays(*(a[sel] for a in flat))
    lorg, ldir = _to_local(inst, sub)
    lrays = Rays(lorg, ldir, sub.tnear, tfar_in)
    one_ms = time_ms(lambda: pk.packet_trace(child_cs.packet, lrays))
    reach_ms = time_ms(lambda: scene_mod._reaching(inst, flat, flat.tfar))
    xfm_ms = time_ms(lambda: _to_local(inst, sub))
    cull_ms = time_ms(lambda: _entry_cull(inst.cull_lower, inst.cull_upper,
                                          flat, flat.tfar))
    log(f"  one instance alone, 2^{LOG2_RAYS} rays: {sel.numel()} gathered, "
        f"{int((tfar_in > -math.inf).sum())} through its entry boxes; B2 "
        f"over them {one_ms:.3f} ms, the gather and cull {reach_ms:.3f} "
        f"ms, their transform {xfm_ms:.3f} ms (the box test over every "
        f"ray {cull_ms:.3f} ms)")

    # correctness: the fold against the plain fold, and a brute force
    head = Rays(*(a[:1 << INST_PLAIN_LOG2].contiguous() for a in rays))
    err = fold_against_plain(
        f"inst-grid, the first 2^{INST_PLAIN_LOG2} incoherent rays", top,
        head)
    instance_brute_check("inst-grid", top_cs, child_cs, flat, hits)

    # B1 serves a child: one instance of main's sphere
    big = ett.Scene(dev)
    bx = grid_instances(rng)[0]
    bx[:, 3] = 0.0
    big.attach(ett.Instance(main_scene, bx))
    big.commit()
    nb1 = 1 << INST_B1_LOG2
    b1_rays = ett.make_rays(
        rng.uniform(-4.0, 4.0, (nb1, 3)).astype(np.float32),
        unit_dirs(rng, nb1), device=device)
    with Launches() as lc:
        h = big.intersect(b1_rays)
        big.occluded(b1_rays)
        torch.cuda.synchronize()
    lc.expect("an instance of main's sphere: 1 intersect + 1 occluded", 2, 0)
    b1_err = fold_against_plain(
        f"an instance of main's 998,284 triangles, 2^{INST_B1_LOG2} rays "
        "(B1 serves the child)", big, b1_rays)
    log(f"  {int(h.valid.sum())} hits; request "
        f"{time_ms(lambda: big.intersect(b1_rays)):.3f} ms")

    # B4 and B5 serve a child: two instances of a compressed cage (leaf)
    sub = subdiv_scene("", sphere_cage(SUBDIV_SMALL_CAGE,
                                       noise_displacement),
                       SUBDIV_SMALL_LEVELS, "leaf")
    pair = ett.Scene(dev)
    xs = grid_instances(rng)[:2]
    xs[1][:, 3] = xs[0][:, 3] + np.float32([4.5, 0.0, 0.0])
    for x in xs:
        pair.attach(ett.Instance(sub, x))
    pair.commit()
    n16 = 1 << 16
    c_org = rng.uniform(-5.0, 9.5, (n16, 3)).astype(np.float32)
    c_rays = ett.make_rays(c_org, unit_dirs(rng, n16), device=device)
    with Launches() as lc:
        pair.intersect(c_rays)
        pair.occluded(c_rays)
        torch.cuda.synchronize()
    lc.expect_cbvh("two instances of a compressed child", 2, 2)
    cb_err = fold_against_plain(
        f"two instances of sphere_cage({SUBDIV_SMALL_CAGE}) leaf at levels "
        f"{SUBDIV_SMALL_LEVELS}, 2^16 rays (B4, B5 serve the child)", pair,
        c_rays)
    mixed_err = mixed_child_check(device, rng)

    # the tutorials: 5 frames each through app.run; the card's frame
    # against the CPU's; each card scene's primary rays through the
    # kernels against the plain fold
    tut_err = 0.0
    for name, mod, per_frame in (
            ("instanced_geometry", instanced_geometry, 5),
            ("user_geometry", user_geometry, 2),
            ("intersection_filter", intersection_filter, None),
            ("lazy_geometry", lazy_geometry, None)):
        app = mod.make_app()
        app.default_size = (TUTORIAL_SIZE, TUTORIAL_SIZE)
        out = io.StringIO()
        with Launches() as lc, contextlib.redirect_stdout(out):
            rc = app.run(["--benchmark", "1", "3", "-rtcore",
                          "ignore_config_files=1"])
            torch.cuda.synchronize()
        print(out.getvalue(), end="")
        if rc != 0:
            raise AssertionError(f"{name} returned {rc}")
        if per_frame is not None:
            lc.expect(f"{name}: 5 frames", 0, 5 * per_frame)
        fps = float(dict(line.split() for line in out.getvalue().splitlines()
                         if line.startswith("BENCHMARK_RENDER_"))
                    ["BENCHMARK_RENDER_AVG"])
        states = [mod.build_scene(ett.Device(rt)) for rt in (
            "ignore_config_files=1", "ignore_config_files=1,device=cpu")]
        imgs = [mod.render_frame(st, app.camera, INST_TUTORIAL_SIZE)[0]
                .cpu().numpy() for st in states]
        bad = float((np.abs(imgs[0] - imgs[1]).max(-1) > 1.5 / 255).mean())
        if bad > 0.005 or imgs[0].max() < 0.2:
            raise AssertionError(f"{name}: {bad:.4%} of the pixels differ "
                                 "from the CPU render")
        if name == "lazy_geometry" and (states[0]["built"]
                                        != states[1]["built"]):
            raise AssertionError("lazy_geometry built other spheres on the "
                                 "card than on the CPU")
        log(f"  {name} at {TUTORIAL_SIZE}x{TUTORIAL_SIZE}: {fps:.1f} frames/s "
            f"(BENCHMARK_RENDER_AVG, host clock; {lc.packet} B2 launches in "
            f"5 frames); {INST_TUTORIAL_SIZE[0]}x{INST_TUTORIAL_SIZE[1]}: "
            f"{bad:.4%} of the pixels differ from this package's CPU render "
            "(budget 0.5 %)")
        # lazy_geometry's card scene holds the spheres its frame built
        tut_err = max(tut_err, fold_against_plain(
            f"{name} primary rays {TUTORIAL_SIZE}x{TUTORIAL_SIZE}",
            requests_of(states[0]),
            primary_rays(app.camera, TUTORIAL_SIZE, TUTORIAL_SIZE,
                         device=device), coherent=True))
    rc, lines, sec = builder_job.get(timeout=CAGE_TIMEOUT_S)
    if rc != 0 or not lines:
        raise AssertionError(f"bvh_builder returned {rc}")
    log(f"  bvh_builder ({sec:.1f} s in the host pool): " + "; ".join(lines))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = bvh_access.main(["-rtcore", "ignore_config_files=1"])
    lines = out.getvalue().splitlines()
    if rc != 0 or not lines:
        raise AssertionError(f"bvh_access returned {rc}")
    log(f"  bvh_access: {lines[-1]}")
    return {"packet": max(err, tut_err, mixed_err), "rowtrace2": b1_err,
            "cbvh": max(cb_err, mixed_err),
            "cbvh_occluded": max(cb_err, mixed_err)}


class KeyedSampler:
    """The pathtracer's uniforms from numpy generators keyed by (seed,
    sample, bounce, light): the same numbers on the card and on the CPU,
    whatever else the two renders draw."""

    def __init__(self, seed, n, device):
        self.seed, self.n, self.device = seed, n, device

    def _draw(self, key, k):
        a = np.random.default_rng([self.seed, *key]).random(
            (self.n, k), dtype=np.float32)
        return torch.from_numpy(a).to(self.device)

    def pixel(self, s):
        return self._draw((s, 0), 2)

    def light(self, s, bounce, li):
        return self._draw((s, 1, bounce, li), 2)

    def bsdf(self, s, bounce):
        return self._draw((s, 2, bounce), 3)


@contextlib.contextmanager
def checked_launches(errs, limit=None, first=None):
    """Every B1 and B2 launch that a request makes while the block runs is
    held against its plain version on the same inputs: t at 0 ulp and prim
    equal (closest), the answers equal (any hit). B2 is caught both where
    the scene's dispatch and where the packet walks of traverse/packet.py
    (the ring's hops among them) look it up. With `limit`, a launch of
    more rays is compared on a strided slice of `limit` of them (the
    kernel still runs on all); with `first`, only the first `first`
    launches of each kernel are compared. `errs` collects the largest
    error of each kernel, the launches checked and the rays compared."""
    names = ("intersect_packet_kernel_raw", "occluded_packet_kernel",
             "intersect_rowtrace2")
    b2_names = names[:2]
    kernel = {k: getattr(scene_mod, k) for k in names}
    b2_kernel = {k: getattr(pk, k) for k in b2_names}

    def skip(name):
        return first is not None and errs.get(name + "_checked", 0) >= first

    def part(rays, ray_mask):
        """(the rays compared, their mask, their flat indices or None)."""
        n = rays.tnear.numel()
        if limit is None or n <= limit:
            return rays, ray_mask, None
        sel = torch.arange(0, n, -(-n // limit), device=rays.tnear.device)
        sub = Rays(rays.org.reshape(-1, 3)[sel], rays.dir.reshape(-1, 3)[sel],
                   rays.tnear.reshape(-1)[sel], rays.tfar.reshape(-1)[sel])
        return sub, (None if ray_mask is None
                     else ray_mask.reshape(-1)[sel]), sel

    def picked(a, sel):
        a = a.reshape(-1)
        return a if sel is None else a[sel]

    def tally(name, sub):
        errs[name + "_checked"] = errs.get(name + "_checked", 0) + 1
        errs[name + "_rays"] = errs.get(name + "_rays", 0) + sub.tnear.numel()

    def closest(name, t, prim, tp, pp):
        e = ulp_distance(t, tp)
        if e != 0 or not torch.equal(prim, pp):
            raise AssertionError(f"{name}: a launch differs from its plain "
                                 f"version ({e} ulp)")
        errs[name] = max(errs.get(name, 0.0), float(e))

    def packet_raw(ps, rays, cull=False, ray_mask=None):
        t, prim = kernel["intersect_packet_kernel_raw"](ps, rays, cull,
                                                        ray_mask)
        if skip("packet"):
            return t, prim
        sub, mask, sel = part(rays, ray_mask)
        tp, pp = pk.packet_plain(ps, sub, False, cull, ray_mask=mask)
        closest("packet", picked(t, sel), picked(prim, sel), tp.reshape(-1),
                pk._to_orig(ps, pp).reshape(-1))
        tally("packet", sub)
        return t, prim

    def packet_occluded(ps, rays, cull=False, ray_mask=None):
        occ = kernel["occluded_packet_kernel"](ps, rays, cull, ray_mask)
        if skip("packet"):
            return occ
        sub, mask, sel = part(rays, ray_mask)
        tp, _ = pk.packet_plain(ps, sub, True, cull, ray_mask=mask)
        bad = int((picked(occ, sel) != (tp.reshape(-1) == -math.inf)).sum())
        if bad:
            raise AssertionError(f"packet any hit: {bad} rays differ from "
                                 "the plain version")
        tally("packet", sub)
        return occ

    def treelet(ts, rays, occluded=False, cull=False):
        t, prim = kernel["intersect_rowtrace2"](ts, rays, occluded, cull)
        if skip("rowtrace2"):
            return t, prim
        sub, _, sel = part(rays, None)
        tp, pp = rt2.rowtrace2_plain(ts, sub, occluded, cull)
        closest("rowtrace2", picked(t, sel), picked(prim, sel),
                tp.reshape(-1), pp.reshape(-1))
        tally("rowtrace2", sub)
        return t, prim

    swap = dict(zip(names, (packet_raw, packet_occluded, treelet)))
    for k, fn in swap.items():
        setattr(scene_mod, k, fn)
        if k in b2_kernel:
            setattr(pk, k, fn)
    try:
        yield errs
    finally:
        for k, fn in kernel.items():
            setattr(scene_mod, k, fn)
        for k, fn in b2_kernel.items():
            setattr(pk, k, fn)


def expect_requests(label, lc, counts):
    """One B1 or B2 launch a request of the pathtracer's frame."""
    if lc.packet + lc.rowtrace2 != counts["intersect"] + counts["occluded"]:
        raise AssertionError(f"{label}: {lc.packet} B2 and {lc.rowtrace2} "
                             f"B1 launches for {counts} requests")


def pt_check(label, states, camera):
    """The card's 64x64 1-spp frame (`states[0]`) against this package's
    CPU render (`states[1]`) with the same uniforms (KeyedSampler), every
    B1 and B2 launch of the card's frame against its plain version,
    ROWTRACE_MIN_RAYS lowered to PT_CHECK_MIN_RAYS in both. Returns the
    errors and the launches checked."""
    size = (PT_CHECK_SIZE, PT_CHECK_SIZE)
    n = PT_CHECK_SIZE * PT_CHECK_SIZE
    min_rays = scene_mod.ROWTRACE_MIN_RAYS
    scene_mod.ROWTRACE_MIN_RAYS = PT_CHECK_MIN_RAYS
    errs = {}
    try:
        imgs, secs = [], []
        for on_card, st in zip((True, False), states):
            sampler = KeyedSampler(PT_SEED, n, st["cscene"].device)
            t0 = time.perf_counter()
            if on_card:
                counts = {}
                with checked_launches(errs), Launches() as lc:
                    img, _ = pt_tutorial.render_frame(
                        st, camera, size, 1, PT_SEED, sampler, counts)
                    torch.cuda.synchronize()
                expect_requests(label, lc, counts)
            else:
                img, _ = pt_tutorial.render_frame(st, camera, size, 1,
                                                  PT_SEED, sampler)
            secs.append(time.perf_counter() - t0)
            imgs.append(img.cpu().numpy())
    finally:
        scene_mod.ROWTRACE_MIN_RAYS = min_rays
    a, b = imgs
    off = (np.abs(a - b) > 1e-4 * np.abs(b) + 1e-5).any(-1)
    share = 1.0 - float(off.mean())
    rel = abs(float(a.mean()) / float(b.mean()) - 1.0)
    if not (np.isfinite(a).all() and share >= 0.98 and rel <= 1e-3
            and b.mean() > 0.01):
        raise AssertionError(f"{label}: card against CPU: {share:.4%} of "
                             f"the pixels agree, means {a.mean():.6f} / "
                             f"{b.mean():.6f}")
    log(f"  {label} {PT_CHECK_SIZE}x{PT_CHECK_SIZE}, 1 spp, the same "
        f"uniforms: {share:.4%} of the card's pixels within 1e-4 relative + "
        f"1e-5 of the CPU render (budget 98 %), max |diff| "
        f"{float(np.abs(a - b).max()):.3g}, means {a.mean():.6f} / "
        f"{b.mean():.6f} ({rel:.2e} relative); card {secs[0]:.1f} s "
        f"(with the plain versions), CPU {secs[1]:.1f} s; "
        f"{errs.get('packet_checked', 0)} B2 and "
        f"{errs.get('rowtrace2_checked', 0)} B1 launches of the card's frame "
        "each equal to its plain version (t at 0 ulp, prim equal, any hit "
        "equal)")
    return errs


def pt_measure(label, state, camera, size, spp):
    """A 1-spp frame at `size` with every B1 and B2 launch held against
    its plain version on at most 2^PT_SLICE_LOG2 of its rays (the kernels
    chosen as the main path chooses them); then frame ms (host clock,
    synchronized, the median of PT_FRAMES, each printed), rays a frame
    (the live rays of every request), Mray/s, B1 and B2 launches a
    frame, and for a 1-spp frame under torch.profiler (whose processing
    grows with the kernels it records) its wall time, the card's busy
    share of it, the kernels' share of its device time and the kernels it
    launched. The errors of the checked frame are under "errs" (`checked_launches`)."""
    w, h = size
    chk, counts = {}, {}
    t0 = time.perf_counter()
    with checked_launches(chk, 1 << PT_SLICE_LOG2), Launches() as lc:
        pt_tutorial.render_frame(state, camera, size, 1, PT_SEED,
                                 counts=counts)
        torch.cuda.synchronize()
    expect_requests(label, lc, counts)
    log(f"  {label} {w}x{h}, 1 spp ({time.perf_counter() - t0:.1f} s with "
        f"the plain versions): {chk.get('packet_checked', 0)} B2 launches "
        f"({chk.get('packet_rays', 0)} rays compared) and "
        f"{chk.get('rowtrace2_checked', 0)} B1 launches "
        f"({chk.get('rowtrace2_rays', 0)} rays compared, at most "
        f"2^{PT_SLICE_LOG2} a launch) each equal to its plain version (t at "
        f"0 ulp, prim equal, any hit equal); {counts['rays']} rays")

    def frame():
        counts.clear()
        return pt_tutorial.render_frame(state, camera, size, spp, PT_SEED,
                                        counts=counts)

    dts = []
    for _ in range(PT_FRAMES):
        t0 = time.perf_counter()
        with Launches() as lc:
            img, _ = frame()
            torch.cuda.synchronize()
        dts.append(time.perf_counter() - t0)
    tally = dict(counts)
    ms = 1e3 * float(np.median(dts))
    img = img.cpu().numpy()
    if not (np.isfinite(img).all() and img.shape == (h, w, 3)
            and img.mean() > 0.01):
        raise AssertionError(f"{label}: the frame is not finite or empty")
    expect_requests(label, lc, tally)
    bound = spp * w * h * 2 * pt_tutorial.MAX_PATH_LENGTH
    dev_ms, rows, prof_ms, n_kernels = device_profile(
        lambda: pt_tutorial.render_frame(state, camera, size, 1, PT_SEED))
    if dev_ms > 0:
        k_ms = {k: sum(t for t, key in rows if k in key)
                for k in ("packet_kernel", "rowtrace2_kernel")}
        busy = (f"a 1-spp frame under torch.profiler took {prof_ms:.1f} "
                f"ms, its {n_kernels} kernels {dev_ms:.1f} ms of device time ("
                f"{100 * dev_ms / prof_ms:.0f} % busy), of it B2 "
                f"{k_ms['packet_kernel']:.1f} ms and B1 "
                f"{k_ms['rowtrace2_kernel']:.1f} ms ("
                f"{100 * sum(k_ms.values()) / dev_ms:.0f} % of the device "
                "time); by op: " + "; ".join(
                    f"{key[:32]} {t:.1f} ms" for t, key in rows[:8]))
    else:
        busy = "busy share not measured (the profiler saw no device time)"
    log(f"  {label} {w}x{h}, {spp} spp: {ms:.1f} ms a frame (median of "
        f"{PT_FRAMES}: " + ", ".join(f"{1e3 * x:.1f}" for x in dts)
        + f"), {tally['rays']} rays ({tally['intersect']} closest-hit and "
        f"{tally['occluded']} shadow requests; the JAX tutorial's bound "
        f"{bound}), {tally['rays'] / ms / 1e3:.1f} Mray/s; "
        f"{lc.packet} B2 and {lc.rowtrace2} B1 launches a frame; {busy}")
    return {"ms": ms, "rays": tally["rays"], "b2": lc.packet,
            "b1": lc.rowtrace2, "dev_ms": dev_ms, "errs": chk}


def glass_block_gate(img, ref):
    """tests/test_glass.py:197-244: under 10 % of the 16x16 blocks out of
    tolerance, the global mean within 5 %."""
    def blocks(a):
        return a.reshape(4, 16, 4, 16, 3).mean(axis=(1, 3))

    bi, br = blocks(img), blocks(ref)
    err = np.abs(bi - br)
    bad = err > 0.08 * np.maximum(br, 0.02) + 0.012
    rel = abs(float(bi.mean()) / float(br.mean()) - 1.0)
    if not (bad.mean() < 0.10 and rel <= 0.05):
        raise AssertionError(f"pt-glass: {int(bad.sum())}/{bad.size} blocks "
                             f"out of tolerance, means {bi.mean():.4f} / "
                             f"{br.mean():.4f}")
    return int(bad.sum()), bad.size, float(err.max()), rel


def pathtracer_phase():
    """Phase 26: the pathtracer tutorial on pt-cornell (the Cornell box,
    256x256 through `make_app().run --benchmark` and 1024x1024, B2 only),
    pt-glass (glass_sphere.xml through `load_xml`, 64x64, 6 seeds x 8 spp
    against ref_glass_64.pfm) and pt-glass-main (the sphere replaced by
    main's 998,284 triangles, 1024x1024: B1 and B2): frame ms, rays,
    Mray/s, launches, busy share; the card against the CPU at 64x64, and
    every launch of a 1-spp frame at each timed size against its plain
    version. Returns the largest error of B1 and B2 (0)."""
    errs = {"packet": 0.0, "rowtrace2": 0.0}

    def fold(e):
        for k in errs:
            errs[k] = max(errs[k], e.get(k, 0.0))

    dev = ett.Device("ignore_config_files=1")
    cpu = ett.Device("ignore_config_files=1", device="cpu")
    log("[26a] pt-cornell: the tutorial's Cornell box (17 quads, B2)")
    app = pt_tutorial.make_app()
    out = io.StringIO()
    with Launches() as lc, contextlib.redirect_stdout(out):
        rc = app.run(["--benchmark", "1", "3", "-rtcore",
                      "ignore_config_files=1"])
        torch.cuda.synchronize()
    print(out.getvalue(), end="")
    keys = dict(line.split() for line in out.getvalue().splitlines()
                if line.startswith("BENCHMARK_RENDER_"))
    if rc != 0 or "BENCHMARK_RENDER_AVG" not in keys:
        raise AssertionError(f"pathtracer returned {rc}")
    log(f"  pt-cornell through make_app().run --benchmark 1 3 at "
        f"{app.default_size[0]}x{app.default_size[1]}, 4 spp: "
        f"{float(keys['BENCHMARK_RENDER_AVG']):.2f} frames/s, "
        f"{float(keys['BENCHMARK_RENDER_MRAYPS_AVG']):.1f} Mray/s "
        f"(host clock; {lc.packet} B2 launches in 5 frames)")
    cornell = [pt_tutorial.build_cornell_scene(d) for d in (dev, cpu)]
    fold(pt_check("pt-cornell", cornell, app.camera))
    for size in PT_SIZES:
        r = pt_measure("pt-cornell", cornell[0], app.camera, size, PT_SPP)
        fold(r["errs"])
        if r["b1"] != 0:
            raise AssertionError("pt-cornell launched B1")

    log("[26b] pt-glass: glass_sphere.xml through load_xml (B2)")
    xs = load_xml(PT_GLASS_XML)
    glass = [pt_tutorial.build_xml_scene(xs, d) for d in (dev, cpu)]
    if int((glass[0]["materials"].type == MAT_DIELECTRIC_SOLID).sum()) != 1:
        raise AssertionError("pt-glass: no dielectric sphere")
    gcam = Camera(**PT_GLASS_CAMERA)
    fold(pt_check("pt-glass", glass, gcam))
    size = (PT_GLASS_SIZE, PT_GLASS_SIZE)
    r = pt_measure("pt-glass", glass[0], gcam, size, PT_GLASS_SPP)
    fold(r["errs"])
    if r["b1"] != 0:
        raise AssertionError("pt-glass launched B1")
    t0 = time.perf_counter()
    acc = None
    for k in range(PT_GLASS_SEEDS):
        im, _ = pt_tutorial.render_frame(glass[0], gcam, size, PT_GLASS_SPP,
                                         101 + k)
        acc = im if acc is None else acc + im
    img = (acc / PT_GLASS_SEEDS).cpu().numpy()
    glass_s = time.perf_counter() - t0
    ref = read_pfm(os.path.join(GOLDEN_DIR, "ref_glass_64.pfm"))
    bad, nblk, emax, rel = glass_block_gate(img, ref)
    log(f"  pt-glass {PT_GLASS_SIZE}x{PT_GLASS_SIZE}, {PT_GLASS_SEEDS} "
        f"seeds x {PT_GLASS_SPP} spp on the card ({glass_s:.1f} s): {bad} of "
        f"{nblk} 16x16 blocks out of tolerance against ref_glass_64.pfm "
        f"(budget under 10 %), max block error {emax:.4f}, global mean "
        f"{rel:.2%} off (budget 5 %)")

    log("[26c] pt-glass-main: the sphere as main's 998,284 triangles (B1, B2)")
    big = []
    sphere = triangle_sphere(*PT_MAIN_SPHERE)
    for d in (dev, cpu):
        xs = load_xml(PT_GLASS_XML)
        xs.geometries = [
            (ett.TriangleMesh(*sphere), m)
            if xs.materials[m].get("type") == MAT_DIELECTRIC_SOLID else (g, m)
            for g, m in xs.geometries]
        t0 = time.perf_counter()
        big.append(pt_tutorial.build_xml_scene(xs, d))
        if d is dev:
            torch.cuda.synchronize()
            commit_s = time.perf_counter() - t0
    cs = big[0]["cscene"]
    n_sphere = 2 * PT_MAIN_SPHERE[2] * (PT_MAIN_SPHERE[2] - 1)
    if cs.rowtrace is None or cs.tris.num_prims != n_sphere + 2:
        raise AssertionError("pt-glass-main: no treelet scene")
    log(f"  pt-glass-main: {cs.tris.num_prims} triangles, commit "
        f"{commit_s:.2f} s ({cs.rowtrace.num_treelets} treelets)")
    fold(pt_check("pt-glass-main", big, gcam))
    r = pt_measure("pt-glass-main", big[0], gcam, PT_SIZES[1], PT_SPP)
    fold(r["errs"])
    if r["b1"] == 0:
        raise AssertionError("pt-glass-main: B1 served no request")
    return errs


def sincos_displacement(verts, normals, amp):
    """tests/test_diff_render.py's displacement."""
    ph = torch.sin(3.0 * verts[:, 0]) * torch.cos(2.0 * verts[:, 1])
    return verts + amp * ph[:, None] * normals


def grad_split_ms(loss_fn, leaves, reps=5):
    """(forward ms, backward ms): CUDA events around `loss_fn(*leaves)` and
    `torch.autograd.grad` of it, the median of `reps` after a warm-up."""
    out = []
    for _ in range(reps + 1):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        loss = loss_fn(*leaves)
        ev[1].record()
        torch.autograd.grad(loss, leaves, allow_unused=True)
        ev[2].record()
        torch.cuda.synchronize()
        out.append((ev[0].elapsed_time(ev[1]), ev[1].elapsed_time(ev[2])))
    return tuple(float(np.median([o[k] for o in out[1:]])) for k in (0, 1))


@contextlib.contextmanager
def deterministic():
    """torch.use_deterministic_algorithms for the block: CUDA's
    `index_add` then sums in a fixed order (as on the CPU), so that two
    evaluations a step apart round alike and their difference is the
    function's, not the atomics' order."""
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)


def central_difference(f, x, h, index=None):
    """(f(x + h e) - f(x - h e)) / 2h for the entry `index` of tensor x
    (all of a 0-d x)."""
    e = torch.zeros_like(x)
    if index is None:
        e.fill_(h)
    else:
        e[index] = h
    with torch.no_grad():
        return (float(f(x + e)) - float(f(x - e))) / (2 * h)


def fd_gate(label, g, fd, rtol):
    if not (math.isfinite(g) and abs(g - fd) <= rtol * abs(fd) and g != 0):
        raise AssertionError(f"{label}: autograd {g:.7g}, central "
                             f"difference {fd:.7g} (rtol {rtol})")
    log(f"  {label}: autograd {g:.7g}, central difference {fd:.7g} "
        f"({abs(g - fd) / abs(fd):.2e} relative; gate {rtol})")


def peak_gb(fn):
    """(fn's result, the peak of allocated device memory while it ran
    and the memory allocated before it, in GB)."""
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    return out, torch.cuda.max_memory_allocated() / 1e9, before / 1e9


def trainer_phase(dev):
    """Phase 27a: DiffSubdivRenderer over bomberman at level 4 on the
    demo camera's 1280x768 frame: the selection's commit and its B1
    launch held against the plain version on a strided slice, render /
    backward / step ms, peak memory, DIFF_STEPS train steps with the loss
    falling, finite differences of the amplitude and one kd channel, and
    the cube of tests/test_diff_render.py on the card (B2) against
    grad_subdiv_cube.npz. Returns the checked launches' errors."""
    (mesh, _mat), = load_obj(DEMO_OBJ, subdiv_mode=True)[0]
    w, h = DEMO_SIZE
    rays = viewer_rays(Camera(**DEMO_CAMERA), w, h, dev.device)
    v = np.asarray(mesh.vertices, np.float32)
    diag = float(np.linalg.norm(v.max(0) - v.min(0)))
    amp = torch.tensor(DIFF_AMP_SHARE * diag, device=dev.device)
    kd = torch.tensor(DIFF_KD, device=dev.device)
    t0 = time.perf_counter()
    r = DiffSubdivRenderer(mesh, rays, level=DIFF_LEVEL,
                           displacement=sincos_displacement, device=dev)
    plan_s = time.perf_counter() - t0
    cage = torch.from_numpy(v).to(dev.device)
    errs = {}
    prof = global_profiler()
    prof.samples.clear()
    t0 = time.perf_counter()
    with checked_launches(errs, 1 << PT_SLICE_LOG2), Launches() as lc:
        gprim, valid = r.refresh_selection(cage, amp)
        torch.cuda.synchronize()
    refresh_s = time.perf_counter() - t0
    lc.expect("refresh_selection", 1, 0)
    n_tris = 2 * r.quads.shape[0]
    log(f"  bomberman at level {DIFF_LEVEL}: {r.quads.shape[0]} quads = "
        f"{n_tris} triangles (plan and stencils {plan_s:.1f} s); "
        f"refresh_selection {refresh_s:.2f} s with the check ("
        + ", ".join(f"{k} {prof.stats(k)['avg']:.2f} s"
                    for k in prof.samples if k.startswith("scene."))
        + f"): {lc.rowtrace2} B1 launch for {rays.tnear.numel()} rays, "
        f"{errs.get('rowtrace2_rays', 0)} of them held against the plain "
        f"version (t at 0 ulp, prim equal); {float(valid.float().mean()):.4f} "
        f"hit; amplitude {float(amp):.5g} (1 % of the box diagonal "
        f"{diag:.4g})")
    if not (0.3 < float(valid.float().mean()) < 1.0):
        raise AssertionError("trainer: the selection hits too little")

    leaves = [x.clone().requires_grad_(True) for x in (cage, amp, kd)]
    fwd_ms, bwd_ms = grad_split_ms(lambda c, a, k: r.loss(c, a, kd=k),
                                   leaves)
    with torch.no_grad():
        target = r.render(cage, 1.5 * amp,
                          kd=torch.tensor((0.6, 0.6, 0.6),
                                          device=dev.device))
    step = make_train_step(r, target, lr=DIFF_LR)
    params = (cage, amp, kd)
    step_ms = time_ms(lambda: step(params))
    (params, loss), peak, before = peak_gb(lambda: step(params))
    losses = [float(loss)]
    for _ in range(DIFF_STEPS - 1):
        params, loss = step(params)
        losses.append(float(loss))
    if not (all(math.isfinite(x) for x in losses) and losses[-1] < losses[0]):
        raise AssertionError(f"trainer: the loss does not fall: {losses}")
    log(f"  render {fwd_ms:.3f} ms, backward {bwd_ms:.3f} ms (CUDA events, "
        f"median of 5), make_train_step's step {step_ms:.3f} ms; peak "
        f"{peak:.2f} GB allocated during a step ({before:.2f} GB before "
        f"it); the loss over {DIFF_STEPS} steps (lr {DIFF_LR}) from "
        f"{losses[0]:.6g} to {losses[-1]:.6g}: "
        + ", ".join(f"{x:.6g}" for x in losses))

    # finite differences on the card: the image summed in float64, the
    # two renders of the amplitude's difference with a fixed summation
    # order (the displacement's normals of near-degenerate triangles turn
    # the atomics' rounding into a 6 % error at this step)
    a0 = amp.clone().requires_grad_(True)
    (ga,) = torch.autograd.grad(r.render(cage, a0).double().sum(), a0)
    with deterministic():
        fd = central_difference(lambda a: r.render(cage, a).double().sum(),
                                amp, DIFF_FD_SHARE * float(amp))
    fd_gate("d sum / d amplitude", float(ga), fd, 2e-2)
    zero = torch.zeros_like(target)

    def kd_loss(k):
        return ((r.render(cage, amp, kd=k).double() - zero) ** 2).mean()

    k0 = kd.clone().requires_grad_(True)
    (gk,) = torch.autograd.grad(kd_loss(k0), k0)
    fd = central_difference(kd_loss, kd, 1e-3, 1)
    fd_gate("d mean((img - 0)^2) / d kd[1]", float(gk[1]), fd, 2e-2)

    # the cube of tests/test_diff_render.py on the card (B2)
    verts = np.array([[x, y, z] for x in (-1, 1) for y in (-1, 1)
                      for z in (-1, 1)], np.float32)
    quads = np.array([[0, 1, 3, 2], [4, 6, 7, 5], [0, 4, 5, 1],
                      [2, 3, 7, 6], [0, 2, 6, 4], [1, 5, 7, 3]])
    cube = ett.SubdivMesh(verts, np.full(6, 4), quads.reshape(-1))
    rng = np.random.default_rng(0xD1FF)
    org = np.zeros((512, 3), np.float32)
    org[:, 2] = -4.0
    org[:, 0] = rng.uniform(-1.5, 1.5, 512)
    org[:, 1] = rng.uniform(-1.5, 1.5, 512)
    d = np.zeros((512, 3), np.float32)
    d[:, 2] = 1.0
    rc = DiffSubdivRenderer(cube, ett.make_rays(org, d, device=dev.device),
                            level=3, displacement=sincos_displacement,
                            device=dev)
    with checked_launches(errs), Launches() as lc:
        rc.refresh_selection(verts, torch.tensor(0.08, device=dev.device))
    lc.expect("the cube's selection", 0, 1)
    leaves = [torch.from_numpy(verts).to(dev.device).requires_grad_(True),
              torch.tensor(0.08, device=dev.device, requires_grad=True),
              torch.tensor(DIFF_KD, device=dev.device, requires_grad=True)]
    grads = torch.autograd.grad(rc.loss(*leaves[:2], kd=leaves[2]), leaves)
    ref = np.load(os.path.join(GOLDEN_DIR, "grad_subdiv_cube.npz"))
    worst = 0.0
    for g, key, atol in zip(grads, ("cage", "amp", "kd"), (1e-5, 0, 0)):
        g = g.cpu().numpy()
        if not np.allclose(g, ref[key], rtol=1e-4, atol=atol):
            raise AssertionError(f"the cube's {key} gradient on the card "
                                 "is off grad_subdiv_cube.npz")
        worst = max(worst, float(np.max(np.abs(g - ref[key])
                                        / np.maximum(np.abs(ref[key]),
                                                     1e-30))))
    log(f"  the cube of tests/test_diff_render.py on the card (1 B2 launch, "
        "equal to its plain version): cage, amplitude and kd gradients "
        "within rtol 1e-4 (cage atol 1e-5) of grad_subdiv_cube.npz")
    return {"rowtrace2": errs.get("rowtrace2", 0.0),
            "packet": errs.get("packet", 0.0)}


def material_phase(cs, rays):
    """Phase 27b: freeze_hits on main (one B1 closest and one B1 occluded
    request) and material_grads for the five materials: ms on the card,
    the gradients against the CPU's on the same frozen dict."""
    dev = rays.org.device
    with Launches() as lc:
        frozen = freeze_hits(cs, rays, DIFF_LIGHT_P)
        torch.cuda.synchronize()
    lc.expect("freeze_hits", 2, 0)
    freeze_ms = time_ms(lambda: freeze_hits(cs, rays, DIFF_LIGHT_P))
    cpu = {k: v.cpu() for k, v in frozen.items()}
    cpu64 = {k: v.double() if v.is_floating_point() else v
             for k, v in cpu.items()}
    gm = torch.zeros(1, dtype=torch.int32, device=dev)
    parts, bad = [], []
    for mat in DIFF_MATERIALS:
        mt = make_material_table([mat], device=dev)
        ms = time_ms(lambda: material_grads(mt, frozen, gm, DIFF_LIGHT))
        g = {f: v.cpu() for f, v in
             material_grads(mt, frozen, gm, DIFF_LIGHT).items()}
        mtc = make_material_table([mat], device="cpu")
        gc = material_grads(mtc, cpu, gm.cpu(), DIFF_LIGHT)
        # the float64 evaluation on the CPU: how far float32's rounding
        # (sums of up to 2^21 lanes into one table entry) puts each side
        g64 = material_grads(mtc._replace(**{
            f: getattr(mtc, f).double() for f in FLOAT_FIELDS}), cpu64,
            gm.cpu(), DIFF_LIGHT)
        scale = max(float(v.abs().max()) for v in gc.values())

        def rel(a, b):
            return max(float((a[f].double() - b[f].double()).abs().max())
                       for f in FLOAT_FIELDS) / scale

        def field_rel(a, b):
            return max(float((a[f].double() - b[f].double()).abs().max())
                       / max(float(b[f].abs().max()), 1e-30)
                       for f in FLOAT_FIELDS)

        errs = (rel(g, gc), rel(g, g64), rel(gc, g64), field_rel(g, gc),
                field_rel(g, g64), field_rel(gc, g64))
        bad.append(not (all(torch.isfinite(v).all() for v in g.values())
                        and scale > 0 and errs[3] <= 1e-5))
        parts.append(f"type {mat['type']} {ms:.3f} ms (" + " / ".join(
            f"{e:.1e}" for e in errs) + ")")
    log(f"  {int(frozen['valid'].sum())} of {rays.tnear.numel()} rays hit, "
        f"{int(frozen['lit'].sum())} lit; freeze_hits {freeze_ms:.3f} ms "
        f"(1 B1 closest + 1 B1 occluded request); material_grads (CUDA "
        "events, median of 5; in brackets the largest difference of the "
        "card's gradients from the CPU's on the same frozen dict, of the "
        "card's and of the CPU's from the CPU's float64 evaluation, "
        "relative to the largest entry of the material's gradients; then "
        "the same three relative to each field's largest entry, gate 1e-5 "
        "on the first of these): " + ", ".join(parts))
    if any(bad):
        raise AssertionError("material_grads: the card is off the CPU")


def _indirect_scene(dev):
    """tests/test_diff_materials.py's `_indirect_scene` on `dev`."""
    scene = ett.Scene(dev)
    mats, geom_mat = [], []
    for p0, du, dv, kd in (((-3, 0, -3), (6, 0, 0), (0, 0, 6),
                            (0.7, 0.7, 0.7)),
                           ((2, 0, -3), (0, 3, 0), (0, 0, 6),
                            (0.2, 0.8, 0.3)),
                           ((-0.4, 1.0, -0.4), (0.8, 0, 0), (0, 0, 0.8),
                            (0.05, 0.05, 0.05))):
        p0 = np.asarray(p0, np.float32)
        v = np.stack([p0, p0 + du, p0 + np.asarray(du) + np.asarray(dv),
                      p0 + dv]).astype(np.float32)
        gid = scene.attach(ett.QuadMesh(v, np.asarray([[0, 1, 2, 3]])))
        geom_mat += [0] * (gid + 1 - len(geom_mat))
        geom_mat[gid] = len(mats)
        mats.append({"type": MAT_MATTE, "kd": kd})
    lt = make_light_table([{"type": LIGHT_POINT, "pos": (0.0, 2.0, 0.0),
                            "radiance": (30.0, 30.0, 30.0)}],
                          device=dev.device)
    return (scene.commit(), make_material_table(mats, device=dev.device),
            lt, torch.tensor(geom_mat, dtype=torch.int32, device=dev.device))


def path_grad_phase(dev):
    """Phase 27c: path_grads on pt-cornell at PG_SIZE, PG_SPP spp, 8
    bounces, every FLOAT_FIELD: its image equal to render_pt's bit for
    bit, forward / backward ms, peak memory, B2 launches; the card's
    gradients against the CPU's at 16x16, 1 spp with the same uniforms;
    a finite difference on the card through tests/test_diff_materials.py's
    indirect scene."""
    cpu = ett.Device("ignore_config_files=1", device="cpu")
    states = [pt_tutorial.build_cornell_scene(d) for d in (dev, cpu)]
    cam = pt_tutorial.make_app().camera
    w, h = PG_SIZE
    st = states[0]
    view = cam.ispc_camera(w, h, device=dev.device)
    args = (st["cscene"], st["materials"], st["lights"], st["geom_mat"],
            *view)
    kw = dict(width=w, height=h, spp=PG_SPP,
              max_path=pt_tutorial.MAX_PATH_LENGTH, seed=PT_SEED)
    with Launches() as lc:
        (img, g), peak, before = peak_gb(lambda: path_grads(*args, **kw))
    ref = pt_tutorial.render_pt(*args, PT_SEED, width=w, height=h,
                                spp=PG_SPP)
    if not torch.equal(img, ref):
        raise AssertionError("path_grads: its image is not render_pt's")
    want = 2 * PG_SPP * pt_tutorial.MAX_PATH_LENGTH
    lc.expect("path_grads", 0, want)
    if not all(torch.isfinite(x).all() for x in g.values()):
        raise AssertionError("path_grads: a gradient is not finite")
    mt = st["materials"]

    def forward(*fl):
        return pt_tutorial.render_pt(
            st["cscene"], mt._replace(**dict(zip(FLOAT_FIELDS, fl))),
            st["lights"], st["geom_mat"], *view, PT_SEED, width=w,
            height=h, spp=PG_SPP).sum()

    leaves = [getattr(mt, f).clone().requires_grad_(True)
              for f in FLOAT_FIELDS]
    fwd_ms, bwd_ms = grad_split_ms(forward, leaves, PG_REPS)
    saved = peak - before
    log(f"  pt-cornell {w}x{h}, {PG_SPP} spp, {pt_tutorial.MAX_PATH_LENGTH} "
        f"bounces, all {len(FLOAT_FIELDS)} float fields: the image equal to "
        f"render_pt's with the same sampler bit for bit; forward "
        f"{fwd_ms:.1f} ms, backward {bwd_ms:.1f} ms (CUDA events, median of "
        f"{PG_REPS}); peak {peak:.2f} GB allocated ({before:.2f} GB "
        f"before it: {saved:.2f} GB for the saved activations); "
        f"{lc.packet} B2 launches (expected {want}); at 1024x1024 the saved "
        f"activations would take ~16 x {saved:.2f} = {16 * saved:.1f} GB "
        f"({'more' if 16 * saved + before > 80 else 'less'} than the "
        "card's 80 GB with what it already holds)")

    n = PG_CHECK_SIZE * PG_CHECK_SIZE
    res = []
    for s in states:
        v = cam.ispc_camera(PG_CHECK_SIZE, PG_CHECK_SIZE,
                            device=s["cscene"].device)
        res.append(path_grads(
            s["cscene"], s["materials"], s["lights"], s["geom_mat"], *v,
            width=PG_CHECK_SIZE, height=PG_CHECK_SIZE, spp=1,
            max_path=pt_tutorial.MAX_PATH_LENGTH,
            sampler=KeyedSampler(PT_SEED, n, s["cscene"].device)))
    worst = 0.0
    for f in FLOAT_FIELDS:
        a, b = res[0][1][f].cpu(), res[1][1][f]
        scale = float(b.abs().max())
        err = float((a - b).abs().max())
        if err > 1e-4 * scale or (scale == 0.0 and err != 0.0):
            raise AssertionError(f"path_grads {f}: card {err:g} off the "
                                 f"CPU (largest entry {scale:g})")
        worst = max(worst, err / scale if scale else 0.0)
    if float(res[1][1]["kd"].abs().max()) == 0.0:
        raise AssertionError("path_grads: no kd gradient")
    log(f"  card against CPU at {PG_CHECK_SIZE}x{PG_CHECK_SIZE}, 1 spp, the "
        f"same uniforms: every field's gradient within {worst:.2e} of its "
        "largest entry (gate 1e-4)")

    cs, mti, lt, gmi = _indirect_scene(dev)
    cam_p = torch.tensor([0.0, 1.5, 0.9], device=dev.device)
    vz = -cam_p / torch.linalg.norm(cam_p)
    vx = torch.tensor([1e-3, 0.0, 0.0], device=dev.device)
    vy = torch.linalg.cross(vz, vx)
    vy = 1e-3 * vy / torch.linalg.norm(vy)
    ikw = dict(width=1, height=1, spp=16, max_path=3, n_lights=1)
    img, gi = path_grads(cs, mti, lt, gmi, vx, vy, vz, cam_p, seed=3,
                         fields=("kd",), **ikw)
    if not float(img.sum()) > 1e-4:
        raise AssertionError("the indirect scene's pixel is not lit")

    def pixel(kd):
        return pt_tutorial.render_pt(cs, mti._replace(kd=kd), lt, gmi, vx,
                                     vy, vz, cam_p, 3, **ikw).sum()

    fd = central_difference(pixel, mti.kd, 1e-2, (1, 1))
    an = float(gi["kd"][1, 1])
    if not abs(fd - an) < 5e-2 * max(abs(fd), 1e-3):
        raise AssertionError(f"the wall's kd: path_grads {an:g}, central "
                             f"difference {fd:g}")
    log(f"  the indirect scene's bounce-2 pixel on the card: d/d kd_wall "
        f"path_grads {an:.6g}, central difference {fd:.6g} (gate 5e-2)")


def write_obj(path, verts, idx):
    with open(path, "w") as f:
        np.savetxt(f, verts, fmt="v %.9g %.9g %.9g")
        np.savetxt(f, idx + 1, fmt="f %d %d %d")


def dynamic_phase(dev, verts, idx, scene, rays):
    """Phase 28: dynamic_scene (a re-commit every frame) and viewer_anim
    (LOW) frames/s; the morton tree of main's mesh built on the card,
    packed and walked by B2 against its plain version and the SAH
    scene; buildbench. Returns B2's largest error."""
    errs = {}
    cs = scene.committed
    st = ds_tutorial.build_scene(device=dev)
    cam = ds_tutorial.make_app().camera
    size = (DYN_SIZE, DYN_SIZE)
    commits = []
    commit = st["scene"].commit

    def timed_commit():
        t0 = time.perf_counter()
        out = commit()
        torch.cuda.synchronize()
        commits.append(time.perf_counter() - t0)
        return out

    st["scene"].commit = timed_commit
    frames, dts = [], []
    with Launches() as lc:
        for k in range(DYN_FRAMES + 1):
            ctx = (checked_launches(errs, 1 << PT_SLICE_LOG2) if k < 2
                   else contextlib.nullcontext())
            t0 = time.perf_counter()
            with ctx:
                img, _ = ds_tutorial.render_frame(st, cam, size)
                torch.cuda.synchronize()
            dts.append(time.perf_counter() - t0)
            frames.append(img.cpu().numpy())
    lc.expect("dynamic_scene", 0, DYN_FRAMES + 1)
    moved = sum(float(np.abs(b - a).max()) > 0.01
                for a, b in zip(frames, frames[1:]))
    if not (all(np.isfinite(f).all() and f.shape == (*size, 3)
                for f in frames) and frames[0].max() > 0.2
            and moved == DYN_FRAMES):
        raise AssertionError(f"dynamic_scene: {moved} of {DYN_FRAMES} "
                             "frames moved, or a frame is empty")
    ms = 1e3 * float(np.median(dts[2:]))
    commit_ms = 1e3 * float(np.median(commits[1:]))
    log(f"  dynamic_scene {DYN_SIZE}x{DYN_SIZE}: "
        f"{st['cscene'].tris.num_prims} triangles, {1e3 / ms:.1f} frames/s "
        f"({ms:.2f} ms a frame, the median of frames 2-{DYN_FRAMES}, host "
        f"clock), the re-commit {commit_ms:.2f} ms of it ("
        f"{commit_ms / ms:.0%}); {moved} of {DYN_FRAMES} consecutive frame "
        f"pairs differ; 1 B2 launch a frame, those of frames 0-1 equal to "
        "the plain version")

    with tempfile.TemporaryDirectory() as tmp:
        obj = os.path.join(tmp, "sphere.obj")
        write_obj(obj, *triangle_sphere((0.0, 0.0, 0.0), 2.0, SMALL_RES))
        out = io.StringIO()
        with Launches() as lc, contextlib.redirect_stdout(out):
            rc = va_tutorial.make_app().run(
                ["-i", obj, "--size", str(DYN_SIZE), str(DYN_SIZE),
                 "--benchmark", "1", "3", "-rtcore", "ignore_config_files=1"])
            torch.cuda.synchronize()
    keys = dict(line.split() for line in out.getvalue().splitlines()
                if line.startswith("BENCHMARK_RENDER_"))
    if rc != 0 or "BENCHMARK_RENDER_AVG" not in keys:
        raise AssertionError(f"viewer_anim returned {rc}")
    lc.expect("viewer_anim: 5 frames", 0, 5)
    log(f"  viewer_anim on (a)'s sphere as an OBJ (99,012 triangles, "
        f"re-committed at BuildQuality.LOW every frame, 2 keyframes) "
        f"{DYN_SIZE}x{DYN_SIZE} through make_app().run --benchmark 1 3: "
        f"{float(keys['BENCHMARK_RENDER_AVG']):.2f} frames/s (host clock; "
        f"{lc.packet} B2 launches in 5 frames)")

    v0, v1, v2 = verts[idx[:, 0]], verts[idx[:, 1]], verts[idx[:, 2]]
    lo, hi = prim_bounds_np(v0, v1, v2)
    tlo = torch.from_numpy(lo).to(dev.device)
    thi = torch.from_numpy(hi).to(dev.device)
    morton_ms = time_ms(lambda: build_morton(tlo, thi))
    tree = build_morton(tlo, thi)
    t0 = time.perf_counter()
    host = BVHArraysNP(*(a.cpu().numpy() for a in tree))
    ps = pk.compact_scene(pk.pack_scene(host, (v0, v1, v2), "cpu"),
                          dev.device)
    pack_s = time.perf_counter() - t0
    flat = flat_rays(rays)
    with Launches() as lc:
        t_m, p_m = pk.intersect_packet_kernel_raw(ps, flat)
        t_s, p_s = pk.intersect_packet_kernel_raw(cs.packet, flat)
        torch.cuda.synchronize()
    lc.expect("morton and SAH trees through B2", 0, 2)
    n = flat.tnear.numel()
    sel = torch.arange(0, n, -(-n // (1 << PT_SLICE_LOG2)), device=dev.device)
    sub = Rays(flat.org[sel], flat.dir[sel], flat.tnear[sel], flat.tfar[sel])
    t_p, p_p = pk.packet_plain(ps, sub)
    ulps = ulp_distance(t_m[sel], t_p.reshape(-1))
    if ulps or not torch.equal(p_m[sel], pk._to_orig(ps, p_p).reshape(-1)):
        raise AssertionError(f"morton tree: B2 differs from its plain "
                             f"version ({ulps} ulp)")
    vm, vs = p_m >= 0, p_s >= 0
    rel = float(((t_m[vs] - t_s[vs]).abs() / t_s[vs].abs()).max())
    if not (torch.equal(vm, vs) and rel <= 1e-5):
        raise AssertionError(f"morton tree: {int((vm != vs).sum())} rays "
                             f"hit otherwise than on the SAH tree, t "
                             f"{rel:g} off")
    with np.errstate(over="ignore", invalid="ignore"):
        costs = sah_cost(host), sah_cost(scene._bvh_host)
    b2_morton = time_ms(lambda: pk.intersect_packet_kernel_raw(ps, flat))
    b2_sah = time_ms(lambda: pk.intersect_packet_kernel_raw(cs.packet, flat))
    log(f"  morton tree of main's {lo.shape[0]} prims built on the card in "
        f"{morton_ms:.3f} ms (CUDA events, median of 5): {ps.num_nodes} "
        f"nodes in {ps.depth} levels, SAH cost {costs[0]:.4g} (the SAH "
        f"tree's {costs[1]:.4g}); packed and compacted on "
        f"the host in {pack_s:.2f} s; B2 over it on main's 2^{LOG2_RAYS} "
        f"rays {b2_morton:.3f} ms, over the SAH tree {b2_sah:.3f} ms (CUDA "
        f"events, median of 5); {int(vm.sum())} hits, valid equal to the "
        f"SAH tree's, t within {rel:.2e} relative; the first launch equal "
        f"to the plain version on {sub.tnear.numel()} strided rays (t at 0 "
        "ulp, prim equal)")

    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        bench = buildbench.run(BUILD_PRIMS)
    print(out.getvalue(), end="")
    if not all(math.isfinite(v) and v > 0 for v in bench.values()):
        raise AssertionError(f"buildbench: {bench}")
    log(f"  buildbench.run({BUILD_PRIMS}) {time.perf_counter() - t0:.1f} s "
        "(the BENCHMARK_BUILD_* lines above; Mprims/s, host clock, the "
        "device builds synchronized)")
    return errs.get("packet", 0.0)


def scale_loss(cs):
    """tests/test_dist.py's loss on a committed scene: its triangles
    scaled by `scale` about the origin, the squared distance of every
    hit from `target` (intersect_diff: the scene's own kernel selects,
    autograd re-evaluates)."""
    def loss_fn(scale, rays, target):
        tris = cs.tris._replace(v0=cs.tris.v0 * scale, v1=cs.tris.v1 * scale,
                                v2=cs.tris.v2 * scale)
        h = intersect_diff(cs._replace(tris=tris), rays)
        return torch.where(h.valid, (h.t - target) ** 2,
                           torch.zeros_like(h.t)).sum()
    return loss_fn


def step_off(run, loss, scale):
    """(relative error of a train run's first loss against `loss`, of
    its scale after the first step against `scale`)."""
    return (abs(run["losses"][0] - loss) / abs(loss),
            abs(run["scales"][0] - scale) / abs(scale))


def ring_times(fn, reps):
    """(total ms, B2 ms) of `fn`, a ring request, each the median of
    `reps` after a warm-up (CUDA events on this rank's stream: the total
    from before the first hop to after the last, B2 the sum of its
    launches; the rest is the hops' staging and waiting)."""
    raw = pk.intersect_packet_kernel_raw
    spans = []

    def timed(*a, **k):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        out = raw(*a, **k)
        ev[1].record()
        spans.append(ev)
        return out

    fn()
    torch.cuda.synchronize()
    totals, b2s = [], []
    pk.intersect_packet_kernel_raw = timed
    try:
        for _ in range(reps):
            spans.clear()
            ev0 = torch.cuda.Event(enable_timing=True)
            ev1 = torch.cuda.Event(enable_timing=True)
            ev0.record()
            fn()
            ev1.record()
            torch.cuda.synchronize()
            totals.append(ev0.elapsed_time(ev1))
            b2s.append(sum(a.elapsed_time(b) for a, b in spans))
    finally:
        pk.intersect_packet_kernel_raw = raw
    return float(np.median(totals)), float(np.median(b2s))


def dist_rays(cfg, device):
    """Main's rays (phase 4's, from RAY_SEED) and the train step's: the
    same directions from the sphere's center."""
    n = 1 << cfg["log2"]
    rng = np.random.default_rng(RAY_SEED)
    d = unit_dirs(rng, n)
    org = rng.uniform(-3.0, 3.0, (n, 3)).astype(np.float32)
    return (ett.make_rays(org, d, device=device),
            ett.make_rays(np.zeros_like(org), d, device=device))


def dist_rank(rank, world, tmp, cfg):
    """One rank of phase 29 (b), spawned by `run_world` under gloo: all
    ranks compute on cfg["device"] (cuda:0). Main's committed scene comes
    from phase 4 through torch.save, the ring's shards through an npz.
    Returns its launches, errors against the plain versions, the train
    step's values and times, and on rank 0 the gathered hits."""
    dev = torch.device(cfg["device"])
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    cs = torch.load(os.path.join(tmp, "main.pt"), map_location=dev,
                    weights_only=False)
    with np.load(os.path.join(tmp, "shards.npz")) as f:
        ps = PrimShardedScene(**{k: f[k] for k in PrimShardedScene._fields})
    rays, train = dist_rays(cfg, dev)
    mesh = make_mesh()
    ring = make_mesh(world, "sp")
    shard = place_prim_sharded(ps, ring, "sp", device=dev)
    block, r = shard_rays(rays, mesh)
    rblock, _ = shard_rays(rays, ring, "sp")
    tblock, _ = shard_rays(train, mesh)
    target = torch.full_like(tblock.tnear, cfg["target"])
    loss_fn = scale_loss(cs)
    step = make_sharded_train_step(mesh, loss_fn)
    errs, errs_b2 = {}, {}
    torch.cuda.synchronize()
    rt2.launches = pk.launches = 0
    with checked_launches(errs, 1 << cfg["slice"]):
        dp = gather_hits(sharded_intersect(cs, block, mesh), mesh)
    with checked_launches(errs_b2, 1 << cfg["slice"], first=1):
        hr = gather_hits(prim_sharded_intersect(shard, rblock, ring, "sp"),
                         ring, "sp")
    one = torch.tensor(1.0, device=dev, requires_grad=True)
    ll = loss_fn(one, tblock, target)
    l1, g1 = all_reduce_grads(
        [ll.detach(), torch.autograd.grad(ll, one)[0]], mesh)
    scale, losses, scales = torch.tensor(1.0, device=dev), [], []
    for _ in range(cfg["steps"]):
        loss, scale = step(scale, tblock, target, cfg["lr"])
        losses.append(loss.item())
        scales.append(scale.item())
    torch.cuda.synchronize()
    out = {"launches": {"rowtrace2": rt2.launches, "packet": pk.launches},
           "errs": {"rowtrace2": errs.get("rowtrace2", 0.0),
                    "rowtrace2_rays": errs.get("rowtrace2_rays", 0),
                    "packet": errs_b2.get("packet", 0.0),
                    "packet_checked": errs_b2.get("packet_checked", 0),
                    "packet_rays": errs_b2.get("packet_rays", 0)},
           "loss1": l1.item(), "grad1": g1.item(), "losses": losses,
           "scales": scales, "shard_prims": shard.tris.num_prims,
           "shard_nodes": shard.packet.num_nodes,
           "shard_depth": shard.packet.depth}
    out["ring_ms"], out["ring_b2_ms"] = ring_times(
        lambda: prim_sharded_intersect(shard, rblock, ring, "sp"),
        cfg["reps"])
    out["dp_ms"] = time_ms(lambda: sharded_intersect(cs, block, mesh),
                           cfg["reps"])
    out["step_ms"] = time_ms(lambda: step(torch.tensor(1.0, device=dev),
                                          tblock, target, cfg["lr"]),
                             cfg["reps"])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out["scalebench"] = scalebench.run(cfg["scale_rays"], device=dev)
    if rank == 0:
        out["dp"] = {k: v[:r].cpu().numpy() for k, v in dp._asdict().items()}
        out["ring"] = {k: v[:r].cpu().numpy()
                       for k, v in hr._asdict().items()}
    return out


def walks_phase(dev, cs, rays, ref, errs_b2):
    """The packet walks' public entries (traverse/packet.py) on main's
    SAH tree, with a prim mask and a ray mask: `intersect_chunked` and
    `occluded_chunked` each pack the tree on the host and launch B2 once,
    held against its plain version on a strided slice. A hit lies on a
    triangle whose mask meets the ray's; rays whose mask holds every bit
    hit as B1 does (`ref`); the any hit equals the closest hit's valid.
    Adds the largest B2 error to `errs_b2`."""
    n = rays.tnear.numel()
    pmask = torch.tensor(1 + np.arange(cs.tris.num_prims) % 2,
                         dtype=torch.int32, device=dev)
    rmask = torch.tensor(np.random.default_rng(RAY_SEED + 1).integers(0, 4, n),
                         dtype=torch.int32, device=dev)
    errs = {}
    t0 = time.perf_counter()
    with Launches() as lc, checked_launches(errs, 1 << DIST_SLICE_LOG2):
        hw = intersect_chunked(cs.bvh, cs.tris, rays, prim_mask=pmask,
                               ray_mask=rmask)
        ow = occluded_chunked(cs.bvh, cs.tris, rays, prim_mask=pmask,
                              ray_mask=rmask)
        torch.cuda.synchronize()
    walk_s = time.perf_counter() - t0
    lc.expect("intersect_chunked and occluded_chunked", 0, 2)
    if errs.get("packet_checked") != 2:
        raise AssertionError(f"packet walks: {errs.get('packet_checked')} "
                             "of 2 B2 launches checked")
    v = hw.valid
    met = (pmask[hw.gprim.clamp(min=0)] & rmask) != 0
    full = rmask == 3
    rel = float(((hw.t - ref.t).abs() / ref.t.abs())[full & ref.valid].max())
    if not (torch.equal(ow, v) and bool(met[v].all())
            and not bool(v[rmask == 0].any())
            and torch.equal(v[full], ref.valid[full]) and rel <= 1e-5):
        raise AssertionError(
            f"packet walks: any hit {int((ow != v).sum())} rays off the "
            f"closest hit's valid, {int((~met[v]).sum())} hits on a masked "
            f"triangle, {int(v[rmask == 0].sum())} hits of mask-0 rays, "
            f"{int((v[full] != ref.valid[full]).sum())} unmasked rays off "
            f"B1's valid, t {rel:g} off")
    errs_b2["packet"] = max(errs_b2.get("packet", 0.0), errs["packet"])
    log(f"  intersect_chunked and occluded_chunked on main's SAH tree, "
        f"{n} rays with a ray mask and a prim mask: {int(v.sum())} hits, "
        f"every one on a triangle whose mask meets the ray's; rays of every "
        f"mask bit valid-equal to B1, t within {rel:.3g}; any hit equal to "
        f"the closest hit's valid; both B2 launches equal to the plain "
        f"version on {errs['packet_rays']} strided rays; {walk_s:.2f} s "
        f"with the two host packings")


def dist_phase(dev, verts, idx, scene, rays):
    """Phase 29: the distribution layer. (a) DIST_BACKEND at world 1 in
    this process: `sharded_intersect` (B1) against the phase's own
    `scene.intersect`, 5 train steps against unsharded autograd, the
    ring with one shard (B2 over main's SAH tree) against B1; (b) gloo at
    world DIST_WORLD, spawned ranks on one card: the ring over DIST_WORLD
    morton shards, DP and the train step against (a), scalebench; (c)
    `benchmarks.run()`. Returns the largest error of B1 and B2 and the
    launches the ranks made."""
    cs = scene.committed
    n = rays.tnear.numel()
    radius = float(np.linalg.norm(verts, axis=1).max())
    cfg = {"log2": int(math.log2(n)), "slice": DIST_SLICE_LOG2,
           "device": str(dev), "lr": 1.0 / (16 * n), "steps": DIST_STEPS,
           "reps": DIST_REPS, "target": DIST_TARGET * radius,
           "scale_rays": DIST_SCALE_RAYS}
    errs, errs_b2 = {}, {}
    _, train = dist_rays(cfg, dev)
    v0, v1, v2 = (np.ascontiguousarray(verts[idx[:, k]]) for k in range(3))
    T = len(idx)
    ids = (np.zeros(T, np.int32), np.arange(T, dtype=np.int32),
           np.zeros(T, np.int32))
    log(f"[29a] {DIST_BACKEND} at world 1: sharded_intersect, "
        f"{DIST_STEPS} train steps, the ring with one shard")
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group(
            DIST_BACKEND, store=dist.FileStore(os.path.join(tmp, "store"), 1),
            rank=0, world_size=1)
        try:
            ref = scene.intersect(rays)
            mesh = make_mesh()
            with Launches() as lc, checked_launches(errs,
                                                    1 << DIST_SLICE_LOG2):
                block, r = shard_rays(rays, mesh)
                h = gather_hits(sharded_intersect(cs, block, mesh), mesh)
                torch.cuda.synchronize()
            lc.expect("sharded_intersect at world 1", 1, 0)
            bad = [f for f, a, b in zip(h._fields, h, ref)
                   if not torch.equal(a[:r], b)]
            if bad:
                raise AssertionError(f"sharded_intersect: {bad} differ from "
                                     "scene.intersect")
            dp_ms = time_ms(lambda: sharded_intersect(cs, block, mesh),
                            DIST_REPS)
            log(f"  sharded_intersect on {n} rays: every Hits field equal to "
                f"scene.intersect's (B1, checked against its plain version "
                f"on {errs.get('rowtrace2_rays', 0)} strided rays at 0 "
                f"ulp); {dp_ms:.3f} ms, {n / dp_ms / 1e3:.1f} Mray/s")

            loss_fn = scale_loss(cs)
            step = make_sharded_train_step(mesh, loss_fn)
            tblock, _ = shard_rays(train, mesh)
            target = torch.full_like(tblock.tnear, cfg["target"])
            one = torch.tensor(1.0, device=dev, requires_grad=True)
            lf = loss_fn(one, train, torch.full_like(train.tnear,
                                                     cfg["target"]))
            gf = torch.autograd.grad(lf, one)[0]
            losses, scales, step_ms = [], [], []
            with Launches() as lc:
                one = torch.tensor(1.0, device=dev, requires_grad=True)
                ll = loss_fn(one, tblock, target)
                l1, g1 = all_reduce_grads(
                    [ll.detach(), torch.autograd.grad(ll, one)[0]], mesh)
                scale = torch.tensor(1.0, device=dev)
                for _ in range(DIST_STEPS):
                    ev = [torch.cuda.Event(enable_timing=True)
                          for _ in range(2)]
                    ev[0].record()
                    loss, scale = step(scale, tblock, target, cfg["lr"])
                    ev[1].record()
                    torch.cuda.synchronize()
                    losses.append(loss.item())
                    scales.append(scale.item())
                    step_ms.append(ev[0].elapsed_time(ev[1]))
            lc.expect("train steps at world 1", DIST_STEPS + 1, 0)
            rel_l = abs(l1.item() - lf.item()) / abs(lf.item())
            rel_g = abs(g1.item() - gf.item()) / abs(gf.item())
            # the step's own first loss and update against autograd's
            first = 1.0 - cfg["lr"] * gf.item()
            rel_sl, rel_su = step_off({"losses": losses, "scales": scales},
                                      lf.item(), first)
            if not (rel_l <= 1e-5 and rel_g <= 1e-5 and rel_sl <= 1e-5
                    and rel_su <= 1e-5 and losses[-1] < 0.5 * losses[0]
                    and DIST_TARGET < scales[-1] < 1.0):
                raise AssertionError(
                    f"train step: losses {losses}, scales {scales}, loss "
                    f"{rel_l:g} and gradient {rel_g:g} off; the step's first "
                    f"loss {rel_sl:g} and update {rel_su:g} off")
            log(f"  train step (lr {cfg['lr']:.4g}): loss {losses[0]:.6g} -> "
                f"{losses[-1]:.6g} in {DIST_STEPS} steps, scale "
                f"{scales[-1]:.6f} (target {DIST_TARGET}); at scale 1 the "
                f"all-reduced loss {l1.item():.8g} and gradient "
                f"{g1.item():.8g} are {rel_l:g} and {rel_g:g} relative off "
                f"unsharded autograd's, the step's own first loss and scale "
                f"{rel_sl:g} and {rel_su:g} off autograd's loss and 1 - lr "
                f"g; step {np.median(step_ms):.3f} ms (median of "
                f"{DIST_STEPS}, CUDA events)")

            t0 = time.perf_counter()
            ps1 = build_prim_sharded(v0, v1, v2, *ids, 1)
            build_s = time.perf_counter() - t0
            ring = make_mesh(1, "sp")
            t0 = time.perf_counter()
            shard = place_prim_sharded(ps1, ring, "sp", device=dev)
            place_s = time.perf_counter() - t0
            rblock, _ = shard_rays(rays, ring, "sp")
            with Launches() as lc, checked_launches(errs_b2,
                                                    1 << DIST_SLICE_LOG2):
                ring1 = prim_sharded_intersect(shard, rblock, ring, "sp")
                torch.cuda.synchronize()
            lc.expect("the ring with one shard", 0, 1)
            vr, vb = ring1.valid, ref.valid
            rel = float(((ring1.t - ref.t).abs() / ref.t.abs())[vb].max())
            ties = int((ring1.gprim != ref.gprim)[vb].sum())
            if not (torch.equal(vr, vb) and rel <= 1e-5):
                raise AssertionError(f"ring, one shard: {int((vr != vb).sum())}"
                                     f" valid flags differ from B1's, t "
                                     f"{rel:g} off")
            ring1_ms, ring1_b2 = ring_times(
                lambda: prim_sharded_intersect(shard, rblock, ring, "sp"),
                DIST_REPS)
            log(f"  the ring with one shard: build_prim_sharded {build_s:.2f}"
                f" s, place (pack, compact) {place_s:.2f} s, BVH"
                f"{shard.packet.width} of {shard.packet.num_nodes} nodes in "
                f"{shard.packet.depth} levels; valid equal to B1's, t within "
                f"{rel:.3g} relative, prim different on {ties} of "
                f"{int(vb.sum())} hits (ties); its B2 launch equal to the "
                f"plain version on {errs_b2.get('packet_rays', 0)} strided "
                f"rays (t at 0 ulp, prim equal); {ring1_ms:.3f} ms a request"
                f" ({ring1_b2:.3f} ms of it B2)")
            walks_phase(dev, cs, rays, ref, errs_b2)
        finally:
            dist.destroy_process_group()

    log(f"[29b] gloo at world {DIST_WORLD}, every rank on {dev}: the ring "
        f"over {DIST_WORLD} morton shards, DP, the train step, scalebench")
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        torch.save(cs, os.path.join(tmp, "main.pt"))
        ps = build_prim_sharded(v0, v1, v2, *ids, DIST_WORLD)
        np.savez(os.path.join(tmp, "shards.npz"), **ps._asdict())
        prep_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        res = run_world(dist_rank, DIST_WORLD, tmp, cfg, backend="gloo",
                        workdir=tmp)
        world_s = time.perf_counter() - t0
    for k, rr in enumerate(res):
        Launches.expect(types.SimpleNamespace(**rr["launches"]),
                        f"rank {k}", DIST_STEPS + 2, DIST_WORLD)
        Launches.totals["rowtrace2"] += rr["launches"]["rowtrace2"]
        Launches.totals["packet"] += rr["launches"]["packet"]
        errs["rowtrace2"] = max(errs.get("rowtrace2", 0.0),
                                rr["errs"]["rowtrace2"])
        errs_b2["packet"] = max(errs_b2.get("packet", 0.0),
                                rr["errs"]["packet"])
        if rr["errs"]["packet_checked"] != 1:
            raise AssertionError(f"rank {k}: its first B2 launch was not "
                                 "checked")
    r0 = res[0]
    bad = [f for f in h._fields
           if not np.array_equal(r0["dp"][f], getattr(ref, f).cpu().numpy())]
    if bad:
        raise AssertionError(f"DP at world {DIST_WORLD}: {bad} differ from "
                             "(a)")
    g = r0["ring"]
    ring_valid = g["geom_id"] != -1
    v1_ = ring1.valid.cpu().numpy()
    t_a = ring1.t.cpu().numpy()
    if not (np.array_equal(ring_valid, v1_)
            and g["t"].tobytes() == t_a.tobytes()):
        raise AssertionError(f"the ring over {DIST_WORLD} shards: valid or t "
                             "differ from the ring with one shard")
    ties4 = int((g["gprim"] != ring1.gprim.cpu().numpy())[v1_].sum())
    rel_l = max(abs(rr["loss1"] - lf.item()) / abs(lf.item()) for rr in res)
    rel_g = max(abs(rr["grad1"] - gf.item()) / abs(gf.item()) for rr in res)
    rel_sl, rel_su = (max(x) for x in zip(*(step_off(rr, lf.item(), first)
                                            for rr in res)))
    if not (rel_l <= 1e-5 and rel_g <= 1e-5 and rel_sl <= 1e-5
            and rel_su <= 1e-5
            and all(rr["losses"][-1] < 0.5 * rr["losses"][0] for rr in res)):
        raise AssertionError(f"train step at world {DIST_WORLD}: loss "
                             f"{rel_l:g}, gradient {rel_g:g}, the step's "
                             f"first loss {rel_sl:g} and update {rel_su:g} "
                             "off (a)")
    sb = r0["scalebench"]
    if not (len(sb) == 6 and all(math.isfinite(v) and v > 0
                                 for v in sb.values())):
        raise AssertionError(f"scalebench: {sb}")
    log(f"  ranks spawned and joined in {world_s:.1f} s (main's committed "
        f"scene saved and the {DIST_WORLD} shards built in {prep_s:.1f} s); "
        f"shards of {[rr['shard_prims'] for rr in res]} triangles, "
        f"{[rr['shard_nodes'] for rr in res]} nodes, "
        f"{[rr['shard_depth'] for rr in res]} levels")
    log(f"  DP: every Hits field of the gathered {n} rays equal to (a)'s "
        f"(B1 on {n // DIST_WORLD} rays a rank, checked against its plain "
        f"version on {res[0]['errs']['rowtrace2_rays']} strided rays a rank)")
    log(f"  ring: t bit-equal and valid equal to the ring with one shard, "
        f"prim different on {ties4} hits (ties); each rank's first B2 "
        f"launch equal to the plain version on "
        f"{res[0]['errs']['packet_rays']} strided rays")
    log(f"  train step: at scale 1 the loss and gradient all-reduced over "
        f"gloo are {rel_l:g} and {rel_g:g} relative off (a)'s unsharded "
        f"autograd, every rank's first step's loss and scale {rel_sl:g} and "
        f"{rel_su:g}; rank 0's loss {r0['losses'][0]:.6g} -> "
        f"{r0['losses'][-1]:.6g}")
    log(f"  times on rank 0 (CUDA events, median of {DIST_REPS}; four ranks "
        f"share the card): ring {r0['ring_ms']:.3f} ms a request, B2 "
        f"{r0['ring_b2_ms']:.3f} ms of it, staging and waiting "
        f"{r0['ring_ms'] - r0['ring_b2_ms']:.3f} ms; DP "
        f"{r0['dp_ms']:.3f} ms; step {r0['step_ms']:.3f} ms")
    log("  scalebench (ranks sharing one card: no hardware scaling): "
        + ", ".join(f"{k} {v:.4g}" for k, v in sb.items()))
    log(f"  (a) for comparison: DP {dp_ms:.3f} ms, ring {ring1_ms:.3f} ms "
        f"({ring1_b2:.3f} ms B2), step {np.median(step_ms):.3f} ms")

    log("[29c] benchmarks.run() at its defaults")
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        bench = benchmarks.run()
    print(out.getvalue(), end="")
    if not (len(bench) == 20
            and all(math.isfinite(v) and v > 0 for v in bench.values())):
        raise AssertionError(f"benchmarks: {bench}")
    log(f"  benchmarks.run() {time.perf_counter() - t0:.1f} s (the "
        "BENCHMARK_* lines above; host clock around synchronized requests)")
    return {"rowtrace2": errs.get("rowtrace2", 0.0),
            "packet": errs_b2.get("packet", 0.0)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true",
                    help="stop after the kernel-vs-plain phases on small "
                         "scenes (prints no result line)")
    args = ap.parse_args()
    # the host pool (opened after phase 4) is terminated however run ends
    with contextlib.ExitStack() as stack:
        return run(args, stack)


def run(args, stack) -> int:
    t_start = time.perf_counter()

    # -- 1. device ---------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    log(f"[1] device: torch {torch.__version__}, CUDA {torch.version.cuda}, "
        "card and power limit:")
    log(card)

    # -- 2. build ----------------------------------------------------------
    # a build directory left by another machine is deleted, not trusted
    shutil.rmtree(nvcc.BUILD_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    # packet.cu holds kernels B2 and B3
    report = io.StringIO()
    with contextlib.redirect_stdout(report):
        nvcc.build_libraries([rt2.KERNEL_NAME, pk.KERNEL_NAME, ck.KERNEL_NAME,
                              mk.KERNEL_NAME], verbose=True)
    print(report.getvalue())
    nvcc_s = time.perf_counter() - t0
    for row in ptxas_summary(report.getvalue(),
                             ["packet_kernel", "cbvh_occluded_kernel"]):
        log("  B2 / B5 entry %s: %d registers, %d B stack frame, %d B "
            "spill stores, %d B spill loads" % row)
    t0 = time.perf_counter()
    if not sah_native.native_available():
        raise AssertionError("the native SAH builder did not build")
    gxx_s = time.perf_counter() - t0
    log(f"[2] build: nvcc rowtrace2.cu, packet.cu, cbvh.cu and mb.cu together "
        f"{nvcc_s:.1f} s, "
        f"g++ sah_builder.cpp {gxx_s:.1f} s")

    # -- 3. kernels vs plain versions, small scenes --------------------------
    log("[3] rowtrace2 kernel vs plain version on small scenes")
    dev = ett.Device("ignore_config_files=1")
    small_err = small_scene_checks(dev.device)
    log("[3b] packet kernel vs plain version on small scenes")
    pk_small_err = packet_small_scene_checks(dev.device)
    log("[3c] compressed kernels vs plain versions on small scenes")
    cb_small_err, cbo_small_err = cbvh_small_scene_checks(dev.device)
    log("[3d] motion-blur kernel vs plain version on small scenes")
    mb_small_err, mb_small_ulps, mbo_small_err = mb_small_scene_checks(
        dev.device)
    log("[3e] hair kernel B3 vs plain version on small scenes")
    hair_small_err = hair_small_scene_checks(dev.device)
    log("[3f] NaN and Inf lanes through all ten kernel entries vs their "
        "plain versions")
    lane_err = nan_lane_checks(dev.device)
    log("[3g] watertight: rays from inside closed surfaces through B2, B6, "
        "B1, B4 and B5")
    wt_err = watertight_checks(dev.device)
    if args.quick:
        log("--quick: stopping before the full-size phases")
        return 0

    # -- 4. treelet path at full size ----------------------------------------
    log("[4] treelet path: Device -> Scene -> attach -> commit -> queries")
    verts, idx = triangle_sphere((0.0, 0.0, 0.0), 2.0, SCENE_RES)
    scene = ett.Scene(dev)
    scene.attach(ett.TriangleMesh(verts, idx))
    prof = global_profiler()
    prof.samples.clear()
    t0 = time.perf_counter()
    cs = scene.commit()
    torch.cuda.synchronize()
    commit_s = time.perf_counter() - t0
    phases = {k: prof.stats(k)["avg"] for k in prof.samples}
    ts = cs.rowtrace
    if not (sah_native.native_available()
            and "treelets.cut_ranges" in phases):
        raise AssertionError("commit did not use the native SAH builder")
    log(f"  commit {commit_s:.2f} s: " + ", ".join(
        f"{k} {v:.2f} s" for k, v in phases.items()))
    # the JAX package's blocks, mid boxes and per-mid planes of the same
    # treelets: what the card held before the compact form
    blocks_bytes = 4 * (ts.num_treelets * BLOCK_ROWS * 128
                        + ts.num_mids * (6 + 6 * 128))
    log(f"  {cs.tris.num_prims} triangles, {ts.num_treelets} treelets in "
        f"{ts.num_mids} mids of fan {ts.fan}: the compact treelet scene "
        f"{ts.device_bytes / 1e6:.1f} MB on the card (the JAX package's "
        f"blocks {blocks_bytes / 1e6:.1f} MB); the committed scene "
        f"{_scene_bytes(cs) / 1e6:.1f} MB in all; BVH{cs.packet.width} of "
        f"{cs.packet.num_nodes} nodes in {cs.packet.depth} levels, "
        f"{cs.packet.device_bytes / 1e6:.1f} MB packed")
    if ts.device_bytes > 1.15 * blocks_bytes:
        raise AssertionError("the compact treelet scene is larger than "
                             "1.15 times the blocks")
    if cs.tris.num_prims != 998284:
        raise AssertionError(f"{cs.tris.num_prims} triangles, not 998,284")

    n = 1 << LOG2_RAYS
    rng = np.random.default_rng(RAY_SEED)
    d = unit_dirs(rng, n)
    org = rng.uniform(-3.0, 3.0, (n, 3)).astype(np.float32)
    rays = ett.make_rays(org, d, device=dev.device)

    t0 = time.perf_counter()
    with Launches() as lc:
        for _ in range(3):
            hits = scene.intersect(rays)
        occ = scene.occluded(rays)
        torch.cuda.synchronize()
    requests_s = time.perf_counter() - t0
    lc.expect("3 intersect + 1 occluded requests", 4, 0)
    check_hits("treelet path", hits, (n,))
    if occ.shape != (n,):
        raise AssertionError("wrong output shapes")
    valid = hits.valid
    frac = float(valid.float().mean())
    if not 0.15 < frac < 0.8:
        raise AssertionError(f"hit fraction {frac:.3f} is not plausible")
    if not torch.equal(occ, valid):
        raise AssertionError("occluded disagrees with intersect's valid mask")
    log(f"  3 intersect + 1 occluded requests of 2^{LOG2_RAYS} rays in "
        f"{requests_s:.3f} s, {lc.rowtrace2} rowtrace2 launches, "
        f"hit fraction {frac:.4f}, occluded == valid")
    # host work that launches no kernel runs in worker processes beside
    # the card's phases
    pool = stack.enter_context(
        multiprocessing.get_context("spawn").Pool(len(CAGE_MODES)))
    cage_jobs = {m: pool.apply_async(commit_cage, (m,)) for m in CAGE_MODES}
    builder_job = pool.apply_async(run_bvh_builder)
    log(f"  main-c's cage in {' and '.join(CAGE_MODES)} mode: committing on "
        f"the host in a pool of {len(CAGE_MODES)} worker processes (for "
        "phase 12b), then bvh_builder (for phase 25)")

    # -- 5. treelet path: correctness at full size ---------------------------
    log("[5] treelet path: correctness at full size")
    nb1 = 1 << B1_PLAIN_LOG2
    b1_rays = Rays(*(a[:nb1].contiguous() for a in rays))
    full_err, plain_ms, _ = compare_kernel_plain(
        ts, b1_rays, False, False,
        f"998,284 triangles, 2^{B1_PLAIN_LOG2} rays of the main path, "
        "closest")
    e_occ, plain_occ_ms, _ = compare_kernel_plain(
        ts, b1_rays, True, False,
        f"998,284 triangles, 2^{B1_PLAIN_LOG2} rays of the main path, "
        "occluded")
    full_err = max(full_err, e_occ)
    del b1_rays
    brute_check("treelet path", cs.tris, rays, valid, hits.t)

    # -- 6. packet path at full size -----------------------------------------
    log("[6] packet path through the entry points")
    # (a) 99,012 triangles as two geometries with masks 1 and 2
    sverts, sidx = triangle_sphere((0.0, 0.0, 0.0), 2.0, SMALL_RES)
    half = len(sidx) // 2
    small = ett.Scene(dev)
    for part, gmask in ((sidx[:half], 1), (sidx[half:], 2)):
        mesh = ett.TriangleMesh(sverts, part)
        mesh.mask = gmask
        small.attach(mesh)
    t0 = time.perf_counter()
    scs = small.commit()
    torch.cuda.synchronize()
    log(f"  (a) commit {time.perf_counter() - t0:.2f} s: "
        f"{scs.tris.num_prims} triangles in 2 geometries, "
        f"BVH{scs.packet.width} of {scs.packet.num_nodes} nodes in "
        f"{scs.packet.depth} levels")
    packet_bytes_line("(a) committed", scs.packet)
    if scs.tris.num_prims != 99012 or scs.rowtrace is not None:
        raise AssertionError("scene (a) is not a 99,012-triangle packet scene")
    with Launches() as lc:
        h_a = small.intersect(rays)
        occ_a = small.occluded(rays)
        torch.cuda.synchronize()
    lc.expect("(a) intersect + occluded", 0, 2)
    check_hits("(a)", h_a, (n,))
    if not torch.equal(occ_a, h_a.valid):
        raise AssertionError("(a): occluded disagrees with the valid mask")
    brute_check("(a) 2^21 incoherent rays", scs.tris, rays, h_a.valid, h_a.t)

    # (c) a filtered and a masked request on (a)
    small.set_intersection_filter(
        lambda org_, d_, t_, u_, v_, ng_, geom_, prim_: prim_ % 2 == 0)
    with Launches() as lc:
        h_f = small.intersect(rays)
        torch.cuda.synchronize()
    small.set_intersection_filter(None)
    if lc.rowtrace2 != 0 or lc.packet < 2:
        raise AssertionError(f"(c) filter: {lc.rowtrace2} rowtrace2 and "
                             f"{lc.packet} packet launches")
    check_hits("(c) filter", h_f, (n,))
    if (h_f.prim_id[h_f.valid] % 2 != 0).any():
        raise AssertionError("(c): a filtered-out primitive was returned")
    log(f"  (c) filter (keep even prim ids): {lc.packet} rounds of the "
        f"packet kernel, {int(h_f.valid.sum())} hits "
        f"({int(h_a.valid.sum())} unfiltered)")
    brute_check("(c) filtered request", scs.tris, rays, h_f.valid, h_f.t,
                keep=scs.tris.prim_id % 2 == 0)
    rmask = torch.from_numpy(np.random.default_rng(7).integers(
        0, 4, n).astype(np.int32)).to(dev.device)
    with Launches() as lc:
        h_m = small.intersect(rays, mask=rmask)
        occ_m = small.occluded(rays, mask=rmask)
        torch.cuda.synchronize()
    lc.expect("(c) masked intersect + occluded", 0, 2)
    check_hits("(c) mask", h_m, (n,))
    if not torch.equal(occ_m, h_m.valid):
        raise AssertionError("(c): masked occluded disagrees with valid")
    if h_m.valid[rmask == 0].any() or not torch.equal(
            h_m.valid[rmask == 3], h_a.valid[rmask == 3]):
        raise AssertionError("(c): ray masks 0 and 3 do not behave")
    brute_check("(c) masked request", scs.tris, rays, h_m.valid, h_m.t,
                ray_mask=rmask, prim_mask=scs.prim_mask)
    # the kernel against its plain version on every ray of (a)
    pk_a_err, pk_plain_ms = compare_packet_plain(
        scs.packet, rays, False, False,
        f"99,012 triangles, all 2^{LOG2_RAYS} rays of (a), closest")
    for label, occl, rm_ in (("any hit", True, None),
                             ("masked, closest", False, rmask),
                             ("masked, any hit", True, rmask)):
        err, _ = compare_packet_plain(
            scs.packet, rays, occl, False,
            f"99,012 triangles, all 2^{LOG2_RAYS} rays of (a), {label}",
            ray_mask=rm_)
        pk_a_err = max(pk_a_err, err)

    # (b) the 998,284-triangle scene: a coherent frame and a small batch
    cam = Camera(from_=(0.5, 1.0, -4.5), to=(0.0, 0.0, 0.0))
    frame = primary_rays(cam, *FRAME, device=dev.device)
    n15 = 1 << 15
    few = Rays(*(a[:n15].contiguous() for a in rays))
    with Launches() as lc:
        h_fr = scene.intersect(frame, coherent=True)
        h_few = scene.intersect(few)
        occ_few = scene.occluded(few)
        torch.cuda.synchronize()
    lc.expect("(b) coherent frame + 2^15 rays", 0, 3)
    check_hits("(b) frame", h_fr, (FRAME[1], FRAME[0]))
    check_hits("(b) 2^15 rays", h_few, (n15,))
    frac_fr = float(h_fr.valid.float().mean())
    if not 0.05 < frac_fr < 0.9:
        raise AssertionError(f"(b): frame hit fraction {frac_fr:.3f}")
    if not torch.equal(occ_few, h_few.valid):
        raise AssertionError("(b): occluded disagrees with the valid mask")
    log(f"  (b) {FRAME[0]}x{FRAME[1]} coherent camera rays: hit fraction "
        f"{frac_fr:.4f}")
    frame_flat = flat_rays(frame)
    main_bytes, main_rows = packet_bytes_line("(b) committed", cs.packet)
    if not main_bytes < 0.5 * main_rows:
        raise AssertionError("the committed packet scene is not below half "
                             "of the rows' bytes")
    brute_check("(b) coherent frame", cs.tris, frame_flat, h_fr.valid, h_fr.t)
    brute_check("(b) 2^15 incoherent rays", cs.tris, few, h_few.valid,
                h_few.t)
    # the packet kernel against the treelet kernel on the same rays
    nvs = 1 << B2_VS_B1_LOG2
    head = Rays(*(a[:nvs].contiguous() for a in rays))
    t_b2, p_b2 = pk.intersect_packet_kernel_raw(cs.packet, head)
    t_b1, v_b1 = hits.t[:nvs], valid[:nvs]
    if not torch.equal(p_b2 >= 0, v_b1):
        raise AssertionError("packet vs rowtrace2: valid masks differ")
    rel = float(((t_b2 - t_b1).abs() / t_b1.abs())[v_b1].max())
    same_prim = float((p_b2 == hits.gprim[:nvs])[v_b1].float().mean())
    if not rel <= 1e-5:
        raise AssertionError(f"packet vs rowtrace2: t differs by {rel:g}")
    log(f"  packet vs rowtrace2 on the first 2^{B2_VS_B1_LOG2} rays of the "
        f"main path: same valid mask, t within {rel:g} relative, prim equal "
        f"on {100 * same_prim:.4f} % of the hits")
    nb2 = 1 << B2_PLAIN_LOG2
    head2 = Rays(*(a[:nb2].contiguous() for a in rays))
    pk_full_err, _ = compare_packet_plain(
        cs.packet, head2, False, False,
        f"998,284 triangles, the first 2^{B2_PLAIN_LOG2} rays of the main "
        "path")
    err, _ = compare_packet_plain(
        cs.packet, frame_flat, False, False,
        f"998,284 triangles, the {FRAME[0]}x{FRAME[1]} coherent frame")
    pk_full_err = max(pk_full_err, err)

    # (d) the triangle_geometry tutorial
    app = tutorial.make_app()
    with Launches() as lc:
        rc = app.run(["--benchmark", "1", "3",
                      "-rtcore", "ignore_config_files=1"])
        torch.cuda.synchronize()
    if rc != 0:
        raise AssertionError(f"the tutorial returned {rc}")
    lc.expect("(d) tutorial: 5 frames of 2 batches", 0, 10)
    state = tutorial.build_scene(dev)
    with Launches() as lc:
        img, _nr = tutorial.render_frame(state, app.camera, (128, 128))
        img = img.cpu().numpy()
    lc.expect("(d) 128x128 frame", 0, 2)
    ref = read_pfm(GOLDEN)
    quant = np.floor(255.0 * np.clip(img, 0.0, 1.0)) / 255.0
    bad = float((np.abs(quant - ref).max(-1) > 1.5 / 255).mean())
    if not (np.isfinite(img).all() and bad <= 0.005):
        raise AssertionError(f"(d): {bad:.4%} of the pixels differ from the "
                             "reference render")
    log(f"  (d) tutorial at {app.default_size[0]}x{app.default_size[1]} "
        f"ran; 128x128 frame: {bad:.4%} of the pixels differ from the "
        "reference renderer's image (budget 0.5 %)")

    # -- 7. the trainer --------------------------------------------------------
    log(f"[7] trainer: {TRAIN_STEPS} steps on the 998,284-triangle scene, "
        f"2^{LOG2_RAYS} rays")
    vparam = torch.tensor(verts, device=dev.device, requires_grad=True)
    tidx = torch.from_numpy(idx).to(dev.device)
    step_ms = []
    with Launches() as lc:
        for step in range(TRAIN_STEPS):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
            ev[0].record()
            with torch.no_grad():
                sel = scene.intersect(rays)
            t_fused = hit_t_grad(vparam, tidx, rays, sel.gprim, sel.valid,
                                 sel.t, tris=cs.tris)
            loss = torch.where(sel.valid, t_fused,
                               torch.zeros_like(t_fused)).sum()
            ev[1].record()
            loss.backward()
            ev[2].record()
            torch.cuda.synchronize()
            step_ms.append((ev[0].elapsed_time(ev[1]),
                            ev[1].elapsed_time(ev[2])))
            if not math.isfinite(loss.item()):
                raise AssertionError(f"step {step}: loss {loss.item()}")
            grad = vparam.grad
            if step == 0:
                loss0, grad0 = loss.item(), grad.clone()
                sel0 = sel
            with torch.no_grad():
                vparam -= TRAIN_LR * grad
            vparam.grad = None
    lc.expect("trainer", TRAIN_STEPS, 0)
    # step 0's gradient against float32 autograd through the
    # re-evaluation. The largest entries belong to grazing hits, where
    # 1/den amplifies float32 rounding in both evaluations (against a
    # float64 re-evaluation either lies 7e-3 of the largest entry away
    # at 2^21 rays), so the two are held to GRAD_TOL, not to 1e-5
    vref = torch.tensor(verts, device=dev.device, requires_grad=True)
    t_re, _u, _v = reeval_hit_verts(vref, tidx, rays, sel0.gprim, sel0.valid)
    torch.where(sel0.valid, t_re, torch.zeros_like(t_re)).sum().backward()
    scale = float(vref.grad.abs().max())
    grad_rel = float((grad0 - vref.grad).abs().max()) / scale
    if not (torch.isfinite(grad0).all() and grad_rel <= GRAD_TOL):
        raise AssertionError(
            f"trainer: the analytic gradient is {grad_rel:g} of the largest "
            "entry away from autograd's")
    touched = torch.zeros(len(verts), dtype=torch.bool, device=dev.device)
    touched[tidx[sel0.gprim[sel0.valid].long()].reshape(-1).long()] = True
    if grad0[~touched].any() or not grad0[touched].any():
        raise AssertionError("trainer: gradient rows of untouched vertices "
                             "are not zero")
    fwd_ms = float(np.median([a for a, _ in step_ms[1:]]))
    bwd_ms = float(np.median([b for _, b in step_ms[1:]]))
    log(f"  loss {loss0:.6g} at step 0, {loss.item():.6g} at step "
        f"{TRAIN_STEPS - 1}; analytic gradient within {grad_rel:g} of "
        f"autograd's, relative to its largest entry {scale:g}; "
        f"{int(touched.sum())} of {len(verts)} vertices touched, all other "
        "rows zero")
    log(f"  step (median of steps 1..{TRAIN_STEPS - 1}, CUDA events): "
        f"forward {fwd_ms:.3f} ms, backward {bwd_ms:.3f} ms, step "
        f"{fwd_ms + bwd_ms:.3f} ms = "
        f"{n / (fwd_ms + bwd_ms) / 1e3:.1f} Mray/s")

    # -- 8. times -------------------------------------------------------------
    log("[8] times (CUDA events, median of 5 after a warm-up; the L2 cache "
        "is not flushed between launches)")
    times = {}
    for log2 in (20, 21):
        r = Rays(*(a[:1 << log2].contiguous() for a in rays))
        for mode, occl in (("closest", False), ("occluded", True)):
            ms = time_ms(lambda: rt2.intersect_rowtrace2(ts, r,
                                                         occluded=occl))
            times[f"{mode}_2^{log2}"] = ms
            log(f"  rowtrace2 {mode}, 2^{log2} rays: {ms:.3f} ms, "
                f"{(1 << log2) / ms / 1e3:.1f} Mray/s")
    t_k, p_k = rt2.intersect_rowtrace2(ts, rays)
    for label, r, tk, pkk in (
            (f"2^{LOG2_RAYS}", rays, t_k, p_k),
            ("2^20", Rays(*(a[:1 << 20].contiguous() for a in rays)),
             t_k[:1 << 20].contiguous(), p_k[:1 << 20].contiguous())):
        fin_ms = time_ms(lambda: _finalize_hits(cs.tris, r, tk, pkk))
        log(f"  _finalize_hits (plain torch ops), {label} rays: "
            f"{fin_ms:.3f} ms")
    for label, fn in (
            ("intersect request, treelet path, 2^21 rays",
             lambda: scene.intersect(rays)),
            ("occluded request, treelet path, 2^21 rays",
             lambda: scene.occluded(rays)),
            ("intersect request, packet path (a), 2^21 rays",
             lambda: small.intersect(rays)),
            ("intersect request, packet path (b), coherent frame",
             lambda: scene.intersect(frame, coherent=True))):
        log(f"  {label}: {time_ms(fn):.3f} ms")
    log(f"  rowtrace2 plain version (counting), 2^{B1_PLAIN_LOG2} rays: "
        f"closest {plain_ms:.0f} ms, occluded {plain_occ_ms:.0f} ms")
    stats = {}
    for mode, occl in (("closest", False), ("occluded", True)):
        _t, _p, st = rt2.rowtrace2_stats(ts, rays, occluded=occl)
        stats[mode] = st
        per = {k: v / st["rays"] for k, v in st.items()
               if k not in ("rays", "treelets_touched")}
        log(f"  stats {mode}: per ray " + ", ".join(
            f"{k} {v:.2f}" for k, v in per.items())
            + f"; {st['treelets_touched']} of {ts.num_treelets} treelets "
              "touched")
    if not torch.equal(_p, torch.full_like(_p, -1)):
        raise AssertionError("the occluded variant wrote a prim id")
    bound = roofline_bound(ts, stats["closest"])
    kernel_ms = times[f"closest_2^{LOG2_RAYS}"]
    log(f"  bound at 2^{LOG2_RAYS} rays closest: bytes "
        f"{bound['bytes'] / 1e6:.1f} MB -> {bound['bytes_ms']:.4f} ms, "
        f"operations {bound['flops'] / 1e9:.2f} GFLOP -> "
        f"{bound['flops_ms']:.4f} ms; bound by {bound['bound_by']}; the "
        f"kernel's {kernel_ms:.3f} ms is "
        f"{100 * bound['bound_ms'] / kernel_ms:.1f} % of it")

    pk_a = packet_times("(a) 99,012 triangles, incoherent", scs.packet, rays)
    packet_times("(b) 998,284 triangles, coherent frame", cs.packet,
                 frame_flat)
    packet_times("(b) 998,284 triangles, 2^15 incoherent", cs.packet, few)
    packet_times("998,284 triangles, 2^21 incoherent (the treelet path's "
                 "batch)", cs.packet, rays)

    def sorted_closest():
        srays, perm = sort_rays_stream(rays, scs.world_lower, scs.world_upper)
        return unsort_by_perm(perm, *pk.intersect_packet_kernel_raw(
            scs.packet, srays))

    def sorted_occluded():
        srays, perm = sort_rays_stream(rays, scs.world_lower, scs.world_upper)
        return unsort_by_perm(perm, pk.occluded_packet_kernel(scs.packet,
                                                              srays))

    t_s, p_s = sorted_closest()
    if not (torch.equal(t_s, h_a.t) and torch.equal(p_s, h_a.gprim)):
        raise AssertionError("sorted and unsorted packet answers differ")
    sort_ms = time_ms(lambda: sort_rays_stream(rays, scs.world_lower,
                                               scs.world_upper))
    log(f"  (a) with sort_rays_stream + unsort_by_perm (sort alone "
        f"{sort_ms:.3f} ms): closest {time_ms(sorted_closest):.3f} ms "
        f"against {time_ms(lambda: pk.intersect_packet_kernel_raw(scs.packet, rays)):.3f} ms unsorted, "
        f"occluded {time_ms(sorted_occluded):.3f} ms against "
        f"{time_ms(lambda: pk.occluded_packet_kernel(scs.packet, rays)):.3f} "
        "ms unsorted; the scene path does not sort")

    # -- 8b. main-bvh8: the packet kernel at W = 8 on main ------------------
    log(f"[8b] main-bvh8: triangle_sphere({SCENE_RES}) as a BVH8 packet scene "
        f"(tri_accel=bvh8.triangle4.packet), 2^{LOG2_RAYS} rays and the "
        "frame")
    bvh8_err = bvh8_phase(verts, idx, rays, frame, hits)

    # -- 9. the compressed subdivision path at full size --------------------
    log(f"[9] compressed path: sphere_cage({SUBDIV_CAGE}) displaced by fBm "
        f"noise, set_levels{SUBDIV_LEVELS}, bvh4.compressed.leaf")
    big_mesh = sphere_cage(SUBDIV_CAGE, noise_displacement)
    faces = len(big_mesh[1])
    prof.samples.clear()
    t0 = time.perf_counter()
    sub = subdiv_scene("", big_mesh, SUBDIV_LEVELS, "leaf")
    torch.cuda.synchronize()
    commit_s = time.perf_counter() - t0
    ccs = sub.committed
    pc = ccs.compressed_kernel
    log(f"  commit {commit_s:.1f} s: " + ", ".join(
        f"{k} {prof.stats(k)['avg']:.2f} s" for k in prof.samples))
    cells = pc.num_tiles * (1 << pc.comp_level) ** 2
    rec_bytes = 4 * pc.tiles.shape[1]
    log(f"  {faces} faces, {pc.num_tiles} tiles of "
        f"{(1 << pc.comp_level) ** 2} cells = {cells} cells, top BVH4 of "
        f"{pc.num_nodes} nodes in {pc.top_depth} levels; a tile uses "
        f"{tile_used_bytes(pc)} B in a compact record of {rec_bytes} B (the "
        f"JAX package's rows: {tile_row_bytes(pc)} B); the compact accel "
        f"{pc.device_bytes / 1e6:.1f} MB on the card (the rows "
        f"{packed_row_bytes(pc) / 1e6:.1f} MB), the committed scene "
        f"{_scene_bytes(ccs) / 1e6:.1f} MB in all (of the accel itself only "
        "its ids and uv tables)")
    if (rec_bytes > 1.1 * tile_used_bytes(pc)
            or ccs.compressed.tiles.space is not None):
        raise AssertionError("the committed compressed scene is not compact")
    tiles_a_face = (1 << (SUBDIV_LEVELS[0] - SUBDIV_LEVELS[1])) ** 2
    if ccs.tris.num_prims != 0 or pc.num_tiles != faces * tiles_a_face:
        raise AssertionError("the full-size scene is not subdiv-only with "
                             f"{tiles_a_face} tiles a face")
    with Launches() as lc:
        h_c = sub.intersect(rays)
        occ_c = sub.occluded(rays)
        h_cf = sub.intersect(frame, coherent=True)
        occ_cf = sub.occluded(frame)
        torch.cuda.synchronize()
    lc.expect("compressed requests", 0, 0)
    lc.expect_cbvh("2 intersect + 2 occluded requests", 2, 2)
    check_subdiv_hits("compressed, incoherent", h_c, (n,), faces)
    check_subdiv_hits("compressed, frame", h_cf, (FRAME[1], FRAME[0]),
                      faces)
    for label, h, o in (("incoherent", h_c, occ_c), ("frame", h_cf, occ_cf)):
        if (h.valid & ~o).any():
            raise AssertionError(f"compressed, {label}: a hit is not occluded")
        frac = float(h.valid.float().mean())
        ofrac = float(o.float().mean())
        if not (0.05 < frac < 0.9 and ofrac < 0.9):
            raise AssertionError(f"compressed, {label}: hit fraction {frac}, "
                                 f"occluded {ofrac}")
        log(f"  {label}: hit fraction {frac:.4f}, occluded "
            f"{ofrac:.4f}, occluded covers every hit")
    nb4 = 1 << B4_PLAIN_LOG2
    head4 = Rays(*(a[:nb4].contiguous() for a in rays))
    cb_full_err, cb_plain_ms, cbo_plain_ms, cbo_full_err = compare_cbvh_plain(
        pc, head4, f"{pc.num_tiles} tiles, 2^{B4_PLAIN_LOG2} rays of the "
        "main path")
    e_fr, _, _, o_fr = compare_cbvh_plain(
        pc, frame_flat, f"{pc.num_tiles} tiles, the {FRAME[0]}x{FRAME[1]} "
        "frame")
    cb_full_err, cbo_full_err = max(cb_full_err, e_fr), max(cbo_full_err,
                                                            o_fr)
    t_head = ck.intersect_compressed_kernel(pc, head4)
    if not (torch.equal(t_head.t, h_c.t[:nb4])
            and torch.equal(t_head.u, h_c.u[:nb4])):
        raise AssertionError("the request and the kernel's wrapper disagree")
    del head4, t_head
    # the eager tessellation of the same mesh, traced by the packet kernel
    t0 = time.perf_counter()
    eager = subdiv_scene("", big_mesh, SUBDIV_LEVELS)
    torch.cuda.synchronize()
    ecs = eager.committed
    log(f"  eager commit {time.perf_counter() - t0:.1f} s: "
        f"{ecs.tris.num_prims} triangles, BVH{ecs.packet.width} of "
        f"{ecs.packet.num_nodes} nodes in {ecs.packet.depth} levels")
    packet_bytes_line("eager mesh committed", ecs.packet)
    if ecs.rowtrace is not None or ecs.tris.num_prims != 2 * cells:
        raise AssertionError("the eager scene is not two triangles a cell "
                             "on the packet path")
    with Launches() as lc:
        h_e = eager.intersect(rays)
        h_ef = eager.intersect(frame, coherent=True)
        torch.cuda.synchronize()
    lc.expect("eager requests", 0, 2)
    check_subdiv_hits("eager", h_e, (n,), faces)
    check_conservative("leaf vs eager triangles, incoherent", h_e, h_c)
    check_conservative("leaf vs eager triangles, frame", h_ef, h_cf)
    del eager, ecs, h_ef

    # -- 10. the other modes and node flavors on the smaller cage -----------
    log(f"[10] sphere_cage({SUBDIV_SMALL_CAGE}), set_levels"
        f"{SUBDIV_SMALL_LEVELS}: every mode and node flavor, a mixed scene")
    small_mesh = sphere_cage(SUBDIV_SMALL_CAGE, noise_displacement)
    small_faces = len(small_mesh[1])
    n18 = 1 << 18
    r18 = Rays(*(a[:n18].contiguous() for a in rays))
    nbs = 1 << B4_SMALL_LOG2
    heads = Rays(*(a[:nbs].contiguous() for a in rays))
    eager_s = subdiv_scene("", small_mesh, SUBDIV_SMALL_LEVELS)
    h_es = eager_s.intersect(r18)
    by_mode = {}
    for mode in ("grid", "leaf", "box"):
        sc = subdiv_scene("", small_mesh, SUBDIV_SMALL_LEVELS, mode)
        with Launches() as lc:
            h = sc.intersect(r18)
            o = sc.occluded(r18)
            torch.cuda.synchronize()
        lc.expect_cbvh(f"{mode} requests", 1, 1)
        check_subdiv_hits(mode, h, (n18,), small_faces)
        if (h.valid & ~o).any():
            raise AssertionError(f"{mode}: a hit is not occluded")
        by_mode[mode] = (sc, h)
        err, _, _, occ_err = compare_cbvh_plain(
            sc.committed.compressed_kernel, heads,
            f"{mode}, {sc.committed.compressed_kernel.num_tiles} tiles")
        cb_full_err = max(cb_full_err, err)
        cbo_full_err = max(cbo_full_err, occ_err)
        if mode != "grid":
            check_conservative(f"{mode} vs eager triangles", h_es, h)
    # grid mode against the eager triangles (the other diagonal in half of
    # the cells of a noisy surface: the valid masks and the 99th percentile
    # of |dt| are held) and against its own cells as a triangle mesh (the
    # same triangles: 1e-4 relative)
    sc_g, h_g = by_mode["grid"]
    same = float((h_g.valid == h_es.valid).float().mean())
    both = h_g.valid & h_es.valid
    dabs = (h_g.t - h_es.t)[both].abs()
    dmax, d99 = float(dabs.max()), float(dabs.quantile(0.99))
    gverts, gidx = grid_triangles(sc_g.committed.compressed_kernel)
    gscene = ett.Scene(ett.Device(
        "ignore_config_files=1,tri_accel=bvh4.triangle4.packet"))
    gscene.attach(ett.TriangleMesh(gverts, gidx))
    gscene.commit()
    h_gt = gscene.intersect(r18)
    same_own = float((h_g.valid == h_gt.valid).float().mean())
    both = h_g.valid & h_gt.valid
    rel = float(((h_g.t - h_gt.t).abs() / h_gt.t.abs())[both].max())
    log(f"  grid vs eager triangles: valid equal on {100 * same:.4f} % of "
        f"the rays, |dt| 99th percentile {d99:.3g}, max {dmax:.3g}; grid vs "
        f"its own cells as {len(gidx)} triangles: valid equal on "
        f"{100 * same_own:.4f} %, t within {rel:.3g} relative")
    if same < 0.995 or d99 > 2e-2 or same_own < 0.9999 or rel > 1e-4:
        raise AssertionError("grid mode disagrees with the triangles")
    # mode full and flavors non / mid run in torch ops (no kernel)
    for mode, flavor in (("full", "com"), ("box", "non"), ("leaf", "mid")):
        sc = subdiv_scene("", small_mesh, SUBDIV_SMALL_LEVELS, mode, flavor)
        if sc.committed.compressed_kernel is not None:
            raise AssertionError(f"{mode}/{flavor} has a packed accel")
        with Launches() as lc:
            h = sc.intersect(heads)
            o = sc.occluded(heads)
            torch.cuda.synchronize()
        lc.expect_cbvh(f"{mode}/{flavor}", 0, 0)
        check_subdiv_hits(f"{mode}/{flavor}", h, (nbs,), small_faces)
        if (h.valid & ~o).any():
            raise AssertionError(f"{mode}/{flavor}: a hit is not occluded")
        ref_h = hits_head(h_es, nbs)
        check_conservative(f"{mode}/{flavor} (torch ops) vs eager triangles",
                           ref_h, h)
    # a mixed scene: the sphere over a ground plane of triangles
    mixed = subdiv_scene("", small_mesh, SUBDIV_SMALL_LEVELS, "leaf",
                         plane=True)
    with Launches() as lc:
        h_m = mixed.intersect(r18)
        o_m = mixed.occluded(r18)
        torch.cuda.synchronize()
    lc.expect("mixed scene", 0, 2)
    lc.expect_cbvh("mixed scene", 1, 1)
    # the walk over the tiles starts from the plane's t, which moves the
    # far end the projected ray is fitted to: the sphere's hits agree with
    # the subdiv-only scene's within 1e-4 relative on most rays, not all
    h_l = by_mode["leaf"][1]
    on_plane = h_m.valid & (h_m.geom_id == 0)
    on_sphere = h_m.valid & (h_m.geom_id == 1)
    agree = float((on_sphere | (h_l.valid & on_plane) == h_l.valid)
                  .float().mean())
    both = on_sphere & h_l.valid
    close = float(((h_m.t - h_l.t).abs() <= 1e-4 * h_l.t)[both]
                  .float().mean())
    if not (on_plane.any() and on_sphere.any() and agree >= 0.999
            and close >= 0.99
            and (h_m.t[on_plane] < h_l.t[on_plane]).all()
            and not (h_m.valid & ~o_m).any()):
        raise AssertionError("the mixed scene does not fold both accels: "
                             f"masks agree on {agree:.5f}, t on {close:.5f}")
    log(f"  mixed scene: {int(on_sphere.sum())} hits on the sphere "
        f"({100 * close:.3f} % within 1e-4 relative of the subdiv-only "
        f"scene's, masks consistent on {100 * agree:.4f} % of the rays), "
        f"{int(on_plane.sum())} on the plane, each nearer than the sphere's")
    del by_mode, mixed, eager_s, gscene

    # -- 11. the displacement_geometry tutorial -----------------------------
    log("[11] displacement_geometry tutorial, --compress.leaf")
    dapp = displacement_tutorial.make_app()
    with Launches() as lc:
        rc = dapp.run(["--compress.leaf", "--benchmark", "1", "3",
                       "-rtcore", "ignore_config_files=1"])
        torch.cuda.synchronize()
    if rc != 0:
        raise AssertionError(f"the tutorial returned {rc}")
    lc.expect("tutorial: 5 frames of 2 batches", 0, 10)
    lc.expect_cbvh("tutorial: 5 frames of 2 batches", 5, 5)
    small_size = (64, 48)
    imgs = {}
    for where, rtcore in (("card", ""), ("cpu", "device=cpu")):
        st = displacement_tutorial.build_scene("bvh4.compressed.leaf",
                                               rtcore=rtcore)
        img, _nr = displacement_tutorial.render_frame(st, dapp.camera,
                                                      small_size)
        imgs[where] = img.cpu().numpy()
    diff = np.abs(imgs["card"] - imgs["cpu"]).max(-1)
    bad = float((diff > 1.5 / 255).mean())
    lit = float((imgs["card"].max(-1) > 0).mean())
    if not (np.isfinite(imgs["card"]).all() and bad <= 0.005 and lit > 0.3):
        raise AssertionError(f"tutorial: {bad:.4%} of the pixels differ from "
                             f"the CPU render, {lit:.2%} lit")
    log(f"  tutorial at {dapp.default_size[0]}x{dapp.default_size[1]} ran; "
        f"{small_size[0]}x{small_size[1]} frame: {bad:.4%} of the pixels "
        "differ from this package's CPU render by more than 1.5/255 "
        f"(budget 0.5 %), {lit:.2%} of the pixels lit")

    # -- 12. times of the compressed kernels --------------------------------
    log("[12] compressed kernels: times (CUDA events, median of 5 after a "
        "warm-up), counters and bounds")
    cb_inc = cbvh_times(f"{pc.num_tiles} tiles leaf, 2^{LOG2_RAYS} "
                        "incoherent", pc, rays)
    cbvh_times(f"{pc.num_tiles} tiles leaf, {FRAME[0]}x{FRAME[1]} coherent "
               "frame", pc, frame_flat)
    for label, fn in (
            ("intersect request, compressed path, 2^21 rays",
             lambda: sub.intersect(rays)),
            ("occluded request, compressed path, 2^21 rays",
             lambda: sub.occluded(rays)),
            ("intersect request, compressed path, coherent frame",
             lambda: sub.intersect(frame, coherent=True))):
        log(f"  {label}: {time_ms(fn):.3f} ms")
    log(f"  plain versions (counting), 2^{B4_PLAIN_LOG2} rays: closest "
        f"{cb_plain_ms:.0f} ms, occluded {cbo_plain_ms:.0f} ms")

    # -- 12b. main-c in grid and box mode -----------------------------------
    log(f"[12b] main-c in the paper's other leaf modes: sphere_cage("
        f"{SUBDIV_CAGE}) at set_levels{SUBDIV_LEVELS} as "
        + " and ".join(f"bvh4.compressed.{m}" for m in CAGE_MODES)
        + f", 2^{LOG2_RAYS} rays and the frame")
    cages = join_cage_commits(cage_jobs, dev.device)
    cage_err, cage_occ_err = cage_modes_phase(cages, rays, frame, h_c, h_cf,
                                              h_e)
    del cages, h_e

    # -- 13. the motion-blur path at full size ------------------------------
    log(f"[13] motion-blur path: triangle_sphere({SCENE_RES}) as one "
        f"TriangleMeshMB of {1 + len(MB_KNOTS)} timesteps (kinked motion)")
    knots = [verts] + [verts + np.float32(k) for k in MB_KNOTS]
    mbs = ett.Scene(dev)
    mbs.attach(ett.TriangleMeshMB(indices=idx, timesteps=knots))
    prof.samples.clear()
    t0 = time.perf_counter()
    mcs = mbs.commit()
    torch.cuda.synchronize()
    commit_s = time.perf_counter() - t0
    pm = mcs.mb_kernel
    log(f"  commit {commit_s:.1f} s: " + ", ".join(
        f"{k} {prof.stats(k)['avg']:.2f} s" for k in prof.samples))
    split = ("fired: root children gated to "
             + str([(float(a), float(b)) for a, b in zip(
                 mcs.mb.time_lo[0].tolist(), mcs.mb.time_hi[0].tolist())])
             if mcs.mb.has_time_splits else "did not fire")
    log(f"  {pm.num_prims} triangles at {pm.S} knots; BVH{pm.W} of "
        f"{pm.num_nodes} nodes in {pm.depth} levels; the temporal split "
        f"{split}; node rows of {pm.node_rows.shape[1]} floats "
        f"({4 * pm.W + 6 * pm.W * pm.S} used), triangle rows of "
        f"{pm.tri_rows.shape[1]} floats ({9 * pm.S} used); packed "
        f"{pm.device_bytes / 1e6:.1f} MB, the committed scene "
        f"{_scene_bytes(mcs) / 1e6:.1f} MB on the card")
    if pm.num_prims != 998284 or mcs.tris.num_prims != 0:
        raise AssertionError("main-mb is not 998,284 MB triangles alone")
    gen = torch.Generator(device=dev.device)
    gen.manual_seed(MB_TIME_SEED)
    times = torch.rand(n, generator=gen, device=dev.device)
    ftimes = torch.rand((FRAME[1], FRAME[0]), generator=gen,
                        device=dev.device)
    with Launches() as lc:
        h_mb = mbs.intersect(rays, time=times)
        h_mbf = mbs.intersect(frame, time=ftimes, coherent=True)
        occ_mb = mk.occluded_mb_kernel(pm, rays, times)
        torch.cuda.synchronize()
    lc.expect("motion-blur requests", 0, 0)
    lc.expect_mb("2 intersect requests + 1 occluded_mb_kernel", 2, 1)
    check_hits("motion blur, incoherent", h_mb, (n,))
    check_hits("motion blur, frame", h_mbf, (FRAME[1], FRAME[0]))
    if not torch.equal(occ_mb, h_mb.valid):
        raise AssertionError("occluded_mb_kernel disagrees with intersect's "
                             "valid mask")
    frac = float(h_mb.valid.float().mean())
    frac_fr = float(h_mbf.valid.float().mean())
    if not (0.15 < frac < 0.8 and 0.05 < frac_fr < 0.9):
        raise AssertionError(f"motion blur: hit fractions {frac:.3f}, "
                             f"{frac_fr:.3f}")
    log(f"  2^{LOG2_RAYS} rays at random times: hit fraction {frac:.4f}, "
        f"occluded == valid; {FRAME[0]}x{FRAME[1]} frame: {frac_fr:.4f}")
    try:
        mbs.occluded(rays)
    except ett.RaytracerError as e:
        log(f"  scene.occluded over motion blur raises: {e}")
    else:
        raise AssertionError("scene.occluded over motion blur did not raise")

    # -- 14. the motion-blur path: correctness at full size -----------------
    log("[14] motion-blur path: correctness at full size")
    nmb = 1 << MB_PLAIN_LOG2
    head_mb = Rays(*(a[:nmb].contiguous() for a in rays))
    (mb_full_err, mb_full_ulps, mb_plain_ms, mbo_plain_ms,
     mbo_full_err) = compare_mb_plain(
        pm, head_mb, times[:nmb],
        f"main-mb, the first 2^{MB_PLAIN_LOG2} rays of the main path")
    _t, p_head, _ = mk.mb_trace(pm, head_mb, times[:nmb])
    if not torch.equal(h_mb.gprim[:nmb], p_head):
        raise AssertionError("the request and the kernel's wrapper disagree")
    with Launches() as lc:
        h_t0 = mbs.intersect(rays, time=0.0)
        h_t1 = mbs.intersect(rays, time=1.0)
        torch.cuda.synchronize()
    lc.expect_mb("requests at time 0 and 1", 2, 0)
    last = ett.Scene(ett.Device(
        "ignore_config_files=1,tri_accel=bvh4.triangle4.packet"))
    last.attach(ett.TriangleMesh(knots[-1], idx))
    last.commit()
    mb_ties = [
        check_static_knot("time 0 vs the static first knot (packet kernel)",
                          h_t0, *pk.intersect_packet_kernel_raw(cs.packet,
                                                                rays)),
        check_static_knot("time 1 vs the static last knot (packet kernel)",
                          h_t1, *pk.intersect_packet_kernel_raw(
                              last.committed.packet, rays))]
    mb_brute_check("motion blur, random times", mcs.mb, rays, times,
                   h_mb.valid, h_mb.t)
    del last, h_t0, h_t1

    # -- 15. the motion_blur_geometry tutorial ---------------------------
    log("[15] motion_blur_geometry tutorial")
    mapp = mb_tutorial.make_app()
    with Launches() as lc:
        rc = mapp.run(["--benchmark", "1", "3",
                       "-rtcore", "ignore_config_files=1"])
        torch.cuda.synchronize()
    if rc != 0:
        raise AssertionError(f"the tutorial returned {rc}")
    lc.expect("tutorial: 5 frames", 0, 5)
    lc.expect_mb("tutorial: 5 frames", 5, 0)
    small_size = (64, 48)
    ttimes = mb_tutorial.frame_times(0, *small_size, "cpu")
    imgs = {}
    for where, dv in (("card", ett.Device("ignore_config_files=1")),
                      ("cpu", ett.Device("ignore_config_files=1",
                                         device="cpu"))):
        st = mb_tutorial.build_scene(dv)
        scs_ = st["cscene"]
        cam = mapp.camera.ispc_camera(*small_size, device=scs_.device)
        img = mb_tutorial.render(scs_, st["colors"], ttimes.to(scs_.device),
                                 *cam, width=small_size[0],
                                 height=small_size[1])
        imgs[where] = img.cpu().numpy()
    diff = np.abs(imgs["card"] - imgs["cpu"]).max(-1)
    bad = float((diff > 1.5 / 255).mean())
    lit = float((imgs["card"].max(-1) > 0).mean())
    if not (np.isfinite(imgs["card"]).all() and bad <= 0.005 and lit > 0.3):
        raise AssertionError(f"tutorial: {bad:.4%} of the pixels differ from "
                             f"the CPU render, {lit:.2%} lit")
    log(f"  tutorial at {mapp.default_size[0]}x{mapp.default_size[1]} ran; "
        f"{small_size[0]}x{small_size[1]} frame at the same times: "
        f"{bad:.4%} of the pixels differ from this package's CPU render by "
        f"more than 1.5/255 (budget 0.5 %), {lit:.2%} of the pixels lit")

    # -- 16. times of the motion-blur kernel -----------------------------
    log("[16] motion-blur kernel: times (CUDA events, median of 5 after a "
        "warm-up), counters and bounds")
    mb_inc = mb_times(f"main-mb, 2^{LOG2_RAYS} incoherent", pm, rays, times)
    mb_times(f"main-mb, {FRAME[0]}x{FRAME[1]} coherent frame", pm,
             frame_flat, ftimes.reshape(-1))
    for label, fn in (
            ("intersect request, motion-blur path, 2^21 rays",
             lambda: mbs.intersect(rays, time=times)),
            ("intersect request, motion-blur path, coherent frame",
             lambda: mbs.intersect(frame, time=ftimes, coherent=True))):
        log(f"  {label}: {time_ms(fn):.3f} ms")
    log(f"  plain versions, 2^{MB_PLAIN_LOG2} rays: closest "
        f"{mb_plain_ms:.0f} ms, occluded {mbo_plain_ms:.0f} ms; kernel vs "
        f"plain within {max(mb_small_ulps, mb_full_ulps)} ulp; "
        f"{sum(mb_ties)} ties against the static knots")

    # -- 17. the hair path at full size: main-hair --------------------------
    log(f"[17] hair path: main-hair, the hair_geometry tutorial's fur at "
        f"{HAIR_FUR_STRANDS} strands (tessellation 6) over its ground plane")
    fur_v, fur_i = hair_tutorial.make_fur(HAIR_FUR_STRANDS)
    hs = ett.Scene(dev)
    hs.attach(ett.TriangleMesh(hair_tutorial.PLANE_V, hair_tutorial.PLANE_T))
    hs.attach(ett.BezierCurves(fur_v, fur_i, tessellation_rate=6))
    prof.samples.clear()
    t0 = time.perf_counter()
    hcs = hs.commit()
    torch.cuda.synchronize()
    commit_s = time.perf_counter() - t0
    nseg = sum(h.packed.num_segments for h in hcs.hairs)
    log(f"  commit {commit_s:.2f} s: " + ", ".join(
        f"{k} {prof.stats(k)['avg']:.2f} s" for k in prof.samples))
    log(f"  {nseg} round sub-segments in {len(hcs.hairs)} clusters "
        f"(segments {[h.packed.num_segments for h in hcs.hairs]}, levels "
        f"{[h.packed.depth for h in hcs.hairs]}); packed "
        f"{sum(h.packed.device_bytes for h in hcs.hairs) / 1e6:.1f} MB, the "
        f"committed scene {_scene_bytes(hcs) / 1e6:.1f} MB on the card")
    if nseg != 1572864 or hcs.tris.num_prims != 2:
        raise AssertionError("main-hair is not 1,572,864 sub-segments over a "
                             "plane of 2 triangles")
    hcam = hair_tutorial.make_app().camera
    hframe = primary_rays(hcam, *FRAME, device=dev.device)
    with Launches() as lc:
        h_hair = hs.intersect(rays)
        o_hair = hs.occluded(rays)
        h_hfr = hs.intersect(hframe, coherent=True)
        o_hfr = hs.occluded(hframe)
        torch.cuda.synchronize()
    lc.expect("main-hair: 2 intersect + 2 occluded requests", 0, 4)
    lc.expect_hair("main-hair: 2 intersect + 2 occluded requests", hcs, 2, 2)
    check_curve_hits("main-hair, incoherent", h_hair, (n,))
    check_curve_hits("main-hair, frame", h_hfr, (FRAME[1], FRAME[0]))
    if not (torch.equal(o_hair, h_hair.valid)
            and torch.equal(o_hfr, h_hfr.valid)):
        raise AssertionError("main-hair: occluded disagrees with intersect")
    frac = float(h_hair.valid.float().mean())
    frac_fr = float(h_hfr.valid.float().mean())
    on_hair = float((h_hfr.geom_id == 1).float().mean())
    if not (0.05 < frac < 0.8 and 0.2 < frac_fr and on_hair > 0.1):
        raise AssertionError(f"main-hair: hit fractions {frac:.3f}, "
                             f"{frac_fr:.3f} ({on_hair:.3f} on hair)")
    log(f"  2^{LOG2_RAYS} rays: hit fraction {frac:.4f} "
        f"({float((h_hair.geom_id == 1).float().mean()):.4f} on hair); "
        f"{FRAME[0]}x{FRAME[1]} frame: {frac_fr:.4f} ({on_hair:.4f} on "
        f"hair); occluded == valid; 1 B3 launch a request over "
        f"{len(hcs.hairs)} clusters")

    # -- 18. the hair path: correctness at full size --------------------------
    log("[18] hair path: correctness at full size")
    hm_err, hm_plain_ms, hmo_plain_ms = hair_full_checks(
        "main-hair", hcs, rays)
    check_fold_equal(f"main-hair, 2^{LOG2_RAYS} incoherent", hcs, rays)
    check_fold_equal(f"main-hair, {FRAME[0]}x{FRAME[1]} frame", hcs, hframe)
    hair_brute_check("main-hair, incoherent", hcs, rays, HAIR_BRUTE_RAYS)
    hair_brute_check("main-hair, frame", hcs, hframe, HAIR_BRUTE_RAYS)

    # -- 19. hairball-flat ----------------------------------------------------
    log(f"[19] hair path: hairball-flat, hair_ball({HAIR_BALL_CURVES}) as "
        "flat curves, K = 8")
    hb_v, hb_i = hair_ball(np.random.default_rng(HAIR_SEED),
                           HAIR_BALL_CURVES)
    fs = ett.Scene(dev)
    fs.attach(ett.BezierCurves(hb_v, hb_i, tessellation_rate=8, flat=True))
    prof.samples.clear()
    t0 = time.perf_counter()
    fcs = fs.commit()
    torch.cuda.synchronize()
    commit_s = time.perf_counter() - t0
    nseg = sum(h.packed.num_segments for h in fcs.hairs)
    log(f"  commit {commit_s:.2f} s: " + ", ".join(
        f"{k} {prof.stats(k)['avg']:.2f} s" for k in prof.samples))
    log(f"  {nseg} ribbon sub-segments in {len(fcs.hairs)} clusters; packed "
        f"{sum(h.packed.device_bytes for h in fcs.hairs) / 1e6:.1f} MB")
    if nseg != 524288 or len(fcs.hairs) != 13:
        raise AssertionError("hairball-flat is not 524,288 sub-segments in "
                             "13 clusters")
    with Launches() as lc:
        h_ball = fs.intersect(rays)
        o_ball = fs.occluded(rays)
        torch.cuda.synchronize()
    lc.expect_hair("hairball-flat: intersect + occluded", fcs, 1, 1)
    check_curve_hits("hairball-flat", h_ball, (n,))
    if not torch.equal(o_ball, h_ball.valid):
        raise AssertionError("hairball-flat: occluded disagrees")
    frac = float(h_ball.valid.float().mean())
    if not 0.05 < frac < 0.9:
        raise AssertionError(f"hairball-flat: hit fraction {frac:.3f}")
    log(f"  2^{LOG2_RAYS} rays: hit fraction {frac:.4f}, occluded == valid; "
        f"{lc.hair_ribbon} ribbon and {lc.hair_ribbon_occluded} any-hit "
        f"launches for one intersect and one occluded request")
    hb_err, hb_plain_ms, hbo_plain_ms = hair_full_checks(
        "hairball-flat", fcs, rays)
    check_fold_equal(f"hairball-flat, 2^{LOG2_RAYS} incoherent", fcs, rays)
    hair_brute_check("hairball-flat", fcs, rays, HAIR_BRUTE_RAYS)

    # -- 20. small curve scenes: segments, soups, motion blur -----------------
    log("[20] curves on the torch-op walks: LineSegments, the segment soup, "
        "BezierCurvesMB")
    crng = np.random.default_rng(0x20)
    seg_v = crng.uniform(-2, 2, (1024, 4)).astype(np.float32)
    seg_v[:, 3] = 0.03
    soups = []
    ls = ett.Scene(dev)
    ls.attach(ett.LineSegments(seg_v, np.arange(0, 1024, 2, dtype=np.int32)))
    ls.commit()
    soups.append(("LineSegments (512)", ls))
    sv, si = hair_ball(crng, 100)
    ss = ett.Scene(ett.Device("ignore_config_files=1,hair_accel=segment"))
    ss.attach(ett.BezierCurves(sv, si, tessellation_rate=4))
    ss.commit()
    soups.append(("hair_ball(100) under hair_accel=segment (400)", ss))
    srays = Rays(*(a[:SOUP_RAYS].contiguous() for a in rays))
    for label, sc in soups:
        with Launches() as lc:
            hh = sc.intersect(srays)
            oo = sc.occluded(srays)
            torch.cuda.synchronize()
        lc.expect(label, 0, 0)
        check_curve_hits(label, hh, (SOUP_RAYS,))
        if not torch.equal(oo, hh.valid) or not hh.valid.any():
            raise AssertionError(f"{label}: occluded disagrees or no hit")
        brute_user_check(label, sc.committed.users[0], srays, hh, 1024)
    obb = ett.Scene(dev)
    obb.attach(ett.BezierCurves(sv, si, tessellation_rate=4))
    obb.commit()
    h_obb = obb.intersect(srays)
    flips = float((h_obb.valid != soups[1][1].intersect(srays).valid)
                  .float().mean())
    if flips >= 0.01:
        raise AssertionError(f"OBB clusters and segment soup: {flips:.4f} "
                             "of the hits differ")
    log(f"  the same curves as OBB clusters through B3: hit masks differ on "
        f"{flips:.4%} of the rays (caps against sub-segment joins)")
    mv, mi = hair_ball(crng, 60)
    shift = np.float32([0.4, -0.3, 0.2, 0.0])
    ms = ett.Scene(dev)
    ms.attach(ett.BezierCurvesMB(indices=mi, tessellation_rate=4,
                                 timesteps=[mv, mv + shift, mv - shift]))
    ms.commit()
    mrays = Rays(*(a[:SOUP_RAYS].contiguous() for a in rays))
    mtimes = torch.rand(SOUP_RAYS, generator=gen, device=dev.device)
    hmc = ms.intersect(mrays, time=mtimes)
    check_curve_hits("BezierCurvesMB", hmc, (SOUP_RAYS,))
    acc = ms.committed.mb_curves
    x = mtimes.clamp(0, 1) * float(acc.num_timesteps - 1)
    sg = x.to(torch.int32).clamp(0, acc.num_timesteps - 2).long()
    w = (x - sg.to(torch.float32))[:, None]
    best = mrays.tfar.clone()
    for p in range(acc.p0_ts.shape[1]):
        a = acc.p0_ts[sg, p] * (1 - w) + acc.p0_ts[sg + 1, p] * w
        b = acc.p1_ts[sg, p] * (1 - w) + acc.p1_ts[sg + 1, p] * w
        ok, th, _s, _ng = _cone_hit(a[:, :3], b[:, :3], a[:, 3], b[:, 3],
                                    Rays(mrays.org, mrays.dir, mrays.tnear,
                                         best), best)
        best = torch.where(ok, th, best)
    if not (torch.equal(best, hmc.t) and hmc.valid.any()):
        raise AssertionError("BezierCurvesMB: brute force over the lerped "
                             "segments differs on "
                             f"{int((best != hmc.t).sum())} rays")
    log(f"  BezierCurvesMB (60 curves, 3 timesteps), {SOUP_RAYS} rays at "
        f"random times: t equal to a brute force over the lerped segments "
        f"({int(hmc.valid.sum())} hits)")
    try:
        ms.occluded(mrays)
    except ett.RaytracerError as e:
        log(f"  scene.occluded over motion-blur curves raises: {e}")
    else:
        raise AssertionError("scene.occluded over MB curves did not raise")

    # -- 21. the hair_geometry and curve_geometry tutorials -------------------
    log("[21] hair_geometry and curve_geometry tutorials")
    for mod, frames_b2 in ((hair_tutorial, 2), (curve_tutorial, 1)):
        app = mod.make_app()
        app.default_size = (512, 512)
        with Launches() as lc:
            rc = app.run(["--benchmark", "1", "3",
                          "-rtcore", "ignore_config_files=1"])
            torch.cuda.synchronize()
        if rc != 0:
            raise AssertionError(f"{app.name}: returned {rc}")
        lc.expect(f"{app.name}: 5 frames", 0, 5 * frames_b2)
        lc.expect_hair(f"{app.name}: 5 frames",
                       mod.build_scene(ett.Device("ignore_config_files=1"))
                       ["cscene"], 5, 5 if frames_b2 == 2 else 0)
        small_size = (64, 48)
        imgs = {}
        for where, dv in (("card", ett.Device("ignore_config_files=1")),
                          ("cpu", ett.Device("ignore_config_files=1",
                                             device="cpu"))):
            img, _ = mod.render_frame(mod.build_scene(dv), app.camera,
                                      small_size)
            imgs[where] = img.cpu().numpy()
        diff = np.abs(imgs["card"] - imgs["cpu"]).max(-1)
        bad = float((diff > 1.5 / 255).mean())
        lit = float((imgs["card"].max(-1) > 0).mean())
        if not (np.isfinite(imgs["card"]).all() and bad <= 0.005
                and lit > 0.3):
            raise AssertionError(f"{app.name}: {bad:.4%} of the pixels "
                                 f"differ from the CPU render, {lit:.2%} lit")
        log(f"  {app.name} at 512x512 ran; {small_size[0]}x{small_size[1]}: "
            f"{bad:.4%} of the pixels differ from this package's CPU render "
            f"by more than 1.5/255 (budget 0.5 %), {lit:.2%} lit")

    # -- 22. times of kernel B3 -------------------------------------------------
    log("[22] hair kernel B3: times (CUDA events, median of 5 after a "
        "warm-up, all clusters of a scene), counters and bounds")
    hm_inc = hair_times(f"main-hair, 2^{LOG2_RAYS} incoherent", hcs, rays)
    hair_times(f"main-hair, {FRAME[0]}x{FRAME[1]} frame", hcs, hframe)
    hb_inc = hair_times(f"hairball-flat, 2^{LOG2_RAYS} incoherent", fcs,
                        rays)
    for label, fn in (
            ("intersect request, main-hair, 2^21 rays",
             lambda: hs.intersect(rays)),
            ("occluded request, main-hair, 2^21 rays",
             lambda: hs.occluded(rays)),
            ("intersect request, main-hair, coherent frame",
             lambda: hs.intersect(hframe, coherent=True)),
            ("intersect request, hairball-flat, 2^21 rays",
             lambda: fs.intersect(rays))):
        log(f"  {label}: {time_ms(fn):.3f} ms")
    log(f"  plain versions, 2^{HAIR_PLAIN_LOG2} rays, all clusters: "
        f"main-hair {hm_plain_ms:.0f} + {hmo_plain_ms:.0f} ms, "
        f"hairball-flat {hb_plain_ms:.0f} + {hbo_plain_ms:.0f} ms")

    # -- 23. the paper's demo: the viewer on bomberman.obj -------------------
    log(f"[23] the paper's demo: viewer -i bomberman.obj --compress.leaf "
        f"--subdLvl {DEMO_LEVELS[0]} --compLvl {DEMO_LEVELS[1]} --size "
        f"{DEMO_SIZE[0]} {DEMO_SIZE[1]}")
    demo_err, demo_plain_ms = demo_phase(dev.device, prof)

    # -- 24. the subdivision_geometry and interpolation tutorials -------------
    log("[24] subdivision_geometry and interpolation tutorials")
    tut_pk_err, tut_cb_err = tutorial_phase(dev.device)

    # -- 25. instances, user geometry, the rtcore facade: inst-grid ---------
    log(f"[25] inst-grid: {INST_GRID ** 2} instances of (a)'s sphere over a "
        "ground plane; instanced main and compressed children; six tutorials")
    inst = instance_phase(dev.device, scene, builder_job)

    # -- 26. the pathtracer: pt-cornell, pt-glass, pt-glass-main ------------
    log("[26] pathtracer: pt-cornell, pt-glass and pt-glass-main")
    pt_err = pathtracer_phase()

    # -- 27. differentiable rendering: trainer, materials, path_grads --------
    t27 = time.perf_counter()
    log(f"[27a] trainer: DiffSubdivRenderer over bomberman at level "
        f"{DIFF_LEVEL}, the demo camera's {DEMO_SIZE[0]}x{DEMO_SIZE[1]} "
        "frame (B1); the cube on the card (B2)")
    diff_err = trainer_phase(dev)
    log(f"[27b] material gradients on main: freeze_hits on 2^{LOG2_RAYS} "
        "rays (B1), material_grads for five materials")
    material_phase(cs, rays)
    log(f"[27c] path_grads on pt-cornell {PG_SIZE[0]}x{PG_SIZE[1]}, "
        f"{PG_SPP} spp (B2)")
    path_grad_phase(dev)
    log(f"  phase 27: {time.perf_counter() - t27:.1f} s")

    # -- 28. dynamic scenes and builders ---------------------------------
    t28 = time.perf_counter()
    log("[28] dynamic_scene, viewer_anim, the morton tree of main, "
        "buildbench")
    dyn_err = dynamic_phase(dev, verts, idx, scene, rays)
    log(f"  phase 28: {time.perf_counter() - t28:.1f} s")

    # -- 29. distribution: DP, the train step, the ring, the benchmarks ----
    t29 = time.perf_counter()
    dist_err = dist_phase(dev.device, verts, idx, scene, rays)
    log(f"  phase 29: {time.perf_counter() - t29:.1f} s")

    # rowtrace2: ms and bound_ms belong to the closest-hit request of the
    # treelet path (2^21 rays, 998,284 triangles), plain_ms to the same
    # rays (the counting plain version). packet: ms and bound_ms belong to
    # the closest-hit launch of (a) (2^21 rays, 99,012 triangles), plain_ms
    # to the same rays (counting). cbvh and cbvh_occluded: ms and bound_ms
    # belong to the 2^21 incoherent rays on the main-c scene
    # (`pc.num_tiles` tiles), plain_ms to the same rays (counting);
    # cbvh_occluded's max_abs_err counts the rays whose answer differs
    # from the plain version's. mb and mb_occluded: ms and
    # bound_ms belong to the 2^21 incoherent rays at random times on
    # main-mb, plain_ms to their first 2^16 rays; mb_occluded's
    # max_abs_err counts the rays whose answer differs; cbvh's launches and
    # error include the demo (phase 23) and the interpolation tutorial,
    # packet's the two tutorials of phase 24; the launches and errors of
    # cbvh and cbvh_occluded include main-c in grid and box mode (phase
    # 12b), packet's main-bvh8 (phase 8b). hair_cone(_occluded)
    # and hair_ribbon(_occluded): ms and bound_ms belong to the one launch
    # over every cluster of main-hair (cone) and hairball-flat (ribbon) for
    # the 2^21 incoherent rays, plain_ms to their first 2^16 rays. Every
    # max_abs_err includes phase 3f's NaN and Inf lanes, and those of B1,
    # B4 and B5 phase 3g's watertight rays; the launches and errors of
    # packet, rowtrace2, cbvh and cbvh_occluded include phase 25's instanced
    # requests (whole folds held against the plain versions); those of
    # packet and rowtrace2 phase 26's pathtracer frames (every launch of
    # the checked 64x64 frames held against its plain version) and phase
    # 27's selections (the trainer's B1 launch on a strided slice, the
    # cube's B2 launch); packet's phase 28's dynamic_scene frames 0-1 and
    # the morton tree's launch (strided slices); those of packet and
    # rowtrace2 phase 29's requests in this process and in the spawned
    # ranks (B1's DP launches and the first B2 launch of each ring,
    # strided slices)
    kernels = {"kernels": [{
        "name": "rowtrace2", "route": "cuda",
        "source": "embree_tpu_torch/csrc/rowtrace2.cu",
        "replaces": "embree_tpu/traverse/rowtrace2.py:153",
        "launches": Launches.totals["rowtrace2"],
        "max_abs_err": max(small_err, full_err, lane_err["rowtrace2"],
                           wt_err["rowtrace2"], inst["rowtrace2"],
                           pt_err["rowtrace2"], diff_err["rowtrace2"],
                           dist_err["rowtrace2"]),
        "ms": kernel_ms, "plain_ms": plain_ms, "plain_rays": nb1,
        "bound_ms": bound["bound_ms"], "bound_by": bound["bound_by"],
        "library_ms": None,
    }, {
        "name": "packet", "route": "cuda",
        "source": "embree_tpu_torch/csrc/packet.cu",
        "replaces": "embree_tpu/traverse/pallas_packet.py:261",
        "launches": Launches.totals["packet"],
        "max_abs_err": max(pk_small_err, pk_full_err, pk_a_err, bvh8_err,
                           lane_err["packet"], tut_pk_err, inst["packet"],
                           pt_err["packet"], diff_err["packet"], dyn_err,
                           dist_err["packet"]),
        "ms": pk_a["closest"]["ms"], "plain_ms": pk_plain_ms,
        "plain_rays": n,
        "bound_ms": pk_a["closest"]["bound"]["bound_ms"],
        "bound_by": pk_a["closest"]["bound"]["bound_by"],
        "library_ms": None,
    }, {
        "name": "cbvh", "route": "cuda",
        "source": "embree_tpu_torch/csrc/cbvh.cu",
        "replaces": "embree_tpu/traverse/pallas_cbvh.py:175",
        "launches": Launches.totals["cbvh"],
        "max_abs_err": max(cb_small_err, cb_full_err, cage_err,
                           lane_err["cbvh"], wt_err["cbvh"], demo_err,
                           tut_cb_err, inst["cbvh"]),
        "ms": cb_inc["closest"]["ms"], "plain_ms": cb_plain_ms,
        "plain_rays": nb4,
        "bound_ms": cb_inc["closest"]["bound"]["bound_ms"],
        "bound_by": cb_inc["closest"]["bound"]["bound_by"],
        "library_ms": None,
    }, {
        "name": "cbvh_occluded", "route": "cuda",
        "source": "embree_tpu_torch/csrc/cbvh.cu",
        "replaces": "embree_tpu/traverse/pallas_cbvh.py:771",
        "launches": Launches.totals["cbvh_occluded"],
        "max_abs_err": max(cbo_small_err, cbo_full_err, cage_occ_err,
                           lane_err["cbvh_occluded"],
                           wt_err["cbvh_occluded"], inst["cbvh_occluded"]),
        "ms": cb_inc["occluded"]["ms"], "plain_ms": cbo_plain_ms,
        "plain_rays": nb4,
        "bound_ms": cb_inc["occluded"]["bound"]["bound_ms"],
        "bound_by": cb_inc["occluded"]["bound"]["bound_by"],
        "library_ms": None,
    }, {
        "name": "mb", "route": "cuda",
        "source": "embree_tpu_torch/csrc/mb.cu",
        "replaces": "embree_tpu/traverse/pallas_mb.py:120",
        "launches": Launches.totals["mb"],
        "max_abs_err": max(mb_small_err, mb_full_err, lane_err["mb"]),
        "ms": mb_inc["closest"]["ms"], "plain_ms": mb_plain_ms,
        "plain_rays": nmb,
        "bound_ms": mb_inc["closest"]["bound"]["bound_ms"],
        "bound_by": mb_inc["closest"]["bound"]["bound_by"],
        "library_ms": None,
    }, {
        "name": "mb_occluded", "route": "cuda",
        "source": "embree_tpu_torch/csrc/mb.cu",
        "replaces": "embree_tpu/traverse/pallas_mb.py:120",
        "launches": Launches.totals["mb_occluded"],
        "max_abs_err": max(mbo_small_err, mbo_full_err,
                           lane_err["mb_occluded"]),
        "ms": mb_inc["occluded"]["ms"], "plain_ms": mbo_plain_ms,
        "plain_rays": nmb,
        "bound_ms": mb_inc["occluded"]["bound"]["bound_ms"],
        "bound_by": mb_inc["occluded"]["bound"]["bound_by"],
        "library_ms": None,
    }] + [{
        "name": f"hair_{leaf}{suffix}", "route": "cuda",
        "source": "embree_tpu_torch/csrc/packet.cu",
        "replaces": f"embree_tpu/traverse/pallas_hair.py:{line}",
        "launches": Launches.totals[f"hair_{leaf}{suffix}"],
        "max_abs_err": max(hair_small_err[leaf], full_err_,
                           lane_err[f"hair_{leaf}{suffix}"]),
        "ms": res[mode]["ms"], "plain_ms": plain_,
        "plain_rays": 1 << HAIR_PLAIN_LOG2,
        "bound_ms": res[mode]["bound"]["bound_ms"],
        "bound_by": res[mode]["bound"]["bound_by"],
        "library_ms": None,
    } for leaf, line, res, full_err_, plains in (
        ("cone", 41, hm_inc, hm_err, (hm_plain_ms, hmo_plain_ms)),
        ("ribbon", 79, hb_inc, hb_err, (hb_plain_ms, hbo_plain_ms)))
        for suffix, mode, plain_ in (("", "closest", plains[0]),
                                     ("_occluded", "occluded", plains[1]))]}
    for k in kernels["kernels"]:
        if k["launches"] < 1:
            raise AssertionError(f"kernel {k['name']} was never launched on "
                                 "the driven paths")

    # -- 9. result lines ------------------------------------------------------
    log("phase seconds: " + ", ".join(f"[{k}] {sec:.1f}"
                                      for k, sec in phase_seconds()))
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(card)
    log(json.dumps(kernels))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
