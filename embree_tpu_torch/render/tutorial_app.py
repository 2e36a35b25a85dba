"""Tutorial application framework: CLI, benchmark loop, render-to-file.

Counterpart of embree_tpu/render/tutorial_app.py, the analog of
tutorials/common/tutorial/tutorial.cpp. Reproduces:

  * the option registry / CLI grammar incl. the fork's flags
    (--compress.{grid,leaf,box,ref}, --subdLvl, --compLvl; tutorial.cpp
    :537-564, defaults subdLvl=5 compLvl=2 :65-66, clamp compLvl<=subdLvl
    :730-733), --size, --vp/--vi/--vu/--fov, -o, --benchmark N M, --rtcore
  * renderBenchmark (tutorial.cpp:601-700): skip N warmup frames, measure
    M, emit the greppable BENCHMARK_RENDER_{MIN,AVG,MAX,SIGMA,AVG_SIGMA}
    and BENCHMARK_RENDER_MRAYPS_* keys
  * RayStats Mray/s accounting (tutorial_device.h:151-173): +1 per
    primary/shadow ray traced (we count rays analytically per frame)

A tutorial provides `build_scene(app) -> state` and
`render_frame(state, camera, (W, H)) -> (img_f32 tensor, nrays)`; the
application waits for the device (`torch.cuda.synchronize()`) inside every
timed frame, so the timings are of finished frames.

`-rtcore` carries the Device config string: the tutorials run on the
CUDA device unless it says `device=cpu`. The fork's `--compress.*` flags
end up as `args.subdiv_mode`, the `subdiv_accel` value a tutorial with
subdivision surfaces commits under (`--compress.ref`, also spelled
`--compress.full`, is the full-precision reference mode). `--subdLvl`
and `--compLvl` are parsed and clamped; `viewer` and
`subdivision_geometry` commit at them, `displacement_geometry` fixes its
own levels as the reference does.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from .camera import Camera
from .image import to_u8, write_ppm


class TutorialApplication:
    def __init__(self, name: str, build_scene, render_frame,
                 default_size=(512, 512)):
        self.name = name
        self.build_scene = build_scene
        self.render_frame = render_frame
        self.default_size = default_size
        self.camera = Camera()

    def make_parser(self) -> argparse.ArgumentParser:
        # the reference registers single-dash long options (-vp, -size,
        # -rtcore; tutorial.cpp option registry) — accept both spellings
        p = argparse.ArgumentParser(prog=self.name)
        p.add_argument("-size", "--size", nargs=2, type=int,
                       default=list(self.default_size))
        p.add_argument("-vp", "--vp", nargs=3, type=float,
                       help="camera position")
        p.add_argument("-vi", "--vi", nargs=3, type=float,
                       help="camera look-at")
        p.add_argument("-vd", "--vd", nargs=3, type=float,
                       help="camera view direction (to = from + dir)")
        p.add_argument("-vu", "--vu", nargs=3, type=float, help="camera up")
        p.add_argument("-fov", "--fov", type=float)
        p.add_argument("-lefthanded", "--lefthanded", action="store_true")
        p.add_argument("-righthanded", "--righthanded", action="store_true")
        p.add_argument("-o", "--output", type=str, default=None)
        p.add_argument("-c", "--command-file", type=str, default=None,
                       help=".ecs command file (options, one or more per "
                            "line; '#' comments) — tutorial.cpp -c")
        p.add_argument("-benchmark", "--benchmark", nargs=2, type=int,
                       metavar=("SKIP", "ITER"))
        p.add_argument("-rtcore", "--rtcore", type=str, default="",
                       help="device config string")
        # fork flags (tutorial.cpp:537-564)
        p.add_argument("--compress.grid", dest="compress_grid", action="store_true")
        p.add_argument("--compress.leaf", dest="compress_leaf", action="store_true")
        p.add_argument("--compress.box", dest="compress_box", action="store_true")
        p.add_argument("--compress.ref", "--compress.full",
                       dest="compress_ref", action="store_true")
        p.add_argument("--subdLvl", type=int, default=5)
        p.add_argument("--compLvl", type=int, default=2)
        return p

    @staticmethod
    def _expand_ecs(argv):
        """Inline -c FILE contents (the .ecs command scripts the
        reference demos ship, e.g. build/bomberman.ecs). Relative input
        paths inside the file resolve against the file's directory
        (FileName::path() semantics in the reference parser)."""
        import os
        out = []
        i = 0
        argv = list(argv)
        while i < len(argv):
            if argv[i] in ("-c", "--command-file") and i + 1 < len(argv):
                base = os.path.dirname(os.path.abspath(argv[i + 1]))
                with open(argv[i + 1]) as f:
                    toks = []
                    for line in f:
                        line = line.split("#", 1)[0].strip()
                        if line:
                            toks.extend(line.split())
                for k, t in enumerate(toks):
                    if (k and toks[k - 1] in ("-i", "--input")
                            and not os.path.isabs(t)):
                        t = os.path.join(base, t)
                    out.append(t)
                i += 2
            else:
                out.append(argv[i])
                i += 1
        return out

    def parse(self, argv):
        argv = self._expand_ecs(argv)
        args = self.make_parser().parse_args(argv)
        # clamping per tutorial.cpp:558-564,730-733
        args.subdLvl = max(args.subdLvl, 2)
        args.compLvl = min(max(args.compLvl, 1), 4, args.subdLvl)
        args.subdiv_mode = None
        for mode in ("grid", "leaf", "box", "ref"):
            if getattr(args, f"compress_{mode}"):
                args.subdiv_mode = f"bvh4.compressed.{'full' if mode == 'ref' else mode}"
        if args.vp:
            self.camera.from_ = tuple(args.vp)
        if args.vi:
            self.camera.to = tuple(args.vi)
        if args.vd:  # view direction form (tutorial.cpp -vd)
            f = self.camera.from_ if args.vp is None else tuple(args.vp)
            self.camera.to = tuple(f[k] + args.vd[k] for k in range(3))
        if args.vu:
            self.camera.up = tuple(args.vu)
        if args.fov:
            self.camera.fov = args.fov
        if args.lefthanded:
            self.camera.right_handed = False
        return args

    def run(self, argv=None) -> int:
        args = self.parse(argv if argv is not None else sys.argv[1:])
        self.args = args
        w, h = args.size
        state = self.build_scene(self)
        if args.benchmark:
            self.render_benchmark(state, w, h, *args.benchmark)
        img, _ = self._render_once(state, w, h)
        if args.output:
            write_ppm(args.output, to_u8(img))
            print(f"wrote {args.output}")
        return 0

    def _render_once(self, state, w, h):
        img, nrays = self.render_frame(state, self.camera, (w, h))
        return img.cpu().numpy(), int(nrays)

    def _render_device(self, state, w, h):
        """Render and wait for the device WITHOUT pulling the
        framebuffer to the host — the reference benchmark loop measures
        device_render only (tutorial.cpp:601-700)."""
        img, nrays = self.render_frame(state, self.camera, (w, h))
        if img.device.type == "cuda":
            torch.cuda.synchronize(img.device)
        return int(nrays)

    def render_benchmark(self, state, w, h, skip: int, iters: int) -> dict:
        """tutorial.cpp:601-700 renderBenchmark."""
        for _ in range(max(skip, 1)):
            self._render_device(state, w, h)  # warmup incl. kernel build

        dts, rays = [], []
        for _ in range(iters):
            t0 = time.perf_counter()
            nrays = self._render_device(state, w, h)
            dts.append(time.perf_counter() - t0)
            rays.append(nrays)
        dts = np.asarray(dts)
        fps = 1.0 / dts
        mrayps = np.asarray(rays) / dts * 1e-6
        out = {
            "BENCHMARK_RENDER_MIN": float(fps.min()),
            "BENCHMARK_RENDER_AVG": float(fps.mean()),
            "BENCHMARK_RENDER_MAX": float(fps.max()),
            "BENCHMARK_RENDER_SIGMA": float(fps.std()),
            "BENCHMARK_RENDER_AVG_SIGMA": float(fps.std() / np.sqrt(len(dts))),
            "BENCHMARK_RENDER_MRAYPS_MIN": float(mrayps.min()),
            "BENCHMARK_RENDER_MRAYPS_AVG": float(mrayps.mean()),
            "BENCHMARK_RENDER_MRAYPS_MAX": float(mrayps.max()),
            "BENCHMARK_RENDER_MRAYPS_SIGMA": float(mrayps.std()),
        }
        for k, v in out.items():
            print(f"{k} {v:.6g}")
        return out
