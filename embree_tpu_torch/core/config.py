"""Device configuration ("State") system.

Re-expresses the reference's layered config machinery
(kernels/common/state.{h,cpp} + device.cpp:60-64 config files):

  1. config string passed to ``Device("k=v,k=v")``       (state.cpp:209)
  2. ``.embree_tpu`` files in cwd then ``$HOME``          (device.cpp:62-64)
  3. ``key=value[,key=value]`` token grammar              (state.cpp:202-241)
  4. per-accel override strings (``tri_accel=...``,
     ``subdiv_accel=bvh4.compressed.{grid,leaf,box,full}``  scene.cpp:507-510)
  5. app-level flags map onto the same keys (render/tutorials CLI:
     ``--compress.*``, ``--subdLvl``, ``--compLvl``        tutorial.cpp:537-564)
  6. per-scene API state (``set_scene_levels`` = rtcSetSceneLevels,
     rtcore_scene.h:64-65) lives on Scene, not here.

Copy of embree_tpu/core/config.py (pure Python), kept here because the
port imports nothing of the JAX package. There is no ISA dispatch: one
compile target exists, so ``isa=`` keys are accepted and recorded only.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional


def _parse_bool(v: str) -> bool:
    return v.lower() in ("1", "true", "on", "yes")


def _parse_size(v: str) -> int:
    """Sizes accept K/M/G suffixes like the reference TokenStream floats."""
    v = v.strip().upper()
    mult = 1
    if v.endswith("K"):
        mult, v = 1024, v[:-1]
    elif v.endswith("M"):
        mult, v = 1024 ** 2, v[:-1]
    elif v.endswith("G"):
        mult, v = 1024 ** 3, v[:-1]
    return int(float(v) * mult)


@dataclasses.dataclass
class State:
    """Mirror of reference state.h:57-146 key set (the subset that means
    something on an accelerator).

    Unknown keys are recorded in ``unknown`` and warned about at verbose>=1,
    matching the reference's tolerant parser.
    """

    # threading / device (threads=0 -> all: host-side build threads)
    threads: int = 0
    # stands in for reference `isa=`; recorded, selects nothing yet
    isa: str = "default"
    verbose: int = 0
    benchmark: int = 0

    # per-accel overrides (state.h:57-110)
    tri_accel: str = "default"
    tri_accel_mb: str = "default"
    quad_accel: str = "default"
    hair_accel: str = "default"
    object_accel: str = "default"
    subdiv_accel: str = "default"
    subdiv_accel_mb: str = "default"
    # compressed node flavor (compressed_node.h flavors): com 4 B (paper
    # production type), non 8 B per-child planes, mid 2 B inner-only
    compressed_node: str = "com"

    # builder tuning (state.h:111-122)
    max_spatial_split_replications: float = 1.2
    tessellation_cache_size: int = 128 * 1024 * 1024

    # robustness / debug (device.cpp:81-92 float_exceptions)
    float_exceptions: bool = False
    ignore_config_files: bool = False
    hugepages: bool = False  # accepted, meaningless here
    # EMBREE_BACKFACE_CULLING analog — a runtime config key here instead
    # of a compile flag; hits with dot(Ng, dir) >= 0 are culled when on
    backface_culling: bool = False

    # host builder selection: "default"/"native" (C++), "python" (numpy)
    builder: str = "default"

    # accelerator-side additions
    packet_size: int = 1024          # rays per traversal packet
    traversal_stack_depth: int = 64  # reference bvh.h:135-137 maxDepth guidance

    unknown: dict = dataclasses.field(default_factory=dict)

    def parse_string(self, cfg: Optional[str]) -> "State":
        """Parse ``key=value,key=value`` (reference State::parseString state.cpp:209)."""
        if not cfg:
            return self
        for tok in cfg.replace("\n", ",").split(","):
            tok = tok.strip()
            if not tok:
                continue
            if "=" in tok:
                k, v = tok.split("=", 1)
                k, v = k.strip(), v.strip()
            else:
                k, v = tok, "1"
            self._set(k, v)
        return self

    def parse_file(self, path: str) -> "State":
        try:
            with open(path) as f:
                self.parse_string(f.read())
        except OSError:
            pass
        return self

    def parse_config_files(self) -> "State":
        """Reference device.cpp:60-64: exe dir then $HOME, unless suppressed."""
        if self.ignore_config_files:
            return self
        self.parse_file(os.path.join(os.getcwd(), ".embree_tpu"))
        home = os.environ.get("HOME")
        if home:
            self.parse_file(os.path.join(home, ".embree_tpu"))
        return self

    def _set(self, k: str, v: str) -> None:
        ints = {"threads", "verbose", "benchmark", "packet_size",
                "traversal_stack_depth"}
        bools = {"float_exceptions", "ignore_config_files", "hugepages",
                 "backface_culling"}
        sizes = {"tessellation_cache_size"}
        floats = {"max_spatial_split_replications"}
        strs = {"isa", "tri_accel", "tri_accel_mb", "quad_accel", "hair_accel",
                "object_accel", "subdiv_accel", "subdiv_accel_mb", "builder",
                "compressed_node"}
        if k in ints:
            setattr(self, k, int(v))
        elif k in bools:
            setattr(self, k, _parse_bool(v))
        elif k in sizes:
            setattr(self, k, _parse_size(v))
        elif k in floats:
            setattr(self, k, float(v))
        elif k in strs:
            setattr(self, k, v)
        else:
            self.unknown[k] = v
