"""Shared lazy tessellation cache (tessellation_cache.{h,cpp} analog).

Host (numpy) copy of embree_tpu/subdiv/cache.py.

The reference keeps a global segmented-LRU cache of tessellated patch
data (SharedLazyTessellationCache, tessellation_cache.h:76-186: NUM_CACHE
_SEGMENTS=8, generation tags, size set by the `tessellation_cache_size`
device config) so lazy subdiv accels and rtcInterpolate eval trees can
recompute-on-miss instead of persisting everything.

Re-expressed for bulk builds: the expensive recomputable artifact here is the
*subdivision plan* (topology refinement stencils + patch grids —
commit-time host work, subdiv/core.py plan_subdivision), which depends
only on topology + level, not vertex positions.  Re-commits of the same
topology (dynamic vertex updates, viewer_anim, interpolate-after-commit)
hit the cache and skip straight to the vectorized stencil application.

Eviction is segmented like the reference: when over budget, the oldest
1/NUM_SEGMENTS of entries (by LRU order) is dropped at once.
"""
from __future__ import annotations

import hashlib
import threading
from collections import OrderedDict

import numpy as np

NUM_CACHE_SEGMENTS = 8  # tessellation_cache.h:76
DEFAULT_BYTES = 128 * 1024 * 1024  # state.h:114 default


class SharedLazyTessellationCache:
    def __init__(self, max_bytes: int = DEFAULT_BYTES):
        self.max_bytes = int(max_bytes)
        self._entries: OrderedDict = OrderedDict()  # key -> (bytes, value)
        self._bytes = 0
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def set_size(self, max_bytes: int) -> None:
        """Device::setCacheSize (device.cpp:78 analog)."""
        with self._lock:
            self.max_bytes = int(max_bytes)
            self._evict_locked()

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self._bytes = 0

    def _evict_locked(self) -> None:
        # drop the oldest segment-sized chunk until under budget
        while self._bytes > self.max_bytes and self._entries:
            n_drop = max(1, len(self._entries) // NUM_CACHE_SEGMENTS)
            for _ in range(n_drop):
                if not self._entries:
                    break
                _k, (b, _v) = self._entries.popitem(last=False)
                self._bytes -= b
                self.evictions += 1

    def get_or_build(self, key, build_fn, size_fn):
        """Lookup `key`; on miss call build_fn() and account
        size_fn(value) bytes (the cache_size accounting of alloc'd
        tessellation blocks)."""
        with self._lock:
            if key in self._entries:
                self._entries.move_to_end(key)
                self.hits += 1
                return self._entries[key][1]
        value = build_fn()
        nbytes = int(size_fn(value))
        with self._lock:
            self.misses += 1
            if key not in self._entries:
                self._entries[key] = (nbytes, value)
                self._bytes += nbytes
                self._evict_locked()
        return value

    @property
    def bytes_used(self) -> int:
        return self._bytes


_GLOBAL = SharedLazyTessellationCache()


def global_cache() -> SharedLazyTessellationCache:
    return _GLOBAL


def topology_key(face_counts, face_indices, num_vertices, level,
                 edge_creases=None, edge_crease_weights=None,
                 vertex_creases=None, vertex_crease_weights=None) -> str:
    """Content hash of everything plan_subdivision depends on."""
    h = hashlib.sha1()
    h.update(np.int64(level).tobytes())
    h.update(np.int64(num_vertices).tobytes())
    for a in (face_counts, face_indices, edge_creases,
              edge_crease_weights, vertex_creases, vertex_crease_weights):
        if a is None:
            h.update(b"\x00")
        else:
            arr = np.ascontiguousarray(a)
            h.update(str(arr.dtype).encode())
            h.update(arr.tobytes())
    return h.hexdigest()


def plan_nbytes(plan) -> int:
    """Rough byte accounting of a SubdivisionPlan + grids."""
    total = 0
    for lv in plan.levels:
        for f in lv.__dict__.values() if hasattr(lv, "__dict__") else []:
            if isinstance(f, np.ndarray):
                total += f.nbytes
        # NamedTuple levels
        if hasattr(lv, "_fields"):
            for name in lv._fields:
                f = getattr(lv, name)
                if isinstance(f, np.ndarray):
                    total += f.nbytes
    fq = getattr(plan, "final_quads", None)
    if isinstance(fq, np.ndarray):
        total += fq.nbytes
    return max(total, 1024)
