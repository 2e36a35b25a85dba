"""The benchmark of `embree_tpu_torch` on one card: set-up, the measured
closed loop, the traced run, the check against the plain reference and
the result line.

Everything that belongs to one configuration, traffic mix, entry, scene
or per-layer metric lives in a file of its own, found by the name that
`BENCHMARK.json` (or the configuration) gives:

  rtbench/configs/<config>.json          sizes, source, scene, camera
  rtbench/traffic/<mix>.json             generator, sizes, entry, inflight
  rtbench/generators/<generator>.py      a request's inputs from (seed, i)
  rtbench/scenes/<scene>.py              the scene's inputs and commit
  rtbench/entries/<entry>.py             what one request calls; its QUERY
  rtbench/reference/<scene>.<query>.py   the plain reference of that
                                         query on that scene; readings
  rtbench/limits/<config>.<query>.json   the check's sample size and the
                                         readings' limits
  rtbench/metrics/<metric>.py            a per-layer metric's reader

A run makes the scene's inputs, commits them through the program, warms
up the cell's own request shape, then keeps `inflight` requests in
flight for the window: request i + 1 is enqueued before request i is
waited for. A request's latency runs from the moment the host starts
making its inputs to the moment the host sees the CUDA event recorded
after it complete. During the window a sample of the requests' inputs
and answers is kept (drawn from the seed); once the window has closed,
the peak memory read and the program's state freed, the plain reference
answers the same inputs and `correct` says whether every reading is
within its limit (rtbench/limits/).
"""
from __future__ import annotations

import collections
import gc
import importlib.util
import json
import math
import os
import re
import sys
import time
from types import SimpleNamespace

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, "rtbench")
WARMUP_REQUESTS = 3
TRACE_SECONDS = 2.0          # longest traced window
BANNED = ("jax", "jaxlib", "flax", "embree_tpu")
WARMUP_INDEX = 1 << 40       # request indices of the warm-up, apart


def load_json(rel: str) -> dict:
    with open(os.path.join(ROOT, rel)) as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """rtbench/<kind>/<name>.py as a module (names may hold dots)."""
    path = os.path.join(HERE, kind, f"{name}.py")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no {kind} named {name!r} ({path})")
    mod_name = f"rtbench.{kind}.{name.replace('.', '_')}"
    spec = importlib.util.spec_from_file_location(
        mod_name, path, submodule_search_locations=None)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod


def metric_readers() -> dict:
    """Every per-layer reader in rtbench/metrics/, by metric name (the
    traversal kernels are those any reader names as its `KERNEL`)."""
    folder = os.path.join(HERE, "metrics")
    return {f[:-3]: load_module("metrics", f[:-3])
            for f in sorted(os.listdir(folder)) if f.endswith(".py")}


def resolve(bench: dict, workload: str) -> SimpleNamespace:
    """The cell `workload` with its configuration, traffic, generator,
    scene, entry, reference and per-layer metric modules."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    cfg = load_json(cfg_entry["file"])
    traffic = load_json(os.path.join("rtbench", "traffic",
                                     cell["traffic"] + ".json"))
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or workload in m["workloads"]]
    layer = [m for m in bench["per_layer"]
             if "workloads" not in m or workload in m["workloads"]]
    entry = load_module("entries", traffic["entry"])
    return SimpleNamespace(
        cell=cell, cfg=cfg, traffic=traffic, e2e=e2e, layer=layer,
        check=load_json(os.path.join("rtbench", "limits",
                                     f"{cell['config']}.{entry.QUERY}.json")),
        generator=load_module("generators", traffic["generator"]),
        scene=load_module("scenes", cfg["scene"]), entry=entry,
        reference=load_module("reference", f"{cfg['scene']}.{entry.QUERY}"),
        readers=metric_readers())


# -- device helpers (no card: the CPU, for tests only) --------------------

class _NoEvent:
    def record(self):
        pass

    def synchronize(self):
        pass


def _event(dev):
    return torch.cuda.Event() if dev.type == "cuda" else _NoEvent()


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def banned_modules() -> list:
    """Top-level module names in sys.modules that the run may not load."""
    tops = {m.split(".")[0] for m in list(sys.modules)}
    return sorted(t for t in tops if t in BANNED)


# -- the loop --------------------------------------------------------------

class Loop:
    """The closed loop of one run: makes, calls and waits for requests,
    keeps their latencies, entry spans and the sampled answers."""

    def __init__(self, gen, call, entry, traffic, dev, seed):
        self.gen, self.call, self.entry = gen, call, entry
        self.dev = dev
        self.inflight = int(traffic["inflight"])
        self.every = int(traffic["sample_every"])
        self.per = int(traffic["sample_rays"])
        self.rng = np.random.default_rng([int(seed), 7])
        self.kept = []
        self.reset()

    def reset(self):
        """Clears the window's counts and spans (not the kept sample)."""
        self.lat, self.entry_s = [], []
        self.done_rays = self.requests = self.failed = 0

    def one(self, index, keep):
        """Enqueue request `index`; returns (t_start, event, rays)."""
        rf = torch.profiler.record_function
        ts = time.perf_counter()
        with rf("rtbench.generate"):
            req = self.gen.request(index)
            idx = self.gen.sample(self.per) if keep else None
        te = time.perf_counter()
        with rf("rtbench.entry"):
            ans = self.call(req)
        self.entry_s.append(time.perf_counter() - te)
        ev = _event(self.dev)
        ev.record()
        if not self.entry.well_formed(ans, req):
            self.failed += 1
        elif keep:
            with rf("rtbench.sample"):
                self.kept.append(self.entry.keep(req, ans, idx))
        return ts, ev, self.gen.n

    def run(self, seconds):
        """Requests 0, 1, ... for `seconds`, then drained; returns the
        window's wall seconds (first enqueue to last completion)."""
        pending = collections.deque()
        t0 = time.perf_counter()
        t_end = t0 + seconds
        i = 0
        while time.perf_counter() < t_end:
            # the window's first request and one in `every` besides
            keep = i == 0 or int(self.rng.integers(self.every)) == 0
            pending.append(self.one(i, keep))
            i += 1
            while len(pending) >= self.inflight:
                self._finish(pending.popleft())
        while pending:
            self._finish(pending.popleft())
        return time.perf_counter() - t0

    def _finish(self, item):
        ts, ev, n = item
        with torch.profiler.record_function("rtbench.wait"):
            ev.synchronize()
        self.lat.append(time.perf_counter() - ts)
        self.done_rays += n
        self.requests += 1


# -- the traced run ----------------------------------------------------------

def _merge(iv):
    """Union of (start, end) intervals, sorted."""
    out = []
    for s, e in sorted(iv):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def reduce_trace(events):
    """What the readers need from the profiler's events: device seconds
    by kernel or op name, busy seconds, the traced window, the longest
    idle gaps labelled by what the host was doing. `events` is a list of
    (name, is_device, start_us, end_us)."""
    win = [(s, e) for n, dv, s, e in events
           if not dv and n == "rtbench.window"]
    if not win:
        return None
    w0, w1 = win[0]
    dev_iv = [(max(s, w0), min(e, w1)) for n, dv, s, e in events
              if dv and e > w0 and s < w1]
    by_name = collections.Counter()
    for n, dv, s, e in events:
        if dv and e > w0 and s < w1:
            by_name[n] += (min(e, w1) - max(s, w0)) * 1e-6
    busy = _merge(dev_iv)
    busy_s = sum(e - s for s, e in busy) * 1e-6
    gaps = []
    prev = w0
    for s, e in busy + [[w1, w1]]:
        if s > prev:
            gaps.append((s - prev, prev))
        prev = max(prev, e)
    gaps.sort(reverse=True)
    host = sorted((s, e, n) for n, dv, s, e in events
                  if not dv and n != "rtbench.window")
    idle = []
    for length, at in gaps[:10]:
        covering = [(e - s, n) for s, e, n in host if s <= at < e]
        ours = [n for _, n in sorted(covering, reverse=True)
                if n.startswith("rtbench.")]
        inner = min(covering)[1] if covering else "none"
        label = (ours[0] + " / " if ours and ours[0] != inner else "") + inner
        idle.append([label, length * 1e-6])
    return SimpleNamespace(
        window_s=(w1 - w0) * 1e-6, busy_s=busy_s, device_s=dict(by_name),
        device_ops=[[n, s] for n, s in by_name.most_common(10)],
        idle_gaps=idle)


def profile_events(prof):
    """(name, is_device, start_us, end_us) of every profiled event but
    the harness's own spans mirrored on the device's timeline. Reads the
    profiler's raw results: building its event tree (`prof.events()`)
    costs tens of seconds for a window of thousands of requests."""
    from torch.autograd import DeviceType
    out = []
    for e in prof.profiler.kineto_results.events():
        on_device = e.device_type() == DeviceType.CUDA
        if on_device and (e.is_user_annotation()
                          or e.name().startswith("rtbench.")):
            continue
        s0 = e.start_ns() * 1e-3
        out.append((e.name(), on_device, s0, s0 + e.duration_ns() * 1e-3))
    return out


def traced_window(loop, seconds):
    from torch.profiler import ProfilerActivity, profile, record_function
    acts = [ProfilerActivity.CPU]
    if loop.dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        with record_function("rtbench.window"):
            wall = loop.run(seconds)
            _sync(loop.dev)
    t0 = time.perf_counter()
    tr = reduce_trace(profile_events(prof))
    if tr is not None:
        tr.reduce_s = time.perf_counter() - t0
    return wall, tr


# -- metrics -----------------------------------------------------------------

class LayerContext(SimpleNamespace):
    """What a per-layer reader reads (see rtbench/metrics/)."""

    def kernel_seconds(self, kernel: str):
        """Device seconds of the kernels whose name holds `kernel` as a
        word, over the traced window; None where none ran."""
        if self.trace is None:
            return None
        pat = re.compile(r"\b" + re.escape(kernel) + r"\b")
        hits = [s for n, s in self.trace.device_s.items() if pat.search(n)]
        return sum(hits) if hits else None


def commit_seconds() -> float:
    from embree_tpu_torch.core.profile import global_profiler
    return float(sum(sum(v) for k, v in global_profiler().samples.items()
                     if k.startswith("scene.")))


def peak_bandwidth(kind: str):
    peaks = load_json(os.path.join("rtbench", "peaks.json"))["devices"]
    return peaks[kind]["bytes_per_s"] if kind in peaks else None


# -- the check ---------------------------------------------------------------

def sample_size(sample) -> int:
    return int(next(iter(sample.values())).shape[0])


def gather_sample(kept, count, seed):
    """At most `count` of the kept rays, drawn from the seed: dict of
    concatenated tensors."""
    if not kept:
        return None
    cat = {k: torch.cat([o[k] for o in kept]) for k in kept[0]}
    n = sample_size(cat)
    if n > count:
        rng = np.random.default_rng([int(seed), 11])
        sel = torch.as_tensor(np.sort(rng.choice(n, count, replace=False)),
                              device=next(iter(cat.values())).device)
        cat = {k: v[sel] for k, v in cat.items()}
    return cat


def check(ref_mod, state, sample, limits, ref=None):
    """Readings of the answers in `sample` against the reference's answer
    to the same inputs (`ref`, or computed here), each with its limit;
    (correct, checks)."""
    if ref is None:
        ref = ref_mod.answer(state, sample, torch.float32)
    readings = ref_mod.compare(sample, ref)
    checks = {k: {"value": float(v), "limit": float(limits[k])}
              for k, v in readings.items()}
    ok = set(readings) == set(limits) and all(
        math.isfinite(c["value"]) and c["value"] <= c["limit"]
        for c in checks.values())
    return ok, checks


# -- one run -----------------------------------------------------------------

def setup(workload: str, device: str = "cuda", overrides=None,
          loop_hook=None) -> SimpleNamespace:
    """The cell's inputs made and committed through the program, and its
    entry. `overrides` ({"params": {...}, "traffic": {...}, "check":
    {...}}) shrinks a cell for the CPU tests; `loop_hook(call) -> call`
    wraps the timed entry (the tests' faults)."""
    dev = torch.device(device)
    c = resolve(load_json("BENCHMARK.json"), workload)
    cfg, traffic, chk = dict(c.cfg), dict(c.traffic), dict(c.check)
    if overrides:
        cfg["params"] = {**cfg["params"], **overrides.get("params", {})}
        traffic.update(overrides.get("traffic", {}))
        chk.update(overrides.get("check", {}))
    inp = c.scene.inputs(cfg["params"], ROOT)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.set_device(dev)
    mem0 = torch.cuda.memory_allocated(dev) if cuda else 0
    scene = c.scene.commit(inp, cfg, device)
    _sync(dev)
    scene_bytes = (torch.cuda.memory_allocated(dev) - mem0) if cuda else None
    call = c.entry.make(scene, traffic)
    if loop_hook is not None:
        call = loop_hook(call)
    return SimpleNamespace(c=c, cfg=cfg, traffic=traffic, check=chk, inp=inp,
                           box=c.scene.bounds(inp), dev=dev, cuda=cuda,
                           scene=scene, scene_bytes=scene_bytes,
                           commit_s=commit_seconds(), call=call)


def new_loop(s, seed: int) -> Loop:
    """A loop over the cell's requests for `seed`, its shapes warmed up."""
    gen = s.c.generator.make(s.traffic, s.cfg, s.box, seed, s.dev)
    loop = Loop(gen, s.call, s.c.entry, s.traffic, s.dev, seed)
    for k in range(WARMUP_REQUESTS):
        loop.one(WARMUP_INDEX + k, True)   # the sample's ops warm up too
    _sync(s.dev)
    loop.reset()
    loop.kept = []
    return loop


def run(workload: str, seed: int, seconds: float, trace: bool,
        device: str = "cuda", t_start: float = None, overrides=None,
        loop_hook=None) -> dict:
    """One run of `workload`; returns the result line as a dict."""
    t_start = time.perf_counter() if t_start is None else t_start
    s = setup(workload, device, overrides, loop_hook)
    c, dev, cuda = s.c, s.dev, s.cuda
    loop = new_loop(s, seed)
    setup_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    setup_s = time.perf_counter() - t_start

    tr = None
    if trace:
        # the entry's host time from a window without the profiler, whose
        # own cost per op would read as the entry's; then the traced one
        short = min(seconds, TRACE_SECONDS)
        loop.run(short)
        entry_s, untraced = list(loop.entry_s), loop.requests
        attempted, failed = loop.requests, loop.failed
        loop.reset()
        window_s, tr = traced_window(loop, short)
    else:
        window_s = loop.run(seconds)
        entry_s, attempted, failed = [], 0, 0
    _sync(dev)
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0

    metrics = {}
    if not trace:
        lat_ms = np.asarray(loop.lat) * 1e3
        values = {"mrays_s": loop.done_rays / window_s / 1e6,
                  "request_p95_ms": float(np.percentile(lat_ms, 95)),
                  "setup_s": setup_s}
        if cuda:
            values["peak_mem_mb"] = peak / 1e6
        for m in c.e2e:
            if m["name"] in values:
                metrics[m["name"]] = {"value": values[m["name"]],
                                      "unit": m["unit"]}
    else:
        kind = torch.cuda.get_device_name(dev) if cuda else "cpu"
        ctx = LayerContext(
            trace=tr, requests=loop.requests, rays=loop.gen.n,
            entry_s=entry_s, commit_s=s.commit_s,
            scene_bytes=s.scene_bytes,
            geometry_bytes=c.scene.geometry_bytes(s.inp),
            peak_bytes_per_s=peak_bandwidth(kind) if cuda else None,
            traversal_kernels=sorted({r.KERNEL for r in c.readers.values()
                                      if hasattr(r, "KERNEL")}))
        for m in c.layer:
            v = c.readers[m["name"]].read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}

    attempted += loop.requests
    failed += loop.failed
    sample = gather_sample(loop.kept, int(s.check["check_rays"]), seed)
    diag = {"window_s": window_s, "commit_s": s.commit_s,
            "setup_s": setup_s, "requests": attempted}
    if tr is not None:
        diag["trace_reduce_s"] = tr.reduce_s
        diag["untraced_requests"] = untraced
    s.scene = s.call = loop = None
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    if sample is None:
        correct, checks = False, {}
    else:
        state = c.reference.prepare(s.inp, dev)
        correct, checks = check(c.reference, state, sample,
                                s.check["limits"])
        diag["checked_rays"] = sample_size(sample)
        if "valid" in sample:
            diag["hit_share"] = float(sample["valid"].float().mean())
    diag["reference_s"] = time.perf_counter() - t0
    correct = correct and failed == 0 and attempted > 0

    result = {"correct": bool(correct), "attempted": attempted,
              "failed": failed, "metrics": metrics,
              "device": {
                  "platform": "gpu" if cuda else "cpu",
                  "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
                  "count": 1,
                  "memory_peak_bytes": int(max(setup_peak, peak))}}
    if trace and tr is not None:
        result["device"]["busy_s"] = tr.busy_s
        result["device"]["window_s"] = tr.window_s
        result["breakdown"] = {"device_ops": tr.device_ops,
                               "idle_gaps": tr.idle_gaps}
    result["diagnostics"] = diag
    result["checks"] = checks
    return result
