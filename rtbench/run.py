"""Run one cell of the benchmark of `embree_tpu_torch` on this machine's
card and print its result as the last line of standard output.

    python3 rtbench/run.py --workload sphere1m.incoherent --seed 7 \
        --seconds 10 --trace 0

`--trace 1` runs the window under torch.profiler and reports the cell's
per-layer metrics instead of its end-to-end ones. The run exits non-zero
and prints no result when there is no CUDA device, when the program or
its check fails, or when JAX or the JAX package is loaded. See
`rtbench/harness.py` for what a run does and `PERF.md` for the cells.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

# the program builds its CUDA libraries into embree_tpu_torch/_build/ and
# its native SAH builder beside it, inside the checkout at fixed paths
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)

    import torch
    from rtbench import harness

    bench = harness.load_json("BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if a.workload not in cells:
        print(f"no workload {a.workload!r}", file=sys.stderr)
        return 2
    chips = int(cells[a.workload]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{a.workload} needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    res = harness.run(a.workload, a.seed, a.seconds, bool(a.trace),
                      device="cuda:0", t_start=T_START)
    banned = harness.banned_modules()
    if banned:
        print(f"loaded in the result's process: {', '.join(banned)}",
              file=sys.stderr)
        return 4
    print("diagnostics " + json.dumps(res["diagnostics"]), file=sys.stderr)
    for name, c in res["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(f"correct {res['correct']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
