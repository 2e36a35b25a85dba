"""The readings that a cell's limits are set from: the program's, on many
seeds, and its control's on the same rays. The control is the plain
reference put in the program's place and computed in bfloat16, the
precision below the configuration's float32; both are compared with the
reference in float32 by the configuration's readings.

    python3 rtbench/control.py --workload sphere1m.incoherent \
        --seeds 11 12 13 --seconds 2 --out control.json

One process commits the scene once, runs a short window of the cell's
own traffic a seed (the sample is drawn as in a run), frees the program,
then puts every seed's sample, and the control's answers to the same
rays, through the harness's own check. The benchmark's own runs do not
run this.
"""
import argparse
import gc
import json
import os
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


CONTROL_DTYPE = {"float32": torch.bfloat16}


def readings(workload, seeds, seconds, device="cuda:0", overrides=None):
    """{"program": [per seed checks], "control": [...], "rays": [...]}:
    the harness's own `check` of each seed's sample, and of the control's
    answer to the same rays put in the program's place."""
    from rtbench import harness

    st = harness.setup(workload, device, overrides)
    samples = []
    for seed in seeds:
        loop = harness.new_loop(st, seed)
        loop.run(seconds)
        samples.append(harness.gather_sample(
            loop.kept, int(st.check["check_rays"]), seed))
    ref_mod, limits = st.c.reference, st.check["limits"]
    st.scene = st.call = loop = None
    gc.collect()
    if st.cuda:
        torch.cuda.empty_cache()
    state = ref_mod.prepare(st.inp, st.dev)
    low = CONTROL_DTYPE[st.cfg["precision"]]
    out = {"program": [], "control": [], "rays": []}
    for sample in samples:
        ref = ref_mod.answer(state, sample, torch.float32)
        ctl = {**sample, **ref_mod.answer(state, sample, low)}
        out["program"].append(harness.check(ref_mod, state, sample, limits,
                                            ref))
        out["control"].append(harness.check(ref_mod, state, ctl, limits,
                                            ref))
        out["rays"].append(harness.sample_size(sample))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--out")
    a = ap.parse_args(argv)
    t0 = time.perf_counter()
    r = readings(a.workload, a.seeds, a.seconds)

    def values(ok_checks):
        return {k: c["value"] for k, c in ok_checks[1].items()}

    names = list(r["program"][0][1])
    summary = {n: {"program_max": max(values(p)[n] for p in r["program"]),
                   "control_min": min(values(c)[n] for c in r["control"])}
               for n in names}
    summary["program_correct"] = [p[0] for p in r["program"]]
    summary["control_correct"] = [c[0] for c in r["control"]]
    for seed, p, c, n in zip(a.seeds, r["program"], r["control"], r["rays"]):
        print(f"seed {seed} rays {n} program {p[0]} {json.dumps(values(p))} "
              f"control {c[0]} {json.dumps(values(c))}")
    print(json.dumps({"workload": a.workload, "seeds": a.seeds,
                      "summary": summary,
                      "seconds": time.perf_counter() - t0}))
    if a.out:
        with open(a.out, "w") as f:
            json.dump({"workload": a.workload, "seeds": a.seeds, **r,
                       "summary": summary}, f, indent=1)


if __name__ == "__main__":
    main()
