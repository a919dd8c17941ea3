"""Readings for the limits of ``correct``, many seeds in one process on the
card: sound runs of a cell, the fp8 control beside some of them, and the
planted faults of ``portbench/faults.py``:

    python3 -m portbench.calibrate --workload <cell> --seeds 1,2,3 \\
        [--control-seeds 1,2] [--faults frozen_step,half_batch] \\
        [--fault-seeds 4,5,6] [--seconds 3] [--out FILE]

Each run goes through the harness as a benchmark run does (set-up, a short
window, the reference) and prints one JSON line: the seed, what ran
(``sound``, ``control`` or the fault's name), ``correct`` and each number
compared with its limit, and, for a control run, the control's numbers
and whether they would pass as ``correct`` (they must not).
Lines go to standard output and, with ``--out``, to that file too. The
benchmark's own runs never run this."""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402


def _seeds(text: str) -> list:
    return [int(x) for x in text.split(",") if x]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--faults", default="")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--out", default=None)
    a = ap.parse_args(argv)
    from portbench import run as bench_run

    bench_run._env()
    import torch

    from portbench import faults, harness

    if not torch.cuda.is_available():
        print("portbench.calibrate: needs a CUDA card", file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    dev = torch.device("cuda", 0)
    ctl = set(_seeds(a.control_seeds))
    jobs = [(s, "control" if s in ctl else "sound") for s in _seeds(a.seeds)]
    jobs += [(s, "control") for s in sorted(ctl - set(_seeds(a.seeds)))]
    jobs += [(s, f) for f in a.faults.split(",") if f
             for s in _seeds(a.fault_seeds)]
    out = open(a.out, "a") if a.out else None
    for seed, what in jobs:
        t0 = time.perf_counter()
        if what in ("sound", "control"):
            res = harness.execute(a.workload, seed, a.seconds, False, dev, t0,
                                  bench_run.ROOT, control=what == "control")
        else:
            with faults.planted(what):
                res = harness.execute(a.workload, seed, a.seconds, False, dev,
                                      t0, bench_run.ROOT)
        line = {"workload": a.workload, "seed": seed, "run": what,
                "correct": res["correct"],
                "checks": {k: c["value"] for k, c in res["checks"].items()},
                "limits": {k: c["limit"] for k, c in res["checks"].items()},
                "control": res["notes"].get("control"),
                "control_correct": res["notes"].get("control_correct"),
                "memory_peak_bytes": res["device"]["memory_peak_bytes"],
                "setup_peak_bytes": res["notes"]["setup_peak_bytes"],
                "ref_s": res["notes"].get("ref_s"),
                "seconds": time.perf_counter() - t0}
        print(json.dumps(line), flush=True)
        if out:
            out.write(json.dumps(line) + "\n")
            out.flush()
        del res
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
