"""Run one cell of the benchmark on this machine's card:

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. The last line of standard output is the
result object; the numbers compared with the reference, each beside its
limit, are the last lines of standard error and the result's last key.
Exits non-zero with no result when no CUDA card (or fewer than the cell
asks for) is present, and when JAX or the JAX package was loaded.
The fp8 control and the planted faults are read by ``portbench.calibrate``.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / "portbench" / ".cache"


def _env() -> None:
    """Every build and kernel cache at a fixed path inside the checkout."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(CACHE / sub)
    os.environ["USE_FLAX"] = "0"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    _env()
    import torch

    from portbench import harness, imports, spec

    bench = spec.load_json(ROOT / "BENCHMARK.json")
    chips = {w["name"]: w["chips"] for w in bench["workloads"]}.get(
        a.workload, 1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: needs {chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    result = harness.execute(a.workload, a.seed, a.seconds, bool(a.trace),
                             torch.device("cuda", 0), T_START, ROOT)
    bad = imports.forbidden_loaded()
    if bad:
        print(f"portbench: forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    for k, c in result["checks"].items():
        print(f"check {k} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
