"""One run of one cell: the traffic driver named by the cell's traffic mix
runs set-up, the measured window and the check against the reference; this
module turns what it returns into the result line."""

from __future__ import annotations

import dataclasses
import gc
import math
import time

import torch

from portbench import spec
from portbench.spec import Cell


@dataclasses.dataclass
class Run:
    """What a traffic driver is handed: the cell, the run's settings, and
    the clock of set-up."""
    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    t_start: float  # perf_counter at process start
    control: bool = False
    setup_s: float | None = None
    setup_peak: int = 0  # bytes: the peak of set-up, before the window's
    laps: dict = dataclasses.field(default_factory=dict)

    def lap(self, name: str) -> None:
        """Note the seconds since process start at a step of set-up."""
        self.sync()
        self.laps[name] = time.perf_counter() - self.t_start

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def mark_setup(self) -> None:
        """The end of set-up: the card idle, every shape warm. The peak of
        memory starts again here, so ``memory_peak`` is the window's."""
        self.sync()
        self.setup_s = time.perf_counter() - self.t_start
        self.setup_peak = self.memory_peak()
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)

    def memory_peak(self) -> int:
        """Bytes allocated at the peak since set-up ended (since the
        process started, before that)."""
        if self.device.type != "cuda":
            return 0
        return int(torch.cuda.max_memory_allocated(self.device))

    def free(self) -> None:
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def _passes(values: dict, limits: dict) -> bool:
    """``correct``: every number finite and at or below its limit."""
    return all(math.isfinite(v) and v <= limits[k] for k, v in values.items())


def execute(name: str, seed: int, seconds: float, trace: bool,
            device: torch.device, t_start: float, root=spec.ROOT,
            control: bool = False) -> dict:
    """The result object of one run (``checks`` last), plus ``control``
    readings when ``control`` is set."""
    cell = spec.load_cell(name, root)
    r = Run(cell=cell, seed=seed, seconds=seconds, trace=trace,
            device=device, t_start=t_start, control=control)
    out = spec.driver(cell.traffic["kind"]).run(r)
    out["e2e"]["setup_s"] = r.setup_s
    metrics = {}
    if trace:
        for m in cell.per_layer:
            v = spec.reader(spec.quantity(m["name"])).read(out["obs"])
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            q = spec.quantity(m["name"])
            if q not in out["e2e"] and device.type != "cuda":
                continue  # a CPU run has no device timings
            metrics[m["name"]] = {"value": out["e2e"][q], "unit": m["unit"]}
    checks = {k: {"value": v, "limit": cell.limits[k]}
              for k, v in out["checks"].items()}
    correct = _passes(out["checks"], cell.limits)
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": 1, "memory_peak_bytes": out["memory_peak_bytes"]}
    result = {"correct": correct, "attempted": out["attempted"],
              "failed": out["failed"], "metrics": metrics, "device": dev}
    if trace:
        t = out["obs"]["trace"]
        dev["busy_s"], dev["window_s"] = t.busy_s, t.window_s
        result["breakdown"] = t.breakdown()
    extra = {k: out[k] for k in ("judged_tokens", "agree", "ref_s") if k in out}
    extra["setup_laps"] = r.laps
    extra["setup_peak_bytes"] = r.setup_peak
    if control:
        extra["control"] = out["control"]
        extra["control_correct"] = _passes(out["control"], cell.limits)
    result["notes"] = extra
    result["checks"] = checks
    return result
