"""Profiling and observability helpers (counterpart of
``shadowkv_tpu/utils/profiling.py``).

- ``time_fn``: wall-clock seconds per call, the card synchronized;
- ``trace``: a context manager around ``torch.profiler`` (CPU activity,
  and CUDA activity when a card is present) that yields the profiler and,
  given a directory, writes its Chrome trace there; ``top_ops`` and
  ``op_table`` parse the newest trace of a directory into per-op time
  tables, ``print_op_table`` prints one;
- ``program_table``: per-program device totals. JAX's rows are its jitted
  programs; the port's compiled unit is a replayed CUDA graph
  (``models/graphs.py``), so here a row is the device time of the kernels
  that one ``cudaGraphLaunch`` ran, summed over its replays; a trace with
  no replays (eager steps, the CPU) has no rows;
- ``busy_seconds`` / ``top_kernels``: the device-busy time (the union of
  the kernels' intervals) and the top device ops of a live profiler;
- ``device_memory_stats``: the card's allocator statistics, ``{}`` on a
  machine without one.

Op tables read the trace's device events: kernels, copies and memsets on
the card. A trace without any (a CPU run) uses its CPU operators instead,
so the same tables serve the CPU tests. Torch traces carry no byte or flop
counts, so ``gbytes``, ``gbps`` and ``gflops`` are 0 in every row.
"""

from __future__ import annotations

import collections
import contextlib
import glob
import gzip
import json
import os
import time
from typing import Callable, Optional

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def time_fn(fn: Callable, *args, n: int = 20, warmup: int = 3) -> float:
    """Mean wall-clock seconds per call (the card synchronized before the
    clock starts and after the last call)."""
    for _ in range(warmup):
        fn(*args)
    _sync()
    t0 = time.perf_counter()
    for _ in range(n):
        fn(*args)
    _sync()
    return (time.perf_counter() - t0) / n


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None):
    """Profile a region: ``with trace('/tmp/tr') as prof: step(...)``.
    With ``log_dir`` the Chrome trace goes to
    ``<log_dir>/trace_<ns>.json`` (read by ``top_ops`` / ``op_table``)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.__enter__()
    try:
        yield prof
        _sync()
    finally:
        prof.__exit__(None, None, None)
    if log_dir is not None:
        os.makedirs(log_dir, exist_ok=True)
        prof.export_chrome_trace(
            os.path.join(log_dir, f"trace_{time.time_ns()}.json"))


def _newest_events(log_dir: str) -> list[dict]:
    paths = glob.glob(os.path.join(log_dir, "trace_*.json")) + glob.glob(
        os.path.join(log_dir, "trace_*.json.gz"))
    if not paths:
        return []
    path = max(paths, key=os.path.getmtime)
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        data = json.load(f)
    return [e for e in data.get("traceEvents", []) if e.get("ph") == "X"]


def top_ops(log_dir: str, limit: int = 25) -> list[tuple[float, int, str]]:
    """Every complete event of the newest trace in ``log_dir``, by name:
    [(total_ms, count, name)] sorted by total time."""
    dur = collections.Counter()
    cnt = collections.Counter()
    for e in _newest_events(log_dir):
        dur[e.get("name", "?")] += e.get("dur", 0)
        cnt[e.get("name", "?")] += 1
    return [(d / 1e3, cnt[name], name) for name, d in dur.most_common(limit)]


def _device_events(events: list[dict]) -> list[dict]:
    dev = [e for e in events if e.get("cat") in DEVICE_CATS]
    return dev or [e for e in events if e.get("cat") == "cpu_op"]


def op_table(
    log_dir: str,
    by: str = "source",
    limit: int = 25,
    name_filter: Optional[str] = None,
) -> list[dict]:
    """Device time of the newest trace in ``log_dir``, grouped by ``by``:
    ``'source'`` (the operator that launched the kernel, found by the
    trace's "External id"; the event's own name on the CPU), ``'category'``
    (the trace category: kernel, gpu_memcpy, gpu_memset, cpu_op) or
    ``'base'`` (the name with trailing digits stripped). ``name_filter``
    keeps events whose name or source holds the substring. Rows ``{key,
    ms, count, gbytes, gbps, gflops}`` sorted by time (the byte and flop
    columns are 0: torch traces do not carry them)."""
    events = _newest_events(log_dir)
    launcher = {}
    for e in events:
        ext = (e.get("args") or {}).get("External id")
        if e.get("cat") == "cpu_op" and ext is not None:
            launcher.setdefault(ext, e.get("name", "?"))
    agg: dict = {}
    for e in _device_events(events):
        name = e.get("name", "?")
        src = name
        if e.get("cat") != "cpu_op":
            src = launcher.get((e.get("args") or {}).get("External id"),
                               "<no-source>")
        if name_filter and name_filter not in name and name_filter not in src:
            continue
        if by == "source":
            key = src
        elif by == "category":
            key = e.get("cat", "<no-category>")
        else:
            key = name.rstrip("0123456789").rstrip(".")
        row = agg.setdefault(key, {"ms": 0.0, "count": 0})
        row["ms"] += e.get("dur", 0) / 1e3
        row["count"] += 1
    rows = [{"key": k, "ms": round(v["ms"], 3), "count": v["count"],
             "gbytes": 0.0, "gbps": 0.0, "gflops": 0.0}
            for k, v in agg.items()]
    rows.sort(key=lambda r: -r["ms"])
    return rows[:limit]


def program_table(log_dir: str) -> list[dict]:
    """Per-replay device totals of the CUDA graphs in the newest trace of
    ``log_dir``: the kernels a ``cudaGraphLaunch`` ran share its
    correlation id, so each replay's device ms is their sum; rows ``{key,
    ms, count, ms_per_call}``, one per graph (keyed by the graph id the
    trace gives its kernels, else one row for all replays). Empty when the
    trace holds no replay."""
    events = _newest_events(log_dir)
    launches = {(e.get("args") or {}).get("correlation")
                for e in events if e.get("name") == "cudaGraphLaunch"}
    launches.discard(None)
    per_call: dict = {}
    for e in events:
        args = e.get("args") or {}
        corr = args.get("correlation")
        if e.get("cat") in DEVICE_CATS and corr in launches:
            key = f"cuda_graph {args['graph id']}" if "graph id" in args \
                else "cuda_graph"
            per_call.setdefault((key, corr), 0.0)
            per_call[(key, corr)] += e.get("dur", 0) / 1e3
    agg: dict = {}
    for (key, _), ms in per_call.items():
        row = agg.setdefault(key, {"ms": 0.0, "count": 0})
        row["ms"] += ms
        row["count"] += 1
    rows = [{"key": k, "ms": round(v["ms"], 3), "count": v["count"],
             "ms_per_call": round(v["ms"] / v["count"], 3)}
            for k, v in agg.items()]
    rows.sort(key=lambda r: -r["ms"])
    return rows


def print_op_table(rows: list[dict], total_ms: Optional[float] = None):
    """Render an ``op_table`` as an aligned text table."""
    tot = total_ms or sum(r["ms"] for r in rows)
    print(f"{'ms':>9} {'%':>5} {'count':>6} {'GB':>8} {'GB/s':>7}  key")
    for r in rows:
        print(f"{r['ms']:9.3f} {100 * r['ms'] / max(tot, 1e-9):5.1f} "
              f"{r['count']:6d} {r['gbytes']:8.3f} {r['gbps']:7.1f}  "
              f"{r['key']}")


def busy_seconds(prof, windows=None) -> float:
    """Union of a live profiler's device-kernel [start, end) intervals, in
    seconds; with ``windows`` ([(start, end)] in the profiler's
    microseconds), only the parts inside them."""
    spans = sorted(
        (e.time_range.start, e.time_range.end)
        for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CUDA
        and not getattr(e, "is_user_annotation", False)
    )
    if windows is not None:
        spans = sorted((max(s, a), min(e, b)) for s, e in spans
                       for a, b in windows if s < b and e > a)
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy * 1e-6  # profiler times are microseconds


def top_kernels(prof, n: int = 12) -> list[dict]:
    """A live profiler's ops with device time: ``{name, calls, device_ms}``
    sorted by device time."""
    rows = []
    for a in prof.key_averages():
        dev_us = getattr(a, "self_device_time_total", 0.0)
        if dev_us > 0:
            rows.append({"name": a.key[:80], "calls": a.count,
                         "device_ms": dev_us / 1e3})
    rows.sort(key=lambda r: -r["device_ms"])
    return rows[:n]


def device_memory_stats() -> dict:
    """``{"cuda:i": {bytes_in_use, peak_bytes_in_use, bytes_limit}}`` from
    the caching allocator, one entry per card; ``{}`` without a card."""
    if not torch.cuda.is_available():
        return {}
    out = {}
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        out[f"cuda:{i}"] = {
            "bytes_in_use": stats.get("allocated_bytes.all.current", 0),
            "peak_bytes_in_use": stats.get("allocated_bytes.all.peak", 0),
            "bytes_limit": torch.cuda.get_device_properties(i).total_memory,
        }
    return out
