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
  that one ``cudaGraphLaunch`` ran, summed over its replays, split by the
  phases of its markers where the graph holds them (below); a trace with
  no replays (eager steps, the CPU) has no rows;
- ``busy_seconds`` / ``top_kernels``: the device-busy time (the union of
  the kernels' intervals) and the top device ops of a live profiler;
- ``device_memory_stats``: the card's allocator statistics, ``{}`` on a
  machine without one;
- ``span``: the program's own spans (below).

Op tables read the trace's device events: kernels, copies and memsets on
the card. A trace without any (a CPU run) uses its CPU operators instead,
so the same tables serve the CPU tests.

Spans. The program names its own work while a profiler records, and only
then. ``span(name, device)`` is a context manager: with no profiler
recording it is one shared null context, whose only cost is the check
``torch._C._autograd._profiler_enabled()`` (~0.1 us; entering a
``record_function`` with no profiler costs ~5 us). While a profiler
records it enters ``torch.profiler.record_function``: a host range on the
profiler's clock. A name in ``PHASES`` is a device phase: its host range is
``skv.<phase>``, and on a CUDA ``device`` it also launches the phase's
marker kernel ``skv_span_<phase>`` (``csrc/spans.cu``, an empty kernel) on
the current stream, so the device trace is cut into phases on its own
clock: a phase runs from its marker to the next. A CUDA graph replays no
Python, so a decode graph holds markers only if they were captured: each
decode path is captured twice (``models/graphs.py``), plainly and, under
``capturing(True)``, as a marked twin whose spans launch their markers
(and enter no host range); the twin is replayed while a profiler records.
``mark(phase, device)`` launches a marker alone (``end``, after a step).

The names are the contract with the benchmark's readers
(``portbench/spans.py``, ``portbench/metrics/``): the device phases, in
their order inside a decode step, ``embed``, then per layer ``qkv``,
``select``, ``refresh``, ``attn``, ``tail``, then ``head`` and ``end``
(5 L + 3 markers); inside a prefill's layer ``qkv``, ``lowrank``,
``store``, ``attn``, ``tail``. A hybrid model (``core/moe.py``,
``cache/hybrid.py``) adds ``swa`` (a sliding layer's ring and attention,
in place of ``select``, ``refresh`` and ``attn``, or of ``lowrank``,
``store`` and ``attn``) and, inside an MoE layer's ``tail``, ``route``
(the router) and ``experts`` (the held and shared experts, to the layer's
end). The host spans of the engine's own work:
``skv.prefill`` > ``skv.prefill.batch``; ``skv.decode.step`` >
``skv.decode.begin``, ``skv.decode.replay``, ``skv.decode.eager``,
``skv.graph.capture``; ``skv.kernels.build`` around the nvcc build.
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

# Device phases, in the order of their marker kernels in csrc/spans.cu.
PHASES = ("embed", "qkv", "select", "refresh", "attn", "tail", "head",
          "lowrank", "store", "end", "route", "experts", "swa")
(EMBED, QKV, SELECT, REFRESH, ATTN, TAIL, HEAD, LOWRANK, STORE,
 END, ROUTE, EXPERTS, SWA) = PHASES
MARKER = "skv_span_"  # + phase: a marker kernel's name in a trace
# Host spans of the engine's own work.
PREFILL = "skv.prefill"
PREFILL_BATCH = "skv.prefill.batch"
DECODE_STEP = "skv.decode.step"
DECODE_BEGIN = "skv.decode.begin"
DECODE_REPLAY = "skv.decode.replay"
DECODE_EAGER = "skv.decode.eager"
GRAPH_CAPTURE = "skv.graph.capture"
KERNELS_BUILD = "skv.kernels.build"

_PHASE_IDS = {p: i for i, p in enumerate(PHASES)}
_NULL = contextlib.nullcontext()
recording = torch._C._autograd._profiler_enabled
# None outside a capture; inside one, whether it is a marked twin.
_capture_marked: Optional[bool] = None


def _launch_marker(phase: str, device) -> None:
    """The marker kernel of ``phase`` on ``device``'s current stream (none
    off the card)."""
    if device is None or torch.device(device).type != "cuda":
        return
    from shadowkv_tpu_torch.kernels import build

    rc = build.library().shadowkv_span(
        _PHASE_IDS[phase], torch.cuda.current_stream(device).cuda_stream)
    build.check(rc, f"marker {phase}")


@contextlib.contextmanager
def _recorded(name: str, device):
    phase = name in _PHASE_IDS
    with torch.profiler.record_function("skv." + name if phase else name):
        if phase:
            _launch_marker(name, device)
        yield


def span(name: str, device=None):
    """A span of the program's work (module docstring): a null context
    unless a profiler records or a marked twin is captured."""
    if _capture_marked is not None:
        if _capture_marked and name in _PHASE_IDS:
            _launch_marker(name, device)
        return _NULL
    if not recording():
        return _NULL
    return _recorded(name, device)


def mark(phase: str, device) -> None:
    """The marker of ``phase`` alone, where ``span`` would launch it."""
    marked = recording() if _capture_marked is None else _capture_marked
    if marked:
        _launch_marker(phase, device)


@contextlib.contextmanager
def capturing(marked: bool):
    """Inside a CUDA graph capture: spans launch their markers if
    ``marked`` (the twin) and nothing else; no host range is entered."""
    global _capture_marked
    _capture_marked = marked
    try:
        yield
    finally:
        _capture_marked = None


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
    ms, count}`` sorted by time."""
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
    rows = [{"key": k, "ms": round(v["ms"], 3), "count": v["count"]}
            for k, v in agg.items()]
    rows.sort(key=lambda r: -r["ms"])
    return rows[:limit]


def program_table(log_dir: str) -> list[dict]:
    """Per-replay device totals of the CUDA graphs in the newest trace of
    ``log_dir``: the kernels a ``cudaGraphLaunch`` ran share its
    correlation id, so each replay's device ms is their sum; rows ``{key,
    ms, count, ms_per_call}``, one per graph (keyed by the graph id the
    trace gives its kernels, else one row for all replays). A graph whose
    replays hold phase markers (a marked twin) also has ``phases``: {phase:
    ms} over its replays, each kernel in the phase of the last marker
    before it (a marker's own time in its phase, ``""`` before the first
    marker), summing to ``ms``. Empty when the trace holds no replay."""
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
            per_call.setdefault((key, corr), []).append(e)
    agg: dict = {}
    for (key, _), evs in per_call.items():
        row = agg.setdefault(key, {"ms": 0.0, "count": 0, "phases": {}})
        phase = ""
        for e in sorted(evs, key=lambda e: e.get("ts", 0)):
            name = e.get("name", "")
            if name.startswith(MARKER):
                phase = name[len(MARKER):]
            ms = e.get("dur", 0) / 1e3
            row["ms"] += ms
            row["phases"][phase] = row["phases"].get(phase, 0.0) + ms
        row["count"] += 1
    rows = []
    for k, v in agg.items():
        row = {"key": k, "ms": round(v["ms"], 3), "count": v["count"],
               "ms_per_call": round(v["ms"] / v["count"], 3)}
        if set(v["phases"]) != {""}:
            row["phases"] = {p: round(ms, 3) for p, ms in v["phases"].items()}
        rows.append(row)
    rows.sort(key=lambda r: -r["ms"])
    return rows


def print_op_table(rows: list[dict], total_ms: Optional[float] = None):
    """Render an ``op_table`` as an aligned text table."""
    tot = total_ms or sum(r["ms"] for r in rows)
    print(f"{'ms':>9} {'%':>5} {'count':>6}  key")
    for r in rows:
        print(f"{r['ms']:9.3f} {100 * r['ms'] / max(tot, 1e-9):5.1f} "
              f"{r['count']:6d}  {r['key']}")


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
