"""The program's own phases in a traced run's device trace.

While a profiler records, the port launches an empty marker kernel named
``skv_span_<phase>`` on its stream at the start of each phase of its work
(``shadowkv_tpu_torch/utils/profiling.py``, ``csrc/spans.cu``; inside a
replayed decode graph too), and names its host work with ``skv.*``
ranges. Here ``TraceData.device`` is cut by those markers: sorted by start
time, each other device event belongs to the phase of the last marker
before its start (``""`` before the first marker). A phase instance's
interval runs from its marker's start to the next marker's start (the
window's end after the last). Per phase, summed over its instances:

- ``busy_s``: the union of its events' intervals (the markers' own time
  left out);
- ``idle_s``: its intervals less the union of every device event inside
  them, its marker included;
- ``count``: its markers.

A trace with no marker (a program without spans) gives None, and so does
every reader built on it."""

from __future__ import annotations

import dataclasses

import numpy as np

MARKER = "skv_span_"
DECODE_HOST = "skv.decode."  # the engine's host spans of a decode step


@dataclasses.dataclass
class Phase:
    busy_s: float = 0.0
    idle_s: float = 0.0
    count: int = 0


def _union(intervals) -> float:
    """Microseconds covered by ``intervals`` [(start, end)]."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def phases(trace) -> dict[str, Phase] | None:
    """{phase: Phase} of ``trace`` (a ``portbench.trace.TraceData``), or
    None when it holds no marker."""
    events = sorted(trace.device, key=lambda ev: (ev[1], ev[2]))
    if not any(n.startswith(MARKER) for n, _, _ in events):
        return None
    out: dict[str, Phase] = {}
    name, t0, work, every = "", trace.span[0], [], []

    def close(t1):
        p = out.setdefault(name, Phase())
        p.busy_s += _union(work) * 1e-6
        inside = [(max(s, t0), min(e, t1)) for s, e in every
                  if s < t1 and e > t0]
        p.idle_s += max(0.0, (t1 - t0) - _union(inside)) * 1e-6

    for n, s, e in events:
        if n.startswith(MARKER):
            close(s)
            name, t0, work, every = n[len(MARKER):], s, [], [(s, e)]
            out.setdefault(name, Phase()).count += 1
        else:
            work.append((s, e))
            every.append((s, e))
    close(trace.span[1])
    return out


def marker_s(trace) -> float:
    """Device seconds of the markers themselves."""
    return sum(e - s for n, s, e in trace.device
               if n.startswith(MARKER)) * 1e-6


def decode_ms_per_step(obs: dict, names) -> float | None:
    """Busy ms per traced decode step in the phases ``names``, summed over
    layers; None outside a decode cell or without those phases."""
    if "depths" not in obs:
        return None
    p = phases(obs["trace"])
    if p is None or not any(n in p for n in names):
        return None
    return 1e3 * sum(p[n].busy_s for n in names if n in p) \
        / len(obs["depths"])


def prefill_phase(obs: dict, name: str) -> Phase | None:
    """The phase ``name`` of a traced prefill; None outside a prefill cell
    or without it."""
    if "prompt_len" not in obs:
        return None
    p = phases(obs["trace"])
    return None if p is None else p.get(name)


def host_idle_s(trace, prefix: str) -> float:
    """Seconds of the device's idle gaps inside the window that begin while
    the host is inside a span whose name starts with ``prefix``."""
    host = [h for h in trace.host if h[0].startswith(prefix)]
    if not host:
        return 0.0
    starts = np.array([h[1] for h in host])
    ends = np.array([h[2] for h in host])
    idle, t = 0.0, trace.span[0]
    for s, e in trace.busy_intervals() + [(trace.span[1], trace.span[1])]:
        if s > t and ((starts <= t) & (ends >= t)).any():
            idle += s - t
        t = max(t, e)
    return idle * 1e-6
