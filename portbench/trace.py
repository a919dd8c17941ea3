"""The traced part of a run: a ``torch.profiler`` window around a short
steady stretch of the measured window, reduced to device intervals and the
host's spans. ``busy`` is the union of the device kernels' intervals inside
the window (the arithmetic of ``utils/profiling.py::busy_seconds`` of the
port, copied here because it is the yardstick)."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

WINDOW = "portbench.window"


@dataclasses.dataclass
class TraceData:
    span: tuple[float, float]  # the traced window, profiler microseconds
    device: list  # [(name, start_us, end_us)] device events inside the span
    host: list  # [(name, start_us, end_us)] host events inside the span

    @property
    def window_s(self) -> float:
        return (self.span[1] - self.span[0]) * 1e-6

    def busy_intervals(self) -> list[tuple[float, float]]:
        spans = sorted((s, e) for _, s, e in self.device)
        merged: list[list[float]] = []
        for s, e in spans:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [(s, e) for s, e in merged]

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) * 1e-6

    def kernel_seconds(self, part: str) -> float:
        """Device seconds of the kernels whose name holds ``part``."""
        return sum(e - s for n, s, e in self.device if part in n) * 1e-6

    def kernel_count(self, part: str) -> int:
        return sum(part in n for n, _, _ in self.device)

    def breakdown(self, top: int = 10) -> dict:
        """The device ops that took most time, and the device's idle time
        inside the window by the innermost host span open when each of the
        longest gaps began ([[name, seconds]], at most ``top`` each)."""
        ops: dict[str, float] = {}
        for n, s, e in self.device:
            ops[n] = ops.get(n, 0.0) + (e - s) * 1e-6
        device_ops = sorted(ops.items(), key=lambda kv: -kv[1])[:top]
        gaps, t = [], self.span[0]
        for s, e in self.busy_intervals() + [(self.span[1], self.span[1])]:
            if s > t:
                gaps.append((t, s))
            t = max(t, e)
        gaps.sort(key=lambda g: g[0] - g[1])
        host = [h for h in self.host if h[0] != WINDOW]
        starts = np.array([h[1] for h in host])
        ends = np.array([h[2] for h in host])
        by: dict[str, float] = {}
        for g0, g1 in gaps[:500]:
            label = "no host span"
            if len(host):
                open_ = np.nonzero((starts <= g0) & (ends >= g0))[0]
                if open_.size:
                    inner = open_[np.argmin(ends[open_] - starts[open_])]
                    label = host[inner][0]
            by[label] = by.get(label, 0.0) + (g1 - g0) * 1e-6
        idle = sorted(by.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n, v] for n, v in device_ops],
                "idle_gaps": [[n, v] for n, v in idle]}


class Tracer:
    """``start()`` and ``stop()`` around the traced stretch, and ``data()``
    after the measured window to read it. The card is synchronised at both
    ends, so the span holds all the work issued inside it."""

    def __init__(self, device: torch.device):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.device = device
        self.prof = torch.profiler.profile(activities=acts)
        self.ann = None

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def start(self) -> None:
        self._sync()
        self.prof.__enter__()
        self.ann = torch.profiler.record_function(WINDOW)
        self.ann.__enter__()

    def stop(self) -> None:
        self._sync()
        self.ann.__exit__(None, None, None)
        self.prof.__exit__(None, None, None)

    def data(self) -> TraceData:
        dev, host, span = [], [], None
        for e in self.prof.events():
            tr = (e.name, e.time_range.start, e.time_range.end)
            if e.device_type == torch.autograd.DeviceType.CUDA:
                if not getattr(e, "is_user_annotation", False):
                    dev.append(tr)
            else:
                if e.name == WINDOW and span is None:
                    span = (tr[1], tr[2])
                host.append(tr)
        a, b = span
        dev = [(n, max(s, a), min(e, b)) for n, s, e in dev if s < b and e > a]
        host = [h for h in host if h[1] < b and h[2] > a]
        return TraceData(span=span, device=dev, host=host)
