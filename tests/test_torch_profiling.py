"""``shadowkv_tpu_torch/utils/profiling.py`` on the CPU: the helpers of
``shadowkv_tpu/utils/profiling.py`` over ``torch.profiler`` traces. With no
card the op tables read the CPU operators, the device memory stats are
empty and a trace holds no CUDA graph replay."""

from __future__ import annotations

import json
import os

import torch

from shadowkv_tpu_torch import utils
from shadowkv_tpu_torch.utils import profiling


def _work():
    a = torch.randn(64, 64)
    for _ in range(3):
        a = torch.matmul(a, a).tanh()
    return a


def test_exports_match_jax_utils():
    for name in ("time_fn", "trace", "device_memory_stats"):
        assert getattr(utils, name) is getattr(profiling, name)


def test_time_fn_counts_calls():
    calls = []
    sec = profiling.time_fn(lambda x: calls.append(x), 1, n=5, warmup=2)
    assert len(calls) == 7 and sec >= 0.0


def test_trace_and_tables(tmp_path, capsys):
    log_dir = str(tmp_path / "tr")
    with profiling.trace(log_dir) as prof:
        _work()
    files = os.listdir(log_dir)
    assert len(files) == 1 and files[0].startswith("trace_")
    with open(os.path.join(log_dir, files[0])) as f:
        assert json.load(f)["traceEvents"]
    top = profiling.top_ops(log_dir, limit=50)
    names = [name for _, _, name in top]
    assert "aten::matmul" in names
    ms = [t for t, _, _ in top]
    assert ms == sorted(ms, reverse=True)
    assert dict((n, c) for _, c, n in top)["aten::tanh"] == 3

    rows = profiling.op_table(log_dir, by="source", limit=100)
    keys = {r["key"]: r for r in rows}
    assert keys["aten::tanh"]["count"] == 3
    assert set(rows[0]) == {"key", "ms", "count"}
    assert [r["ms"] for r in rows] == sorted((r["ms"] for r in rows),
                                             reverse=True)
    cats = profiling.op_table(log_dir, by="category")
    assert [r["key"] for r in cats] == ["cpu_op"]
    assert sum(r["count"] for r in cats) == sum(r["count"] for r in rows)
    only = profiling.op_table(log_dir, by="base", name_filter="tanh")
    assert [r["key"] for r in only] == ["aten::tanh"]
    profiling.print_op_table(rows[:3])
    out = capsys.readouterr().out.splitlines()
    assert out[0].split()[:3] == ["ms", "%", "count"] and len(out) == 4
    # no CUDA graph replays, no kernels
    assert profiling.program_table(log_dir) == []
    assert profiling.busy_seconds(prof) == 0.0
    assert profiling.top_kernels(prof) == []


def test_empty_dir_and_no_card(tmp_path):
    assert profiling.top_ops(str(tmp_path)) == []
    assert profiling.op_table(str(tmp_path)) == []
    assert profiling.program_table(str(tmp_path)) == []
    if not torch.cuda.is_available():
        assert profiling.device_memory_stats() == {}


def test_program_table_sums_each_replay(tmp_path):
    """A trace with two replays of one graph: each replay's device time is
    the sum of the kernels sharing its launch's correlation id."""
    ev = [
        {"ph": "X", "name": "cudaGraphLaunch", "cat": "cuda_runtime",
         "dur": 5, "args": {"correlation": 1}},
        {"ph": "X", "name": "cudaGraphLaunch", "cat": "cuda_runtime",
         "dur": 5, "args": {"correlation": 2}},
        {"ph": "X", "name": "k1", "cat": "kernel", "dur": 1000,
         "args": {"correlation": 1, "graph id": 7}},
        {"ph": "X", "name": "k2", "cat": "kernel", "dur": 500,
         "args": {"correlation": 1, "graph id": 7}},
        {"ph": "X", "name": "k1", "cat": "kernel", "dur": 1100,
         "args": {"correlation": 2, "graph id": 7}},
        {"ph": "X", "name": "eager", "cat": "kernel", "dur": 9000,
         "args": {"correlation": 3, "External id": 4}},
        {"ph": "X", "name": "aten::mm", "cat": "cpu_op", "dur": 9500,
         "args": {"External id": 4}},
    ]
    with open(tmp_path / "trace_1.json", "w") as f:
        json.dump({"traceEvents": ev}, f)
    assert profiling.program_table(str(tmp_path)) == [
        {"key": "cuda_graph 7", "ms": 2.6, "count": 2, "ms_per_call": 1.3}]
    rows = {r["key"]: r for r in profiling.op_table(str(tmp_path))}
    # device events only; a kernel's source is the op that launched it
    assert rows["aten::mm"]["ms"] == 9.0 and rows["<no-source>"]["count"] == 3
