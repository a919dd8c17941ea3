"""The port's own spans (``shadowkv_tpu_torch/utils/profiling.py``:
``span``, ``mark``; the marked twin of each decode graph in
``models/graphs.py``).

On the CPU, with a tiny shadow engine: under a profiler a prefill and
decode steps give ``skv.*`` host ranges that nest as the program runs
(``skv.prefill`` > ``skv.prefill.batch`` > the layers' phases;
``skv.decode.step`` > ``skv.decode.begin``, ``skv.decode.eager`` > the
layers' phases), one set per layer; with no profiler no
``record_function`` is entered and no marker is asked for; tokens, logits
and cached ids are the same bits with and without a profiler. The marker
kernels of ``csrc/spans.cu`` follow ``PHASES``; ``program_table`` splits a
marked replay by its phases.

On the card (skipped without one): the twin and the plain graph replayed
alternately give a plain-only run's bits, two captures happen per path,
the plain graph replays when no profiler records, and a traced step holds
its 5 L + 3 markers in order (a traced prefill its own)."""

from __future__ import annotations

import contextlib
import json
import re

import numpy as np
import pytest
import torch

from shadowkv_tpu_torch.utils import profiling

LAYERS = 2
DECODE_LAYER = ("qkv", "select", "refresh", "attn", "tail")
PREFILL_LAYER = ("qkv", "lowrank", "store", "attn", "tail")


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _engine(device="cpu", dtype=torch.float32, head_dim=32, **rt_kw):
    from shadowkv_tpu_torch.config import CacheConfig, RuntimeConfig
    from shadowkv_tpu_torch.models.engine import Engine
    from shadowkv_tpu_torch.models.params import init_synthetic_params
    from shadowkv_tpu_torch.models.registry import toy_config

    cfg = toy_config(dtype=dtype, head_dim=head_dim, num_layers=LAYERS)
    params = init_synthetic_params(
        cfg, torch.Generator(device=device).manual_seed(0), scale=0.2,
        device=device)
    cc = CacheConfig(mode="shadow", max_length=544, sparse_budget=128,
                     rank=32, chunk_size=16, kv_quant="int8",
                     outlier_chunks=4, gen_capacity=32)
    rt = dict(use_pallas=True, prefill_sub_batch=1)
    rt.update(rt_kw)
    eng = Engine(cfg, cc, RuntimeConfig(**rt), params, device=device)
    ids = np.random.RandomState(0).randint(1, cfg.vocab_size, (2, 512))
    return eng, ids


def _profiler(cuda=False):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)


def _host_spans(prof) -> list:
    return sorted(((e.name, e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.name.startswith("skv.")),
                  key=lambda s: (s[1], -s[2]))


def _inside(child, parent) -> bool:
    return parent[1] <= child[1] and child[2] <= parent[2]


def _children(spans, parent) -> list:
    """The spans directly inside ``parent``, in order."""
    inner = [s for s in spans if s is not parent and _inside(s, parent)]
    return [s for s in inner
            if not any(o is not s and _inside(s, o) for o in inner)]


def _names(spans) -> list:
    return [s[0] for s in spans]


def _phases(*names) -> list:
    return ["skv." + n for n in names]


def test_prefill_spans_nest_per_layer():
    eng, ids = _engine()
    with _profiler() as prof:
        eng.prefill(ids)
    spans = _host_spans(prof)
    (top,) = [s for s in spans if s[0] == profiling.PREFILL]
    batches = _children(spans, top)
    assert _names(batches) == [profiling.PREFILL_BATCH] * 2
    for batch in batches:
        assert _names(_children(spans, batch)) == (
            _phases("embed") + _phases(*PREFILL_LAYER) * LAYERS
            + _phases("head"))


def test_decode_spans_nest_per_layer():
    eng, ids = _engine()
    logits, cache = eng.prefill(ids)
    tok = logits[:, -1].argmax(-1).int()
    with _profiler() as prof:
        for _ in range(2):
            tok, _ = eng.decode_step(cache, tok)
    spans = _host_spans(prof)
    steps = [s for s in spans if s[0] == profiling.DECODE_STEP]
    assert len(steps) == 2
    for step in steps:
        begin, eager = _children(spans, step)
        assert (begin[0], eager[0]) == (profiling.DECODE_BEGIN,
                                        profiling.DECODE_EAGER)
        assert _names(_children(spans, eager)) == (
            _phases("embed") + _phases(*DECODE_LAYER) * LAYERS
            + _phases("head"))


def _count_calls(monkeypatch):
    """Count ``record_function`` entries and the markers asked for (the
    launcher, which does nothing off the card)."""
    calls = {"record_function": 0, "markers": []}
    real_rf = torch.profiler.record_function
    real_launch = profiling._launch_marker

    def rf(*a, **k):
        calls["record_function"] += 1
        return real_rf(*a, **k)

    def launch(phase, device):
        calls["markers"].append(phase)
        return real_launch(phase, device)

    monkeypatch.setattr(torch.profiler, "record_function", rf)
    monkeypatch.setattr(profiling, "_launch_marker", launch)
    return calls


def _drive(eng, ids):
    """A prefill, two decode steps, a two-step chunk and a generate."""
    logits, cache = eng.prefill(ids)
    tok = logits[:, -1].argmax(-1).int()
    for _ in range(2):
        tok, _ = eng.decode_step(cache, tok)
    z = torch.zeros(2, 2, dtype=torch.int32)
    eng.decode_chunk(cache, tok, z, z.bool())
    eng.generate(ids, gen_len=3)


def test_no_profiler_enters_no_range_and_asks_for_no_marker(monkeypatch):
    eng, ids = _engine()
    calls = _count_calls(monkeypatch)
    _drive(eng, ids)
    assert calls == {"record_function": 0, "markers": []}
    # the control: the same work under a profiler
    with _profiler():
        _drive(eng, ids)
    assert calls["record_function"] > 0
    prefill = (["embed"] + list(PREFILL_LAYER) * LAYERS + ["head"]) * 2 \
        + ["end"]
    step = ["embed"] + list(DECODE_LAYER) * LAYERS + ["head", "end"]
    assert calls["markers"] == prefill + step * 4 + prefill + step * 2


def _steps(eng, ids, n, profiled=lambda i: False, cuda=False):
    """``n`` sampled decode steps from a prefill, the steps ``profiled``
    picks under a profiler: every step's tokens, logits and cached ids."""
    logits, cache = eng.prefill(ids)
    tok = logits[:, -1].argmax(-1).int()
    g = torch.Generator(device=eng.device).manual_seed(5)
    out = []
    for i in range(n):
        ctx = _profiler(cuda) if profiled(i) else contextlib.nullcontext()
        with ctx:
            tok, lg = eng.decode_step(cache, tok, generator=g,
                                      temperature=0.6)
        out.append((tok.clone(), lg.clone(), cache.cached_ids.clone()))
    return out


def _assert_same_bits(a, b):
    for (ta, la, ia), (tb, lb, ib) in zip(a, b, strict=True):
        assert torch.equal(ta, tb)
        assert torch.equal(la, lb)
        assert torch.equal(ia, ib)


def test_profiler_changes_no_bit():
    eng, ids = _engine()
    plain = _steps(eng, ids, 8)
    traced = _steps(eng, ids, 8, profiled=lambda i: True)
    _assert_same_bits(plain, traced)


def test_marker_kernels_follow_the_phases():
    from shadowkv_tpu_torch.kernels import build

    src = (build.CSRC_DIR / "spans.cu").read_text()
    assert "spans.cu" in build.SOURCES
    kernels = re.findall(r"__global__ void skv_span_(\w+)\(\)", src)
    cases = re.findall(r"case (\d+): skv_span_(\w+)<<<1, 1, 0, s>>>", src)
    assert tuple(kernels) == profiling.PHASES
    assert [(int(i), p) for i, p in cases] == list(
        enumerate(profiling.PHASES))


def test_program_table_splits_a_marked_replay_by_phase(tmp_path):
    """Two replays of a marked graph (its kernels in the phase of the last
    marker before them, a marker's own time in its phase) and one of a
    plain graph, which gets no split."""
    ev = [{"ph": "X", "name": "cudaGraphLaunch", "cat": "cuda_runtime",
           "dur": 5, "args": {"correlation": c}} for c in (1, 2, 3)]
    for corr, t0 in ((1, 0), (2, 100)):
        for name, ts, dur in (("gemm_pre", 0, 10), ("skv_span_embed", 10, 1),
                              ("take", 11, 9), ("skv_span_attn", 20, 1),
                              ("gemv", 21, 30)):
            ev.append({"ph": "X", "name": name, "cat": "kernel",
                       "ts": t0 + ts, "dur": dur * 1000,
                       "args": {"correlation": corr, "graph id": 2}})
    ev.append({"ph": "X", "name": "gemv", "cat": "kernel", "ts": 300,
               "dur": 4000, "args": {"correlation": 3, "graph id": 1}})
    with open(tmp_path / "trace_1.json", "w") as f:
        json.dump({"traceEvents": ev}, f)
    rows = {r["key"]: r for r in profiling.program_table(str(tmp_path))}
    assert rows["cuda_graph 2"]["phases"] == {"": 20.0, "embed": 20.0,
                                              "attn": 62.0}
    assert rows["cuda_graph 2"]["ms"] == 102.0
    assert "phases" not in rows["cuda_graph 1"]


# -- on the card -----------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _card_engine(**rt_kw):
    return _engine("cuda", torch.bfloat16, 128, **rt_kw)


@pytest.mark.cuda
def test_twin_replays_equal_plain_replays(card, monkeypatch):
    """16 sampled steps replaying the twin (profiled) and the plain graph
    alternately equal 16 steps of the plain graph alone, bit for bit; two
    captures of the one path; each unprofiled step replays the plain
    graph, each profiled one the twin."""
    eng, ids = _card_engine()
    plain = _steps(eng, ids, 16, cuda=True)
    assert eng._steps.captures == 2 and len(eng._steps._graphs) == 1
    replayed = []
    real = torch.cuda.CUDAGraph.replay

    def replay(graph):
        replayed.append(graph)
        return real(graph)

    monkeypatch.setattr(torch.cuda.CUDAGraph, "replay", replay)
    mixed = _steps(eng, ids, 16, profiled=lambda i: i % 2 == 1, cuda=True)
    _assert_same_bits(plain, mixed)
    (plain_g, _, _), (twin_g, _, _) = next(iter(eng._steps._graphs.values()))
    # step 0 runs eagerly and captures; steps 1.. replay
    assert replayed == [twin_g if i % 2 else plain_g for i in range(1, 16)]
    assert eng._steps.captures == 2


@pytest.mark.cuda
def test_auto_captures_two_graphs_a_path(card):
    eng, ids = _card_engine(use_pallas="auto", pallas_hit_threshold=0.0,
                            pallas_auto_interval=2)
    eng.batch_generate(ids, gen_len=4, temperature=0.0, warmup_steps=2)
    assert len(eng._steps._graphs) == 2 and eng._steps.captures == 4


def _markers(prof) -> list:
    ev = [(e.time_range.start, e.name) for e in prof.events()
          if e.device_type == torch.autograd.DeviceType.CUDA
          and e.name.startswith(profiling.MARKER)]
    return [n[len(profiling.MARKER):] for _, n in sorted(ev)]


@pytest.mark.cuda
def test_traced_step_and_prefill_hold_their_markers(card):
    eng, ids = _card_engine()
    with _profiler(cuda=True) as prof:
        logits, cache = eng.prefill(ids)
        torch.cuda.synchronize()
    assert _markers(prof) == (["embed"] + list(PREFILL_LAYER) * LAYERS
                              + ["head"]) * 2 + ["end"]
    tok = logits[:, -1].argmax(-1).int()
    for _ in range(2):  # the eager step and the captures, one replay
        tok, _ = eng.decode_step(cache, tok)
    with _profiler(cuda=True) as prof:
        eng.decode_step(cache, tok)
        torch.cuda.synchronize()
    assert _markers(prof) == (["embed"] + list(DECODE_LAYER) * LAYERS
                              + ["head", "end"])
    assert len(_markers(prof)) == 5 * LAYERS + 3
