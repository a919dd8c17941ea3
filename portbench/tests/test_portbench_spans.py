"""``portbench/spans.py`` and the readers of the program's spans on
hand-made traces: phases cut by the marker kernels, their busy and idle
time, and None on a trace with no marker (a program without spans)."""

import pytest

from portbench import spans, spec
from portbench.trace import TraceData

READERS = ("select_ms_per_step", "refresh_ms_per_step",
           "decode_attn_ms_per_step", "proj_ms_per_step",
           "decode_engine_idle_pct", "lowrank_ms", "lowrank_idle_pct")


def _mark(phase, t):
    return (spans.MARKER + phase, t, t + 1.0)


def _decode_trace():
    """Two steps of a one-layer decode (microseconds): a copy before the
    first marker, then embed, qkv, select, refresh, attn, tail, head, end
    (the steps' end markers at 92 and 197); two overlapping kernels in
    select; gaps inside attn, between the steps (95-115, while the host is
    inside ``skv.decode.begin``) and after the last (200-400, inside
    another span)."""
    dev, t = [("copy", 2.0, 6.0)], 10.0
    for _ in range(2):
        for phase, work in (("embed", 4), ("qkv", 10), ("select", 20),
                            ("refresh", 6), ("attn", 12), ("tail", 10),
                            ("head", 8), ("end", 2)):
            dev.append(_mark(phase, t))
            if phase == "select":
                dev += [("topk", t + 1, t + 1 + work),
                        ("sort", t + 5, t + 1 + work)]
            elif phase == "attn":  # 5 us idle after the kernel
                dev.append(("attn_gemv", t + 1, t + 1 + work))
                t += 5
            else:
                dev.append((phase + "_op", t + 1, t + 1 + work))
            t += 1 + work
        t += 20  # the host's gap between steps
    host = [("portbench.window", 0.0, 400.0),
            ("skv.decode.begin", 94.0, 116.0),
            ("aten::zero_", 199.0, 300.0)]
    return TraceData(span=(0.0, 400.0), device=dev, host=host)


def test_phases_sum_to_busy_less_markers():
    t = _decode_trace()
    p = spans.phases(t)
    assert set(p) == {"", "embed", "qkv", "select", "refresh", "attn",
                      "tail", "head", "end"}
    assert p["select"].busy_s == pytest.approx(2 * 20e-6)  # the union
    assert p["attn"].busy_s == pytest.approx(2 * 12e-6)
    assert p["qkv"].count == 2 and p[""].count == 0
    total = sum(ph.busy_s for ph in p.values())
    assert total == pytest.approx(t.busy_s - spans.marker_s(t))
    assert spans.marker_s(t) == pytest.approx(16e-6)
    # idle: 5 us after each attention kernel, 20 us after the first step,
    # 200 us after the last, 6 us around the copy before the first marker
    assert p["attn"].idle_s == pytest.approx(10e-6)
    assert p[""].idle_s == pytest.approx(6e-6)
    assert p["end"].idle_s == pytest.approx(220e-6)
    assert p["qkv"].idle_s == pytest.approx(0.0)


def test_decode_readers():
    t = _decode_trace()
    obs = {"trace": t, "depths": [3, 4]}

    def read(q):
        return spec.reader(q).read(obs)

    assert read("select_ms_per_step") == pytest.approx(0.020)
    assert read("refresh_ms_per_step") == pytest.approx(0.006)
    assert read("decode_attn_ms_per_step") == pytest.approx(0.012)
    assert read("proj_ms_per_step") == pytest.approx(0.032)
    # of the gaps only 95-115 begins inside an skv.decode.* span
    assert read("decode_engine_idle_pct") == pytest.approx(100 * 20 / 400)
    assert read("lowrank_ms") is None  # not a prefill


def test_prefill_readers():
    dev = [_mark("embed", 0.0), ("emb", 1.0, 5.0),
           _mark("qkv", 5.0), ("gemm", 6.0, 20.0),
           _mark("lowrank", 20.0), ("eigh", 21.0, 40.0), ("rot", 60.0, 70.0),
           _mark("store", 70.0), ("copy", 71.0, 75.0),
           _mark("head", 75.0), ("lm", 76.0, 90.0), _mark("end", 90.0)]
    t = TraceData(span=(0.0, 100.0), device=dev, host=[])
    obs = {"trace": t, "prompt_len": 16, "prefills": 1}
    assert spec.reader("lowrank_ms").read(obs) == pytest.approx(0.029)
    # 20 us waited inside lowrank (40-60) of a 100 us window
    assert spec.reader("lowrank_idle_pct").read(obs) == pytest.approx(20.0)
    assert spec.reader("select_ms_per_step").read(obs) is None


@pytest.mark.parametrize("quantity", READERS)
def test_readers_give_none_without_markers(quantity):
    dev = [("gemm", 1.0, 5.0), ("refresh_kernel", 6.0, 9.0)]
    host = [("skv.decode.step", 0.0, 10.0)]
    t = TraceData(span=(0.0, 10.0), device=dev, host=host)
    assert spans.phases(t) is None
    for obs in ({"trace": t, "depths": [0]},
                {"trace": t, "prompt_len": 16, "prefills": 1}):
        assert spec.reader(quantity).read(obs) is None
