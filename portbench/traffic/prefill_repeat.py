"""Long documents prefilled back to back (the ``prefill_repeat`` kind): a
closed loop of one client that sends a fresh ``prompt_len``-id document
(drawn from the seed) as soon as the previous one's first token has come
back, so every request pays the whole dense prefill: the time to first
token of a long document.

Set-up draws the weights and the sketch, and runs one prefill of a
document of its own (the kernels and every shape are then warm). The
window runs whole prefills until ``--seconds`` have passed; each ends
when its first token reaches the host. ``prefill_tok_s`` is every finished
prefill's prompt ids over the wall time up to the end of the last one. A
traced run profiles one whole prefill, the window's second.

``correct``: the prefill drawn from the seed among the window's first
four keeps its logits and its shadow cache; the plain reference runs its
document along the program's outlier and seed chunks, and compares the
last-token logits (``logit_err``), the low-rank factors
(``lowrank_excess``), the landmarks (``landmark_err``), the V store
(``store_err``) and the buffer's local, outlier and seed rows
(``buffer_err``), and judges the outlier choice (``outlier_gap``) and the
seed selection (``select_regret``) by the reference's own scores; each
the worst layer.
"""

from __future__ import annotations

import time

import torch

from portbench import port
from portbench.layout import layout
from portbench.reference import model as ref_model
from portbench.reference.compare import (buffer_err, landmark_err, logit_err,
                                         lowrank_excess, outlier_gap,
                                         select_regret, store_err)
from portbench.reference.shadow import RowRun
from portbench.trace import Tracer
from portbench.weights import draw_sketch, draw_weights, token_rng

SAMPLE_WITHIN = 4  # the checked prefill is one of the window's first four
TRACE_REQUEST = 1  # the window's prefill a traced run profiles


def _program_cache(cache, outliers: int) -> dict:
    """Row 0 of a prefill's cache, float32 and dequantized where the
    stores are int8 (the V store kept in its own type): factors,
    landmarks, the V store, the buffer's rows up to the sparse budget's
    end, and the choices (outliers read from the landmark mask, as the
    decode driver reads them; seed ids)."""
    u, lm = cache.u[:, 0].float(), cache.landmarks[:, 0].float()
    if cache.u_scale is not None:
        u = u * cache.u_scale[:, 0].float()[..., None]
        lm = lm * cache.lm_scale[:, 0].float()[..., None]
    end = cache.layout.sparse_end
    return {"u": u, "sv": cache.sv[:, 0].float(), "lm": lm,
            "v": cache.v_full[:, 0].clone(),
            "v_scale": (None if cache.v_scale is None
                        else cache.v_scale[:, 0].clone()),
            "k_buf": cache.k_buf[:, 0, :, :end].clone(),
            "v_buf": cache.v_buf[:, 0, :, :end].clone(),
            "outliers": (~cache.landmark_mask[:, 0]).float().topk(
                outliers, dim=-1).indices,
            "seed": cache.cached_ids[:, 0].long()}


def _store(prog: dict, l: int, dev) -> torch.Tensor:
    v = prog["v"][l].to(dev).float()
    if prog["v_scale"] is not None:
        v = v * prog["v_scale"][l].to(dev).float()[..., None]
    return v


def run(r) -> dict:
    cfg, tr = r.cell.config, r.cell.traffic
    md, dev = cfg["model"], r.device
    s = tr["prompt_len"]
    w = draw_weights(md, cfg["init"], r.seed, dev)
    sketch = draw_sketch(md, cfg["cache"], r.seed, dev)
    r.lap("weights")
    docs = token_rng(r.seed, 1)  # the warm-up's document, then each request's

    def doc():
        return docs.integers(0, md["vocab_size"], (1, s))

    sample = int(token_rng(r.seed, 3).integers(SAMPLE_WITHIN))
    eng = port.engine(cfg, w, sketch, s, dev)
    logits, _ = eng.prefill(doc())  # warm-up on a document of its own
    int(logits[0, -1].argmax())
    r.mark_setup()

    tracer = Tracer(dev) if r.trace else None
    kept = None
    done = 0
    t0 = time.perf_counter()
    t_end = t0
    while True:
        if tracer is not None and done == TRACE_REQUEST:
            tracer.start()
        ids = doc()
        logits, cache = eng.prefill(ids)
        int(logits[0, -1].argmax())  # the first token on the host
        t_end = time.perf_counter()
        if tracer is not None and done == TRACE_REQUEST:
            tracer.stop()
        if done == sample:
            kept = (ids[0], logits[0, -1].clone(),
                    _program_cache(cache, cfg["cache"]["outlier_chunks"]))
        done += 1
        if t_end - t0 >= r.seconds and done > sample and (
                tracer is None or done > TRACE_REQUEST):
            break
    res = {"attempted": done, "failed": 0,
           "e2e": {"prefill_tok_s": s * done / (t_end - t0)},
           "memory_peak_bytes": r.memory_peak()}
    if tracer is not None:
        res["obs"] = dict(trace=tracer.data(), model=md, prompt_len=s,
                          prefills=1)
    del eng, cache, logits
    r.free()

    prompt, prog_logits, prog = kept
    lay = layout(cfg["cache"], s)
    ref_model.no_tf32()
    t_ref = time.perf_counter()
    empty = torch.zeros(0, dtype=torch.long, device=dev)
    prompt = torch.as_tensor(prompt, device=dev)
    follow = {"outliers": prog["outliers"], "seed": prog["seed"]}

    def row_run(prec):
        return RowRun(md, cfg["cache"], w, sketch, prompt, empty, empty,
                      empty, prec, follow)

    def numbers(ref, l, st, own):
        """The layer's readings of state ``st`` (the program's, or the
        control's with ``own`` its own choices) against ``ref``."""
        return {"lowrank_excess": lowrank_excess(ref, st["u"], st["sv"]),
                "landmark_err": landmark_err(ref, st["lm"]),
                "store_err": store_err(ref, st["v"]),
                "buffer_err": buffer_err(ref, lay, st["k"], st["v_rows"],
                                         prog["seed"][l]),
                "outlier_gap": outlier_gap(ref.out_score, own["outliers"]),
                "select_regret": select_regret(ref.seed_p, own["seed"])}

    runs = [row_run("f32")] + ([row_run("fp8")] if r.control else [])
    num, ctl = [], []
    for l, states in enumerate(zip(*(x.run_layers() for x in runs))):
        ref = states[0]
        num.append(numbers(ref, l, {
            "u": prog["u"][l], "sv": prog["sv"][l], "lm": prog["lm"][l],
            "v": _store(prog, l, dev), "k": prog["k_buf"][l],
            "v_rows": prog["v_buf"][l]},
            {"outliers": prog["outliers"][l], "seed": prog["seed"][l]}))
        for c in states[1:]:
            # the control follows the program's choices; its rows sit in
            # the reference's order: local, outlier chunks, then the seed
            # chunks, as the program's buffer holds them
            hk = torch.arange(c.kv["k_ex"].shape[0], device=dev)[:, None]
            rows = (prog["seed"][l][..., None] * lay.chunk
                    + torch.arange(lay.chunk, device=dev)).flatten(1)
            ctl.append(numbers(ref, l, {
                "u": c.u, "sv": c.sv, "lm": c.landmarks,
                "v": c.kv["v_store"],
                "k": torch.cat([c.kv["k_st"], c.kv["k_ex"][hk, rows]], 1),
                "v_rows": torch.cat([c.kv["v_st"], c.kv["v_ex"][hk, rows]],
                                    1)},
                {"outliers": c.out_own, "seed": c.seed_own}))
    pres = [x.logits()[0] for x in runs]
    res["checks"] = {"logit_err": logit_err(prog_logits, pres[0]),
                     **{k: max(n[k] for n in num) for k in num[0]}}
    r.sync()
    res["ref_s"] = time.perf_counter() - t_ref
    if r.control:
        res["control"] = {"logit_err": logit_err(pres[1], pres[0]),
                          **{k: max(n[k] for n in ctl) for k in ctl[0]}}
    return res
