"""Closed-loop rounds of questions over long documents (the ``decode_rounds``
kind): a batch job that asks question after question about each of
``batch`` documents, as RULER-style multi-query evaluation does.

Set-up draws the weights, the sketch and ``batch`` documents of
``prompt_len`` ids from the seed, prefills them into one shadow cache and
gives every slot its own depth. Each round then resets every slot's depth
(the prior question and answer are dropped, the document stays), feeds
``question_len`` ids drawn from the seed through ``Engine.decode_step`` and
then ``answer_len`` greedy tokens, each fed back from the step before; a
round fills the cache's gen region exactly. The first two steps of a round
0 run in set-up (the first step runs eagerly and captures the CUDA graph
that every later step replays).

The window: a CUDA event after every step, the host kept at most two
steps ahead of the card, until ``--seconds`` have passed on the host
clock; then one synchronize. A round's questions are drawn on the card and
its records (tokens, chunk ids, events) allocated as it starts, so the
window has no cap. ``decode_tok_s`` is every row's decoded positions over
the window's wall time; ``itl_p95_ms`` the 95th percentile of the gaps
between consecutive step-end events over all steps. A traced run profiles
12 steps from the window's 8th and snapshots the cache's selected chunk ids
around each.

``correct``: two rows, one drawn from the seed in each half of the batch,
are run through the plain reference (``reference/shadow.py``): each row's
prompt and every step fed since the prefill, teacher-forced, along the
program's own discrete choices (its outlier chunks, its seed selection and
each step's selected chunks, read from the cache after the prefill and
after every step). Every greedy token the program chose in those rows (the
prefill's and each step's of the rounds that finished in the window) is
judged by the widest gap below the reference's best logit (``gap``); each
choice by the reference's scores: the selections by the score mass they
miss (``select_regret``), the outliers by how far below the reference's
threshold they lie (``outlier_gap``).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench import port
from portbench.layout import layout
from portbench.reference import model as ref_model
from portbench.reference.compare import outlier_gap, select_regret, widest_gap
from portbench.reference.shadow import RowRun
from portbench.trace import Tracer
from portbench.weights import draw_sketch, draw_weights, token_gen, token_rng

WARMUP_STEPS = 2  # of round 0, in set-up: the eager step and the capture
LAG = 2  # steps the host may run ahead of the card
TRACE_START, TRACE_STEPS = 8, 12  # the traced steps of the window
HALVES = 2  # one checked row drawn from each half of the batch


def run(r) -> dict:
    cfg, tr = r.cell.config, r.cell.traffic
    md, dev = cfg["model"], r.device
    b, s = tr["batch"], tr["prompt_len"]
    nq, na = tr["question_len"], tr["answer_len"]
    per_round = nq + na
    if per_round != cfg["cache"]["gen_capacity"]:
        raise ValueError("a round must fill the gen region exactly")
    w = draw_weights(md, cfg["init"], r.seed, dev)
    sketch = draw_sketch(md, cfg["cache"], r.seed, dev)
    r.lap("weights")
    prompts = token_rng(r.seed, 1).integers(0, md["vocab_size"], (b, s))
    qgen = token_gen(r.seed, 2, dev)
    part = b // HALVES
    check = [k * part + int(x) for k, x in enumerate(
        token_rng(r.seed, 3).integers(part, size=HALVES))]

    eng = port.engine(cfg, w, sketch, s, dev)
    pre_logits, cache = eng.prefill(prompts)
    pre_tok = pre_logits[:, -1].argmax(-1)
    eng.use_slot_depths(cache)
    r.lap("prefill")
    cuda = dev.type == "cuda"
    # The program's discrete choices in the checked rows: outliers and seed
    # after the prefill, each step's selected chunks (int16: chunk ids of
    # prompts up to 262,136 ids fit)
    rows_t = torch.tensor(check, device=dev)
    prog_out = (~cache.landmark_mask[:, rows_t]).float().topk(
        cfg["cache"]["outlier_chunks"], dim=-1).indices  # [L, R, K, O]
    prog_seed = cache.cached_ids[:, rows_t].long()  # [L, R, K, S]
    rounds = []  # per round: its questions, tokens, chunk ids, step ends
    ends = []  # every step's end event
    sched = []  # (round, depth) of each step
    ids_snap = []  # traced run: selected ids around each traced step
    nxt = None

    def step(rnd: int, i: int):
        nonlocal nxt
        if i == 0:
            rounds.append(dict(
                q=torch.randint(0, md["vocab_size"], (nq, b), generator=qgen,
                                device=dev, dtype=torch.int32),
                out=torch.empty(per_round, b, dtype=torch.int32, device=dev),
                ids=torch.empty((per_round, *prog_seed.shape),
                                dtype=torch.int16, device=dev),
                ends=[torch.cuda.Event(enable_timing=True)
                      for _ in range(per_round)] if cuda else []))
            for slot in range(b):
                eng.reset_slot_depth(slot, per_round)
        rec = rounds[rnd]
        tok = rec["q"][i] if i < nq else nxt
        nxt, _ = eng.decode_step(cache, tok)
        rec["out"][i].copy_(nxt)
        rec["ids"][i].copy_(cache.cached_ids.index_select(1, rows_t))
        if cuda:
            rec["ends"][i].record()
            ends.append(rec["ends"][i])
        sched.append((rnd, i))

    for i in range(WARMUP_STEPS):  # round 0: eager step, capture
        step(0, i)
    r.sync()
    r.mark_setup()

    tracer = Tracer(dev) if r.trace else None
    t_lo, t_hi = TRACE_START, TRACE_START + TRACE_STEPS
    first = len(sched)
    rnd, i = 1, 0
    t0 = time.perf_counter()
    while True:
        n = len(sched) - first
        if tracer is not None and n == t_lo:
            ids_snap.append(cache.cached_ids.clone())
            tracer.start()
        step(rnd, i)
        if tracer is not None and t_lo <= n < t_hi:
            ids_snap.append(cache.cached_ids.clone())
            if n == t_hi - 1:
                tracer.stop()
        if cuda and len(sched) - LAG > first:
            ends[-LAG - 1].synchronize()
        i += 1
        if i == per_round:
            rnd, i = rnd + 1, 0
        if time.perf_counter() - t0 >= r.seconds and rnd > 1 and (
                tracer is None or n >= t_hi):
            break
    r.sync()
    wall = time.perf_counter() - t0
    steps = len(sched)
    n_win = steps - first
    res = {"attempted": b * (rnd if i else rnd - 1), "failed": 0}
    res["e2e"] = {"decode_tok_s": b * n_win / wall}
    if cuda:
        gaps = [ends[k].elapsed_time(ends[k + 1])
                for k in range(first - 1, steps - 1)]
        res["e2e"]["itl_p95_ms"] = float(np.percentile(gaps, 95))
    res["memory_peak_bytes"] = r.memory_peak()
    if tracer is not None:
        depths = [sched[first + k][1] for k in range(t_lo, t_hi)]
        res["obs"] = dict(
            trace=tracer.data(), model=md, cache=cfg["cache"], batch=b,
            layout=layout(cfg["cache"], s), depths=depths,
            ids=torch.stack(ids_snap).cpu().numpy(),
            v_on_host=cfg["cache"]["mode"] == "shadow_offload")

    # -- correct: the drawn rows through the reference ---------------------
    done = rnd - 1  # rounds of the window that finished
    last = first + done * per_round  # steps up to the end of those rounds
    used = rounds[:done + 1]  # round 0's warm-up steps, then whole rounds
    n_used = [WARMUP_STEPS] + [per_round] * done
    out = torch.cat([rec["out"][:k] for rec, k in zip(used, n_used)])
    ids_rec = torch.cat([rec["ids"][:k] for rec, k in zip(used, n_used)])
    q_host = torch.stack([rec["q"] for rec in used]).cpu().numpy()
    outs = out[:, check].long().T  # [rows, T]
    outs_host = outs.cpu().numpy()
    pre_tok = pre_tok[check].long()
    del eng, cache, pre_logits, out, rounds, ends
    r.free()
    sc = np.array(sched[:last]).reshape(-1, 2)
    judged = torch.zeros(last, dtype=torch.bool, device=dev)
    judged[first:] = True
    res["judged_tokens"] = len(check) * (int(judged.sum()) + 1)

    def row_run(j, prec):
        fed = np.empty(last, dtype=np.int64)
        for k, (rr, ii) in enumerate(sc):
            fed[k] = q_host[rr, ii, check[j]] if ii < nq \
                else outs_host[j, k - 1]
        follow = {"outliers": prog_out[:, j], "seed": prog_seed[:, j],
                  "steps": ids_rec[:last, :, j].long()}
        return RowRun(md, cfg["cache"], w, sketch,
                      torch.as_tensor(prompts[check[j]], device=dev),
                      torch.as_tensor(fed, device=dev),
                      torch.as_tensor(sc[:, 1], device=dev),
                      torch.as_tensor(sc[:, 0], device=dev), prec, follow)

    def gap(ref, pre_choice, dec_choice):
        return max(widest_gap(ref[0][None], pre_choice[None]),
                   widest_gap(ref[1][judged], dec_choice[judged]))

    def choices(st, out_ids, seed_ids, step_ids):
        return (outlier_gap(st.out_score, out_ids),
                max(select_regret(st.seed_p, seed_ids),
                    select_regret(st.steps_p, step_ids)))

    ref_model.no_tf32()
    t_ref = time.perf_counter()
    num = {"gap": [], "select_regret": [], "outlier_gap": []}
    ctl = {k: [] for k in num}
    agree = []
    for j in range(len(check)):
        runs = [row_run(j, "f32")] + ([row_run(j, "fp8")] if r.control
                                      else [])
        for l, sts in enumerate(zip(*(x.run_layers() for x in runs))):
            o, s_ = choices(sts[0], prog_out[l, j], prog_seed[l, j],
                            ids_rec[:last, l, j])
            num["outlier_gap"].append(o)
            num["select_regret"].append(s_)
            if r.control:
                o, s_ = choices(sts[0], sts[1].out_own, sts[1].seed_own,
                                sts[1].steps_own)
                ctl["outlier_gap"].append(o)
                ctl["select_regret"].append(s_)
        ref = runs[0].logits()
        num["gap"].append(gap(ref, pre_tok[j], outs[j]))
        agree.append(float((ref[1][judged].argmax(-1) == outs[j][judged])
                           .float().mean()))
        if r.control:
            c = runs[1].logits()
            ctl["gap"].append(gap(ref, c[0].argmax(-1), c[1].argmax(-1)))
        del runs
    r.sync()
    res["ref_s"] = time.perf_counter() - t_ref
    res["checks"] = {k: max(v) for k, v in num.items()}
    res["agree"] = min(agree)
    if r.control:
        res["control"] = {k: max(v) for k, v in ctl.items()}
    return res
