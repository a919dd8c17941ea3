"""Closed-loop rounds of questions over long documents on a hybrid model
(the ``hybrid_rounds`` kind): the traffic of ``decode_rounds`` (its
docstring says how the window runs and is timed) on a configuration with
sliding and NoPE global layers and MoE layers (K-EXAONE's keys), whose
engine keeps ShadowKV state for the global layers and a ring of the window
for the sliding ones, and records the experts each row chooses.

A traced run profiles 12 steps from the window's 8th and keeps, beside the
selected chunk ids, every row's chosen experts at each traced step
(``obs["routes"]`` [steps, MoE layers, B, k]).

``correct``: two rows, one drawn from the seed in each half of the batch,
run through the plain reference (``reference/k_exaone.py``) along the
program's discrete choices: the global layers' outliers, seed and step
selections, and every MoE layer's chosen experts at every prompt position
and step (read from the cache after the prefill and after each step). The
numbers: ``gap``, ``select_regret`` and ``outlier_gap`` as in
``decode_rounds``; ``route_regret``, the worst share of the reference's
top-k mass of biased router scores that a chosen set misses; and
``ring_err``, the worst relative distance of the rings (keys and values of
the prompt's last W positions) that the prefill leaves in the sliding
layers of the first period from the reference's: the earliest state that
an error in a sliding layer's window reaches.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench import port_hybrid
from portbench.layout import layout
from portbench.reference import model as ref_model
from portbench.reference.compare import outlier_gap, select_regret, widest_gap
from portbench.reference.k_exaone import HybridRowRun, route_regret
from portbench.trace import Tracer
from portbench.weights import draw_sketch, token_gen, token_rng
from portbench.weights_hybrid import draw_hybrid

WARMUP_STEPS = 2  # of round 0, in set-up: the eager step and the capture
LAG = 2  # steps the host may run ahead of the card
TRACE_START, TRACE_STEPS = 8, 12  # the traced steps of the window
HALVES = 2  # one checked row drawn from each half of the batch
RING_LAYERS = 4  # ring_err reads the sliding layers among the first four


def ring_err(prog, ref) -> float:
    """The worst relative distance of rings ``prog`` (k, v [K, W, Dh]) from
    the reference's ``ref`` (the same, in one order of positions)."""
    return max(float((p.float() - q).norm() / q.norm())
               for p, q in zip(prog, ref))


def ring_in_order(ring, prompt_len: int, window: int):
    """The prompt's last ``window`` positions of a program ring (k or v
    [..., K, W', Dh], position p at row p % W'), in position order."""
    rows = torch.arange(prompt_len - window, prompt_len,
                        device=ring.device) % ring.shape[-2]
    return ring.index_select(-2, rows)


def run(r) -> dict:
    cfg, tr = r.cell.config, r.cell.traffic
    dev = r.device
    b, s = tr["batch"], tr["prompt_len"]
    nq, na = tr["question_len"], tr["answer_len"]
    per_round = nq + na
    if per_round != cfg["cache"]["gen_capacity"]:
        raise ValueError("a round must fill the gen region exactly")
    vocab = cfg["vocab_size"]
    w = draw_hybrid(cfg, r.seed, dev)
    sketch = draw_sketch({"num_kv_heads": cfg["num_key_value_heads"],
                          "head_dim": cfg["head_dim"]}, cfg["cache"],
                         r.seed, dev)
    r.lap("weights")
    prompts = token_rng(r.seed, 1).integers(0, vocab, (b, s))
    qgen = token_gen(r.seed, 2, dev)
    part = b // HALVES
    check = [k * part + int(x) for k, x in enumerate(
        token_rng(r.seed, 3).integers(part, size=HALVES))]

    eng = port_hybrid.engine(cfg, w, sketch, s, dev)
    eng.record_routes(check)
    pre_logits, cache = eng.prefill(prompts)
    pre_tok = pre_logits[:, -1].argmax(-1)
    eng.use_slot_depths(cache)
    r.lap("prefill")
    cuda = dev.type == "cuda"
    hy = cache.hybrid
    rows_t = torch.tensor(check, device=dev)
    prog_out = (~cache.landmark_mask[:, rows_t]).float().topk(
        cfg["cache"]["outlier_chunks"], dim=-1).indices  # [Lg, R, K, O]
    prog_seed = cache.cached_ids[:, rows_t].long()  # [Lg, R, K, S]
    pre_routes = hy.prefill_routes.clone()  # [Lm, R, S, k]
    n_ring = sum(t == "sliding_attention"
                 for t in cfg["layer_types"][:RING_LAYERS])
    win = cfg["sliding_window"]
    rings = [ring_in_order(x[:n_ring, rows_t], s, win)
             for x in (hy.base_k, hy.base_v)]  # [n, R, K, W, Dh]
    rounds, ends, sched = [], [], []
    ids_snap, routes_snap = [], []
    nxt = None

    def step(rnd: int, i: int):
        nonlocal nxt
        if i == 0:
            rounds.append(dict(
                q=torch.randint(0, vocab, (nq, b), generator=qgen,
                                device=dev, dtype=torch.int32),
                out=torch.empty(per_round, b, dtype=torch.int32, device=dev),
                ids=torch.empty((per_round, *prog_seed.shape),
                                dtype=torch.int16, device=dev),
                routes=torch.empty((per_round, hy.route_ids.shape[0],
                                    len(check), hy.route_ids.shape[2]),
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
        rec["routes"][i].copy_(hy.route_ids.index_select(1, rows_t))
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
            routes_snap.append(hy.route_ids.clone())
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
            trace=tracer.data(), model=cfg, cache=cfg["cache"], batch=b,
            layout=layout(cfg["cache"], s), depths=depths,
            ids=torch.stack(ids_snap).cpu().numpy(),
            routes=torch.stack(routes_snap).cpu().numpy(), v_on_host=False)

    # -- correct: the drawn rows through the reference ---------------------
    done = rnd - 1
    last = first + done * per_round
    used = rounds[:done + 1]
    n_used = [WARMUP_STEPS] + [per_round] * done
    out = torch.cat([rec["out"][:k] for rec, k in zip(used, n_used)])
    ids_rec = torch.cat([rec["ids"][:k] for rec, k in zip(used, n_used)])
    routes_rec = torch.cat([rec["routes"][:k]
                            for rec, k in zip(used, n_used)])  # [T, Lm, R, k]
    q_host = torch.stack([rec["q"] for rec in used]).cpu().numpy()
    outs = out[:, check].long().T
    outs_host = outs.cpu().numpy()
    pre_tok = pre_tok[check].long()
    del eng, cache, hy, pre_logits, out, rounds, ends
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
                  "steps": ids_rec[:last, :, j].long(),
                  "routes": torch.cat([pre_routes[:, j].long(),
                                       routes_rec[:last, :, j].long()
                                       .transpose(0, 1)], 1)}
        return HybridRowRun(cfg, cfg["cache"], w, sketch,
                            torch.as_tensor(prompts[check[j]], device=dev),
                            torch.as_tensor(fed, device=dev),
                            torch.as_tensor(sc[:, 1], device=dev),
                            torch.as_tensor(sc[:, 0], device=dev), prec,
                            follow)

    def gap(ref, pre_choice, dec_choice):
        return max(widest_gap(ref[0][None], pre_choice[None]),
                   widest_gap(ref[1][judged], dec_choice[judged]))

    ref_model.no_tf32()
    t_ref = time.perf_counter()
    names = ("gap", "select_regret", "outlier_gap", "route_regret",
             "ring_err")
    num = {k: [] for k in names}
    ctl = {k: [] for k in names}
    agree = []
    for j in range(len(check)):
        runs = [row_run(j, "f32")] + ([row_run(j, "fp8")] if r.control
                                      else [])
        si = 0
        for sts in zip(*(x.run_layers() for x in runs)):
            layer, gi, mi, st = sts[0]
            if gi is not None:
                num["outlier_gap"].append(outlier_gap(st.out_score,
                                                      prog_out[gi, j]))
                num["select_regret"].append(max(
                    select_regret(st.seed_p, prog_seed[gi, j]),
                    select_regret(st.steps_p, ids_rec[:last, gi, j])))
                if r.control:
                    c = sts[1][3]
                    ctl["outlier_gap"].append(outlier_gap(st.out_score,
                                                          c.out_own))
                    ctl["select_regret"].append(max(
                        select_regret(st.seed_p, c.seed_own),
                        select_regret(st.steps_p, c.steps_own)))
            if mi is not None:
                chosen = runs[0].follow["routes"][mi]
                num["route_regret"].append(route_regret(
                    st.route_s, w["e_bias"][mi], chosen))
                if r.control:
                    ctl["route_regret"].append(route_regret(
                        st.route_s, w["e_bias"][mi], sts[1][3].route_own))
            if st.kind == "sliding" and si < n_ring:
                num["ring_err"].append(ring_err(
                    (rings[0][si, j], rings[1][si, j]), st.ring))
                if r.control:
                    ctl["ring_err"].append(ring_err(sts[1][3].ring, st.ring))
            si += st.kind == "sliding"
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
