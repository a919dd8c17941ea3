"""Continuous batching for long-context decode (counterpart of
``shadowkv_tpu/serving.py``).

``Engine.batch_generate`` drives a static batch: the sequences prefill
together, decode in lockstep, and the batch ends when the longest request
does, so a finished sequence strands its slot. ``ContinuousBatcher`` keeps
the decode batch full: when a slot's request completes, the next queued
request is prefilled into that slot of the live cache
(``Engine.admit_slot``) and decoding resumes with the other slots' state
untouched. Each slot sits at its own generation depth (``gen_len`` is a
[B] device vector, written only in place), so the decode chunks keep
replaying the captured step (``models/graphs.py``) across every
admission. Attention is per sequence: a slot's greedy tokens equal its
request's run on its own at the same batch shape.

Requests that share a long context (``context_id``) prefill it once; the
slot's state is snapshotted (``Engine._extract_slot``, with the slot's
host V rows in offload mode) and later admissions restore the snapshot and
teacher-force their suffix through the decode chunks' forced rows,
interleaved with the other slots' decoding.

Semantics follow the JAX batcher line for line: one prefix length for all
requests, ``gen_len + suffix <= gen_capacity``, a fixed chunk of
``k = min(max_dispatch | steps_per_dispatch, gen_capacity - 1)`` steps per
host sync, the idle-slot depth clamp, the bookkeeping replayed in step
order after each chunk, and admission time booked behind a device sync.
Sampling draws from the engine's ``torch.Generator`` seeded with ``seed``
(JAX splits a PRNG key), so sampled tokens differ from JAX's; greedy ones
do not.

Over a (dp, tp) mesh every rank runs this same host-side schedule on the
whole batch: the engine's slot operations take global slots, the dp shard
that holds a slot prefills an admission with its tp ranks and broadcasts
its logits, and every rank samples the whole batch from the same
generator. sp and pp meshes are refused, as in JAX. A shared-prefix
snapshot stays on the dp shard that took it (each tp rank its heads);
every rank keeps the context's entry and the slot it came from, and a
restore into another shard's slot sends the snapshot there
(``Engine._move_slot``), where JAX's global cache restores in place.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional, Sequence

import numpy as np

from shadowkv_tpu_torch.core.sampling import sample_token
from shadowkv_tpu_torch.models.engine import Engine


@dataclasses.dataclass
class Request:
    uid: int
    input_ids: np.ndarray  # [S] prompt tokens
    gen_len: int  # tokens to generate (incl. the first sampled one)
    # Shared prefix: requests with one context_id share their first
    # context_len prompt tokens (the document); the rest of input_ids is
    # the request's suffix (the question), teacher-forced through decode.
    context_id: Optional[int] = None
    context_len: Optional[int] = None


@dataclasses.dataclass
class ServeStats:
    # wall_seconds covers the serve loop with its admissions (the initial
    # batch prefill is outside it); decode_seconds is wall less admissions.
    wall_seconds: float = 0.0
    decode_steps: int = 0
    completed_requests: int = 0
    completed_tokens: int = 0
    admissions: int = 0  # mid-stream slot refills (not the first batch)
    chunks: int = 0  # decode dispatches (host syncs) in the loop
    prefill_seconds: float = 0.0  # initial batch + admissions
    admission_seconds: float = 0.0  # admissions only (inside the loop)
    context_hits: int = 0  # admissions served from a context snapshot
    context_prefills: int = 0  # contexts prefilled + snapshotted
    forced_tokens: int = 0  # suffix tokens teacher-forced in-loop

    @property
    def decode_seconds(self) -> float:
        return max(0.0, self.wall_seconds - self.admission_seconds)

    @property
    def tokens_per_second(self) -> float:
        """End-to-end serve throughput (admission stalls included)."""
        if self.wall_seconds == 0:
            return 0.0
        return self.completed_tokens / self.wall_seconds

    @property
    def decode_tokens_per_second(self) -> float:
        if self.decode_seconds == 0:
            return 0.0
        return self.completed_tokens / self.decode_seconds


class ContinuousBatcher:
    """Slot-based continuous batching over one Engine: greedy or sampled
    decoding of a request stream with ``slots`` concurrent sequences;
    finished slots are refilled from the queue without disturbing the
    others."""

    def __init__(
        self,
        engine: Engine,
        slots: int = 1,
        temperature: float = 0.0,
        top_k: int = 50,
        top_p: float = 0.9,
        stop_ids: tuple[int, ...] = (),
        seed: int = 0,
        max_contexts: int = 2,
        steps_per_dispatch="auto",
        max_dispatch: int = 64,
    ):
        if engine.cache_cfg.mode not in ("shadow", "shadow_offload"):
            raise ValueError("continuous batching serves the shadow cache "
                             "modes")
        if engine.rt.sp > 1:
            raise ValueError(
                "continuous batching over an sp mesh is unsupported: "
                "admission prefills one slot, but the sequence-parallel "
                "prefill is whole-batch with the cache batch-sharded over "
                "(dp, sp)")
        if engine.rt.pp > 1:
            raise ValueError(
                "continuous batching over a pp mesh is unsupported: "
                "admission prefills one slot, but the pp prefill is a "
                "whole-batch pipeline")
        self.engine = engine
        self.slots = slots
        self.sample_args = (temperature, top_k, top_p)
        self.stop_ids = stop_ids
        self.seed = seed
        # Steps per host sync: every chunk is one run of k replays of the
        # captured step and one read of its tokens. A slot that finishes
        # mid-chunk idles to the chunk's end and frees at its boundary.
        # 'auto' and an integer both give a fixed k (see run).
        self.steps_per_dispatch = (
            "auto"
            if steps_per_dispatch == "auto"
            else max(1, int(steps_per_dispatch))
        )
        self.max_dispatch = max(1, int(max_dispatch))
        # Shared-prefix snapshots: context_id -> (prefix fingerprint,
        # last-prefix-token logits [1, 1, V], one-slot cache, host V rows
        # or None, the slot it was taken from); at most max_contexts of
        # them, least recently used evicted first. On a dp shard that does
        # not hold the slot, the cache and the rows are None.
        self.max_contexts = max_contexts
        self._ctx: dict = {}

    def run(self, requests: Sequence[Request]) -> tuple[dict, ServeStats]:
        """Serve ``requests`` to completion. Returns
        ({uid: np.ndarray generated tokens}, ServeStats)."""
        eng = self.engine
        stats = ServeStats()
        queue = list(requests)
        if not queue:
            raise ValueError("no requests")

        def prefix_len(r: Request) -> int:
            return (
                r.context_len
                if r.context_id is not None
                else len(r.input_ids)
            )

        def split(r: Request):
            p = prefix_len(r)
            return r.input_ids[:p], [int(t) for t in r.input_ids[p:]]

        s = prefix_len(queue[0])
        if not all(prefix_len(r) == s for r in queue):
            raise ValueError(
                "all requests must share one prefill length: the shadow "
                "layout is static per prefill length (for context requests "
                "that is context_len; suffixes ride the gen region)")
        offload = eng.cache_cfg.mode == "shadow_offload"
        cap = eng.cache_cfg.gen_capacity
        if not all(r.gen_len + len(split(r)[1]) <= cap for r in queue):
            raise ValueError("gen_len + suffix length must fit gen_capacity")
        n_slots = min(self.slots, len(queue))

        gen = eng._generator(self.seed)
        results: dict = {}
        slot_req: list[Optional[Request]] = [None] * n_slots
        slot_tokens: list[list[int]] = [[] for _ in range(n_slots)]
        # teacher-forced suffix tokens still to consume, per slot
        slot_forced: list[list[int]] = [[] for _ in range(n_slots)]

        def fingerprint(prefix: np.ndarray):
            return hash(np.asarray(prefix, np.int32).tobytes())

        def snapshot_context(r: Request, lg_row, cache, i):
            """LRU-insert slot i's prefilled state for r.context_id, with
            the slot's host V rows in offload mode."""
            if r.context_id is None or r.context_id in self._ctx:
                return
            if len(self._ctx) >= self.max_contexts:
                self._ctx.pop(next(iter(self._ctx)))  # evict LRU
            prefix, _ = split(r)
            self._ctx[r.context_id] = (
                fingerprint(prefix),
                lg_row.clone(),
                eng._extract_slot(cache, i),
                eng.host_slot_rows(i) if offload else None,
                i,
            )
            stats.context_prefills += 1

        def need(r: Request) -> int:
            """Decode steps the request takes in its slot: its suffix, then
            gen_len - 1 more (the last token is never fed back)."""
            return len(split(r)[1]) + r.gen_len - 1

        # --- initial batch prefill (all slots at once) ---
        t0 = time.perf_counter()
        first = [queue.pop(0) for _ in range(n_slots)]
        ids = np.stack([split(r)[0] for r in first])
        logits, cache = eng.prefill(ids)
        eng.use_slot_depths(cache)  # per-slot depths, before any capture
        for i, r in enumerate(first):
            slot_req[i] = r
            eng.reset_slot_depth(i, need(r))
        for i, r in enumerate(first):
            snapshot_context(r, logits[i:i + 1], cache, i)
        tokens = sample_token(logits[:, -1], gen, *self.sample_args)  # [B]
        eng._sync()
        stats.prefill_seconds += time.perf_counter() - t0

        def finish(i):
            r = slot_req[i]
            results[r.uid] = np.asarray(slot_tokens[i], np.int32)
            stats.completed_requests += 1
            stats.completed_tokens += len(slot_tokens[i])
            slot_tokens[i] = []
            slot_req[i] = None

        def record(i, tok: int):
            """Record a freshly sampled token for slot i (every sampled
            token is recorded before the next decode step consumes it).
            Returns True if the slot finished."""
            r = slot_req[i]
            slot_tokens[i].append(tok)
            if len(slot_tokens[i]) >= r.gen_len or (
                self.stop_ids and tok in self.stop_ids
            ):
                finish(i)
                return True
            return False

        def start_suffix(i, suffix):
            """The first suffix token becomes slot i's next input; the rest
            wait in slot_forced and override the sampled token step by
            step. The first generated token is the sampled output of the
            step that consumes the last suffix token."""
            tokens[i] = suffix[0]
            slot_forced[i] = list(suffix[1:])
            stats.forced_tokens += len(suffix)

        def admit(i):
            """Prefill (or restore a context snapshot for) the next queued
            request into slot i of the live cache, set up its first input
            token, and record its first generated token when there is no
            suffix. Loops while a request finishes on its first token."""
            nonlocal cache
            while queue and slot_req[i] is None:
                r = queue.pop(0)
                t1 = time.perf_counter()
                prefix, suffix = split(r)
                hit = r.context_id is not None and r.context_id in self._ctx
                if hit:
                    entry = self._ctx.pop(r.context_id)
                    fp, lg, small, host_rows, src = entry
                    if fp != fingerprint(prefix):
                        raise ValueError(
                            f"context_id {r.context_id} reused with a "
                            "different prefix")
                    self._ctx[r.context_id] = entry
                    if offload:
                        # the snapshot's V store is a placeholder; the
                        # slot's rows restore into the host store
                        cache = eng._merge_slots(cache, small, i, src=src)
                        eng.set_host_slot_rows(host_rows, i, src=src)
                    else:
                        cache = eng._merge_slots_v(cache, small, i, src=src)
                    stats.context_hits += 1
                else:
                    lg, cache = eng.admit_slot(cache, prefix, i)
                    snapshot_context(r, lg, cache, i)
                eng.reset_slot_depth(i, need(r))
                slot_req[i] = r
                stats.admissions += 1
                # Book the admission's execution here, not in the next
                # chunk's sync: the depth write is the last of it.
                eng._sync()
                if suffix:
                    start_suffix(i, suffix)
                    span = time.perf_counter() - t1
                    stats.prefill_seconds += span
                    stats.admission_seconds += span
                else:
                    tok = sample_token(lg[:, -1], gen, *self.sample_args)
                    tokens[i] = tok[0]
                    span = time.perf_counter() - t1
                    stats.prefill_seconds += span
                    stats.admission_seconds += span
                    record(i, int(tok[0]))

        t_loop = time.perf_counter()
        # first input per initial slot: the prefill-sampled token
        # (recorded as generated) or the request's first suffix token
        toks0 = tokens.cpu().numpy()
        for i in range(n_slots):
            _, suffix = split(slot_req[i])
            if suffix:
                start_suffix(i, suffix)
            elif record(i, int(toks0[i])):
                admit(i)

        # One fixed chunk length per serve run (JAX: the scan length is
        # static; here every chunk is a run of replays of one graph).
        k_steps = min(
            self.max_dispatch
            if self.steps_per_dispatch == "auto"
            else self.steps_per_dispatch,
            cap - 1,
        )

        while any(r is not None for r in slot_req):
            # idle slots (queue drained) keep stepping harmlessly; pin
            # their depth low enough that k_steps of growth stay inside
            # the gen region (their rows are never read).
            eng.clamp_idle_depths([r is not None for r in slot_req], k_steps)

            # --- k steps, then one sync. Teacher-forced overrides are
            #     scheduled in advance (forced queues only fill at
            #     admissions, which happen between chunks) ---
            forced_at = set()  # (step, slot) pairs the replay must skip
            for i, r in enumerate(slot_req):
                if r is not None:
                    for t in range(min(len(slot_forced[i]), k_steps)):
                        forced_at.add((t, i))
            fv = np.zeros((k_steps, n_slots), np.int32)
            fm = np.zeros((k_steps, n_slots), bool)
            for t, i in forced_at:
                fv[t, i] = slot_forced[i][t]
                fm[t, i] = True
            tokens, toks = eng.decode_chunk(
                cache, tokens, fv, fm, gen, *self.sample_args)
            stats.decode_steps += k_steps
            toks_all = toks.numpy()  # [k, B] (the one sync)
            stats.chunks += 1

            # --- replay the bookkeeping in step order (a slot finishing
            #     mid-chunk ignores its later steps and admits at the
            #     chunk boundary) ---
            for i in range(n_slots):
                consumed = min(len(slot_forced[i]), k_steps)
                slot_forced[i] = slot_forced[i][consumed:]
            for t in range(k_steps):
                for i, r in enumerate(slot_req):
                    if r is None or (t, i) in forced_at:
                        continue
                    record(i, int(toks_all[t, i]))
            for i in range(n_slots):
                if slot_req[i] is None and queue:
                    admit(i)

        eng._sync()
        stats.wall_seconds = time.perf_counter() - t_loop
        return results, stats
