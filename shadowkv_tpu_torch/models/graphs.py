"""The compiled decode step: the port's counterpart of the JAX engine's
jitted decode programs (``decode_shadow_jit``, ``decode_full_fn`` and the
k-step ``decode_chunk_jit`` of ``shadowkv_tpu/models/engine.py``).

JAX traces a step once and dispatches the compiled program at every token.
Here a step is captured once as a ``torch.cuda.CUDAGraph`` and replayed:
one launch for the ~2,000 kernels of a 32-layer step, where the eager loop
issues each of them from Python. A graph freezes the addresses and the
Python values it saw at capture, so everything a step reads or writes
lives in buffers that outlast it:

- the cache, whose position (``ShadowCache.gen_len``, 0-d or one per slot,
  ``FullCache.length``) is a device tensor the step advances in place and
  a serving loop rewrites in place (an admission, the idle-slot clamp);
- ``StepGraphs``' token buffers: the input token ``tok`` [B], which the step
  overwrites with the next one, the step counter ``pos``, the history
  ``hist`` [cap, B] that the step writes at row ``pos``, and the
  teacher-forced rows ``forced_val`` / ``forced_on`` [cap, B] that it reads
  at row ``pos`` (JAX's ``decode_chunk_jit`` takes them as ``[k, B]``
  inputs of its scan). A run of steps therefore needs no host work between
  replays and no host read until its end.

Each decode path (fused refresh or XLA-gather branch, sampling settings,
generator) is its own graph; all graphs of one cache share the token
buffers, so ``use_pallas="auto"`` switches path between two replays. The
first step of a path runs eagerly, as a real step that moves the cache (a
capture records the work and runs none of it); the path is captured right
after it, and every later step replays the graph. On a CPU engine nothing
is captured: the same step function runs eagerly on the same buffers, as
it does on the card when the engine asks for eager steps (a gloo mesh,
whose collectives cannot be captured, and the pp pipeline).
A capture or replay that fails raises; nothing falls back to eager steps.

The kernel wrappers count their launches in Python, which a replay does
not run: each graph keeps the counts its capture added, the capture's own
increments are taken back, and every replay adds them again.

Each path is captured twice, into one memory pool: the plain graph, and a
marked twin that also holds the phase markers of ``utils/profiling.py``
(5 L + 3 empty kernels a step). A replay runs no Python, so the twin is how
a traced step shows its phases; it is replayed while a profiler records,
and the plain graph otherwise, so an untraced step runs no marker. Both
draw from the same generator and give the same tokens. Under a profiler
the host work is named: ``skv.decode.begin``, ``skv.decode.replay``,
``skv.decode.eager`` and ``skv.graph.capture`` (each capture).
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from shadowkv_tpu_torch.kernels import build
from shadowkv_tpu_torch.kernels.decode_attention import decode_attention
from shadowkv_tpu_torch.kernels.gather import gather_chunks, gather_v_rows
from shadowkv_tpu_torch.kernels.reconstruct import sparse_refresh
from shadowkv_tpu_torch.kernels.select import select_slots
from shadowkv_tpu_torch.utils import profiling

# (wrapper, counter attribute) of the kernels a decode step launches
COUNTERS = (
    (sparse_refresh, "launches"), (sparse_refresh, "host_launches"),
    (gather_chunks, "launches"), (gather_chunks, "host_launches"),
    (gather_v_rows, "launches"), (decode_attention, "launches"),
    (select_slots, "launches"),
)


def _counts() -> list[int]:
    return [getattr(fn, attr) for fn, attr in COUNTERS]


def _add_counts(delta: list[int], sign: int = 1) -> None:
    for (fn, attr), d in zip(COUNTERS, delta):
        setattr(fn, attr, getattr(fn, attr) + sign * d)


def _position(cache) -> torch.Tensor:
    """The cache's position tensor: ``ShadowCache.gen_len`` or
    ``FullCache.length``."""
    return cache.gen_len if hasattr(cache, "gen_len") else cache.length


class StepGraphs:
    """The token buffers of one cache's decode steps, the captured graph of
    each decode path over them, and a host record of every slot's position.

    ``depth`` [B] is that record: the cache's position (``gen_len``, or the
    full cache's ``length``) per slot, kept on the host from what the
    engine and its caller do (a prefill, each step, an admission, the
    idle-slot clamp), so no check reads the device. Each step books its
    positions first and raises, rather than writing out of bounds on the
    device, if a slot that still ``need``s positions would pass ``limit``
    (the gen region, or the full cache's max_length). With one position
    for the whole batch every slot needs every position; with per-slot
    depths (``slot_depths``) a slot needs them only up to the end its
    caller books at admission, and a finished slot that steps on to the
    end of a decode chunk has its rows clamped on the device
    (``cache/shadow.py``).

    The position tensor is the one object every captured graph reads: it
    is written only in place, and a step raises if the cache holds another
    one (a graph would read a dead buffer)."""

    def __init__(self, cache, batch: int, depth, limit: int, device,
                 eager: bool = False):
        """``depth``: the slots' present depth, one for all or [B] (a
        loaded checkpoint's ``gen_len``); ``eager`` runs every step eagerly
        on the card too."""
        self.eager = eager
        self.cache = cache
        self.position = _position(cache)
        self.depth = np.full(batch, depth, dtype=np.int64)
        self.need = np.full(batch, np.iinfo(np.int64).max)
        self.limit = limit
        self.rows = limit - int(self.depth.max())  # the longest run of steps
        self.run = 0  # steps of the current run
        self.stepped = False  # a step has run on this cache
        self.captures = 0  # CUDA graph captures: two a path
        self.device = torch.device(device)
        self.tok = torch.zeros(batch, dtype=torch.int32, device=device)
        self.pos = torch.zeros(1, dtype=torch.long, device=device)
        self.hist = torch.zeros(self.rows, batch, dtype=torch.int32,
                                device=device)
        self.forced_val = torch.zeros_like(self.hist)
        self.forced_on = torch.zeros(self.rows, batch, dtype=torch.bool,
                                     device=device)
        self._graphs: dict = {}

    def take(self, qn: int = 1) -> None:
        """Book ``qn`` positions on every slot (one step of ``qn`` tokens);
        raise first if a slot that needs them would pass the limit."""
        over = (self.depth < self.need) & (self.depth + qn > self.limit)
        if over.any():
            raise ValueError(
                f"slot depths {self.depth.tolist()} + {qn} exceed the "
                f"cache's {self.limit} decode positions")
        self.depth += qn
        self.stepped = True

    def slot_depths(self) -> None:
        """Give every slot its own depth: the cache's position becomes a
        [B] int32 device vector (JAX serving's ``gen_len=zeros((B,))``) at
        the present depth, which no slot needs until ``reset_slot`` books
        its end. Only before the first step: a graph bakes in the tensor it
        reads."""
        if not hasattr(self.cache, "gen_len"):
            raise ValueError("per-slot depths serve the shadow cache modes")
        if self.stepped:
            raise RuntimeError("per-slot depths must exist before the first "
                               "decode step")
        if self.position.dim() == 0:
            self.position = self.position.expand(len(self.depth)).clone()
            self.cache.gen_len = self.position
        self.need[:] = 0

    def reset_slot(self, slot: int, need: int) -> None:
        """Admission into ``slot``: its depth to 0 on the device (in place)
        and here, and the depth its request needs."""
        self.position[slot] = 0
        self.depth[slot] = 0
        self.need[slot] = need

    def clamp_idle(self, active, steps: int) -> None:
        """Pin every inactive slot's depth to at most ``limit - 1 - steps``
        so that ``steps`` more steps stay inside the region (JAX serving's
        idle-slot clamp); in place on the device."""
        active = np.asarray(active, bool)
        cap = self.limit - 1 - steps
        self.depth = np.where(active, self.depth,
                              np.minimum(self.depth, cap))
        pos = self.position
        pos.copy_(torch.where(torch.as_tensor(active, device=pos.device),
                              pos, pos.clamp(max=cap)))

    def begin(self, tokens: torch.Tensor, forced_val=None,
              forced_on=None) -> None:
        """Start a run at ``tokens`` [B]: the step counter to 0, and the
        teacher-forced rows ``forced_val``/``forced_on`` [k, B] (none by
        default). Device inputs cost no host sync."""
        with profiling.span(profiling.DECODE_BEGIN):
            self.tok.copy_(tokens)
            self.pos.zero_()
            self.run = 0
            self.forced_on.zero_()
            if forced_val is not None:
                k = forced_val.shape[0]
                if k > self.rows:
                    raise ValueError(f"{k} steps exceed the run capacity "
                                     f"{self.rows}")
                self.forced_val[:k].copy_(torch.as_tensor(forced_val))
                self.forced_on[:k].copy_(torch.as_tensor(forced_on))

    def record(self, sampled: torch.Tensor) -> None:
        """The end of a step: the forced token where this step's row asks
        for one (JAX ``decode_chunk_jit``: ``where(fm, fv, t2)``), written
        to the history and fed to the next step."""
        fv = self.forced_val.index_select(0, self.pos)[0]
        fm = self.forced_on.index_select(0, self.pos)[0]
        nxt = torch.where(fm, fv, sampled)
        self.hist.index_copy_(0, self.pos, nxt[None])
        self.tok.copy_(nxt)
        self.pos.add_(1)

    def drop_graphs(self) -> None:
        """Forget the captured graphs (and free their memory pools)."""
        self._graphs.clear()

    def step(self, key, body: Callable[[], torch.Tensor],
             generator: torch.Generator | None = None) -> torch.Tensor:
        """One step of the decode path ``key``; ``body`` runs the step on
        these buffers and returns its logits [B, V]. On the card the first
        step of a path runs ``body`` eagerly and then captures it (with
        ``generator``'s state registered, so that every replay draws new
        numbers); later steps replay, the marked twin while a profiler
        records. The returned logits are the replayed graph's static output:
        the next replay overwrites them."""
        if _position(self.cache) is not self.position:
            raise RuntimeError("the cache's position tensor was rebound; its "
                               "captured graphs would read a dead buffer")
        if self.run >= self.rows:
            raise ValueError(f"a run of more than {self.rows} steps")
        self.take(1)
        self.run += 1
        if self.device.type != "cuda" or self.eager:
            with profiling.span(profiling.DECODE_EAGER):
                return body()
        entry = self._graphs.get(key)
        if entry is None:
            with profiling.span(profiling.DECODE_EAGER):
                logits = body()
            plain = self._capture(body, generator)
            twin = self._capture(body, generator, pool=plain[0].pool(),
                                 marked=True)
            self._graphs[key] = (plain, twin)
            self.captures += 2
            return logits
        plain, twin = entry
        graph, logits, delta = twin if profiling.recording() else plain
        with profiling.span(profiling.DECODE_REPLAY):
            graph.replay()
        _add_counts(delta)
        return logits

    @staticmethod
    def _capture(body, generator, pool=None, marked: bool = False):
        graph = torch.cuda.CUDAGraph()
        if generator is not None:
            graph.register_generator_state(generator)
        before = _counts()
        with profiling.span(profiling.GRAPH_CAPTURE):
            with profiling.capturing(marked), \
                    torch.cuda.graph(graph, pool=pool):
                logits = body()
            # Uploaded now, not by the first replay (~5 ms of host time at
            # full size): the twin's first replay is a traced step's.
            build.check(build.library().shadowkv_graph_upload(
                graph.raw_cuda_graph_exec(),
                torch.cuda.current_stream().cuda_stream), "graph upload")
        delta = [a - b for a, b in zip(_counts(), before)]
        _add_counts(delta, -1)  # the capture launched nothing
        return graph, logits, delta
