"""The inference engine: prefill + autoregressive decode loops
(counterpart of ``shadowkv_tpu/models/engine.py``).

The engine runs on ``device="cuda"`` unless the caller passes another
device; asking for CUDA on a machine without one raises, it never falls
back to the CPU. Prefill runs in sub-batches into one preallocated cache.

Decode goes through the compiled step (``models/graphs.py``), the
counterpart of the JAX engine's jitted step programs: on the card each
decode path's step (``_decode`` and the sampling) is captured once as a
CUDA graph after one eager step and then replayed, one launch per token;
on a CPU engine the same step function runs eagerly on the same buffers.
``generate`` and ``batch_generate`` read their tokens back once, at the end
of the loop (``generate`` each step only to stop a batch of one early).
``decode_chunk`` runs k steps with teacher-forced rows and one host read
(JAX ``decode_chunk_jit``). A new prefill drops the graphs; so does
``set_debug_hit_rate``. ``use_pallas="auto"`` switches between the graphs
of the fused refresh and of the XLA-gather branch on the sampled slot hit
rate (JAX ``_auto_observe``). Decode runs on the live cache, the one of the
last prefill; the engine keeps each slot's depth on the host
(``StepGraphs.depth``) and checks every step against it without reading
the device.

Continuous batching (``serving.py``) drives the slot operations of the
live cache without dropping its graphs: per-slot generation depths
(``use_slot_depths``, ``reset_slot_depth``, ``clamp_idle_depths``, each an
in-place write of ``gen_len``), ``admit_slot`` (a one-sequence prefill into
one slot, V on the card or in the host store), and the shared-prefix
snapshots (``_extract_slot``, ``_merge_slots``, ``_merge_slots_v``,
``host_slot_rows``, ``set_host_slot_rows``). ``generate(cont=True)``
continues a chat turn from the previous call's cache.

``mode="shadow_offload"`` keeps the V store in host memory: one tensor,
pinned when the engine runs on the card (a plain CPU tensor on a CPU
engine, so the same code runs in the tests), allocated at prefill. Each
layer of each prefill sub-batch copies its V rows straight into it, so the
full-batch V store is never on the card; the JAX engine instead prefills a
sub-batch's whole V store on the device and evicts it after the sub-batch.
Decode reads the host store in place through the fused refresh kernel
(misses only), the chunk-gather kernel (every selected chunk) or, with
neither kernel on a bf16 store, the XLA-gather branch, whose V rows are
the missed chunks only, read by the port's ``gather_v_rows`` kernel (JAX's
``HostVStore`` io_callback path, ``_offload_v``); no host copy enters the
decode step. An admission prefills straight into its slot of the live
store, and a snapshot is one slot of it copied to a pinned tensor. With
``offload_prefill_segments > 1`` (JAX ``_prefill_offload_segmented``) the
whole batch is prefilled in one call; the store is then recorded as
sharded over layers and refuses admissions, as JAX's does. JAX runs the
layers in segments so that one segment's V store, staged on the device,
fits beside the rest; here each layer's V rows already go straight into
the pinned store, so no segment is staged and the call is the ordinary
prefill over the whole batch.

Context checkpoints (``save_state`` / ``load_state``,
``utils/checkpoint.py``) write the live shadow cache to one file and load
it as the engine's live cache, V on the card or in the host store
whichever way it was saved; ``generate(cont=True)`` then continues it.

Parallelism (``RuntimeConfig.dp/tp/sp/pp``, ``parallel/``): one engine per
rank, one process per rank, each holding its shard of the weights, the
cache and the batch (``parallel/mesh.py``), with the JAX engine's
composition rules. The engine's interface stays the whole batch's: prefill
takes every prompt row and returns every row's logits, ``generate`` returns
every row's tokens, and the slot operations take global slot indices; each
rank works on its own rows and heads and the rows meet by all-gathers over
the batch shards. Each rank samples its rows from the whole batch's draws
(``core/sampling.py``), so a dp run samples what one device samples. On the
card a decode step and its collectives are one CUDA graph under NCCL; a
gloo mesh on the card needs ``eager_decode`` (its collectives run on the
host), and the pp pipeline always steps eagerly. A context checkpoint is
the whole cache at its global shape whatever mesh wrote it, and loads on
any mesh or one device (``utils/checkpoint.py``). A shared-prefix snapshot
stays on the dp shard that took it; a restore into another shard's slot
sends it there, one tensor at a time (``_move_slot``).

A hybrid model (``ModelConfig.is_hybrid``: sliding and NoPE global layers,
EXAONE 4's block, MoE layers; K-EXAONE) runs the same prefill and compiled
step (``models/forward.py`` dispatches per layer): its cache (ShadowKV or
full) holds only the full-attention layers, and ``cache.hybrid``
(``cache/hybrid.py``) the sliding layers' rings and the experts each row
chose (the prompt's, for the rows given to ``record_routes`` before the
prefill). A reset of a slot's depth puts the slot's prefill rings back.
It runs on one device with V on the card: a mesh, ``shadow_offload``,
slot admission, snapshots and context checkpoints are refused.

Under a profiler the engine names its host work (``utils/profiling.py``):
``skv.prefill`` around a prefill and ``skv.prefill.batch`` around each
sub-batch; ``skv.decode.step`` around each decode step of every loop
(``decode_step``, ``decode_chunk``, ``generate``, ``batch_generate``),
``skv.decode.eager`` around an eager step; a step's device phases end at
the ``end`` marker, after its token is recorded.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from shadowkv_tpu_torch.cache.full import FullCache
from shadowkv_tpu_torch.cache.hybrid import HybridState
from shadowkv_tpu_torch.cache.shadow import ShadowCache, ShadowLayout
from shadowkv_tpu_torch.config import CacheConfig, ModelConfig, RuntimeConfig
from shadowkv_tpu_torch.core import minference as mi
from shadowkv_tpu_torch.core import rope as rope_lib
from shadowkv_tpu_torch.core.layers import ModelParams
from shadowkv_tpu_torch.core.sampling import sample_token
from shadowkv_tpu_torch.models import forward
from shadowkv_tpu_torch.models.graphs import StepGraphs
from shadowkv_tpu_torch.parallel import mesh as mesh_lib
from shadowkv_tpu_torch.parallel import pipeline
from shadowkv_tpu_torch.utils import checkpoint
from shadowkv_tpu_torch.utils import profiling as prof


@dataclasses.dataclass
class GenerationStats:
    prefill_seconds: float = 0.0
    decode_seconds: float = 0.0
    prefill_tokens: int = 0
    decode_tokens: int = 0

    @property
    def decode_tokens_per_second(self) -> float:
        if self.decode_seconds == 0:
            return 0.0
        return self.decode_tokens / self.decode_seconds


def _check_hybrid(model: ModelConfig, cache: CacheConfig,
                  rt: RuntimeConfig) -> None:
    """What the hybrid forward serves: one device, V on the card, the
    dense prefill (sliding layers take their window by kernel C)."""
    if rt.mesh_size > 1:
        raise ValueError("models with sliding or MoE layers run on one "
                         "device: dp, tp, sp and pp must be 1")
    if cache.mode == "shadow_offload":
        raise ValueError("models with sliding or MoE layers keep V on the "
                         "card: mode 'shadow_offload' is not served")
    if rt.prefill_pattern not in ("dense", "dense-splash"):
        raise ValueError("models with sliding or MoE layers prefill their "
                         "full-attention layers densely")


def _resolve_device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "Engine(device='cuda') needs a CUDA device and none is available; "
            "pass device='cpu' to run the plain kernel versions on the CPU"
        )
    return device


def _slice_patterns(rt: RuntimeConfig, mesh) -> RuntimeConfig:
    """This rank's query heads of the MInference pattern tables."""
    if rt.prefill_pattern != "vs" or mesh.tp == 1:
        return rt

    def cut(table):
        return None if table is None else tuple(table)[mesh.head_slice(
            len(table))]

    layers = rt.minference_layer_patterns
    return dataclasses.replace(
        rt, minference_patterns=cut(rt.minference_patterns),
        minference_layer_patterns=(None if layers is None
                                   else tuple(cut(t) for t in layers)))


class Engine:
    """Inference engine over one model + cache config: on one device, or
    on this rank's shard of a rank mesh."""

    def __init__(
        self,
        model: ModelConfig,
        cache_cfg: CacheConfig,
        rt: RuntimeConfig,
        params: ModelParams,
        device="cuda",
        sketch: torch.Tensor | None = None,
        mesh: "mesh_lib.RankMesh | None" = None,
    ):
        """``sketch`` optionally fixes the low-rank Gaussian sketch
        (core/lowrank.py; the whole model's under tp); by default it is
        drawn from a seeded generator. With ``rt.dp/tp/sp/pp`` above 1 the
        engine builds its rank mesh from the initialised process group,
        unless ``mesh`` gives it (of the same sizes; a 1-rank mesh runs the
        tensor-parallel code path on one rank). ``params`` are the whole
        model's; each rank keeps its shard (``mesh_lib.shard_params``)."""
        self.device = _resolve_device(device)
        cache_cfg.check_served()
        rt.check_served(cache_cfg)
        forward.check_layer_patterns(rt, model)
        if model.is_hybrid:
            _check_hybrid(model, cache_cfg, rt)
        self.model = model
        self.cache_cfg = cache_cfg
        self.rt = rt
        mesh_lib.check_divisible(model, rt.tp, rt.pp)
        if mesh is None and rt.mesh_size > 1:
            mesh = (mesh_lib.build_mesh_pp(rt.pp, rt.tp, rt.dp) if rt.pp > 1
                    else mesh_lib.build_mesh(rt.dp, rt.tp, rt.sp))
        self.mesh = mesh
        self.local = model  # this rank's config (heads, ffn, layers)
        self.tp = None  # the tensor-parallel group the forward sums over
        self._rt_local = rt
        if mesh is not None:
            if (mesh.dp, mesh.tp, mesh.sp, mesh.pp) != (rt.dp, rt.tp, rt.sp,
                                                        rt.pp):
                raise ValueError(
                    f"mesh (dp {mesh.dp}, tp {mesh.tp}, sp {mesh.sp}, pp "
                    f"{mesh.pp}) does not match the RuntimeConfig")
            if (self.device.type == "cuda" and mesh.backend == "gloo"
                    and not rt.eager_decode and rt.pp == 1):
                raise ValueError(
                    "a gloo group's collectives cannot be captured in the "
                    "decode step's CUDA graph: use NCCL, or ask for eager "
                    "steps with RuntimeConfig(eager_decode=True)")
            params = mesh_lib.shard_params(params, model, mesh)
            self.local = mesh_lib.local_model(model, mesh)
            if mesh.tp > 1 or mesh.size == 1:
                self.tp = mesh.tp_group
            self._rt_local = _slice_patterns(rt, mesh)
        self.params = params.to(self.device)
        self.sketch = sketch
        # bf16 tables when the model runs bf16 (as the JAX engine builds
        # them); f32 otherwise.
        table_dtype = (
            torch.float32 if model.dtype == torch.float32 else torch.bfloat16
        )
        self.cos_table, self.sin_table = rope_lib.compute_cos_sin(
            model, cache_cfg.max_length + cache_cfg.gen_capacity,
            dtype=table_dtype, device=self.device,
        )
        self.inv_freq_full = (
            rope_lib.inv_freq_full_neox(model).to(self.device)
            if self.is_shadow else None
        )
        # Decode strategy (JAX engine._build_jits): the fused refresh kernel
        # with use_pallas=True, else the XLA-gather branch, through the
        # chunk-gather kernel with ring_gather=True; 'auto' starts on the
        # XLA-gather branch and switches on the sampled hit rate.
        self.pallas_auto = rt.use_pallas == "auto"
        self.use_kernel = rt.use_pallas is True
        self.ring_gather = bool(rt.ring_gather)
        self.v_on_host = cache_cfg.mode == "shadow_offload"
        # Offload with neither kernel: JAX's HostVStore (io_callback)
        # path, which reads the missed chunks' V rows from the store.
        self.host_store = self.v_on_host and not (self.use_kernel
                                                  or self.ring_gather)
        # The host store's shard axis as JAX records it: 'batch', or
        # 'layer' after a segmented offload prefill (no admissions then).
        self._host_axis = "batch"
        self.decode_segmented = bool(rt.decode_segmented)
        segs = rt.offload_prefill_segments
        if segs > 1 and model.num_layers % segs:
            raise ValueError(f"offload_prefill_segments {segs} does not "
                             f"divide the {model.num_layers} layers")
        self._kernel_now = self.use_kernel  # the live path
        self._hit_threshold = (rt.hit_threshold(cache_cfg)
                               if self.pallas_auto else None)
        self._auto_switches = 0
        self._debug_hit_rate = rt.debug_hit_rate
        self._cache = None
        self._steps: StepGraphs | None = None
        self._gen: torch.Generator | None = None
        # Hit-rate samples: device scalars, or host floats under 'auto'.
        self._hit_samples: list = []
        self._hit_ema = None
        self._hit_prev_ids = None
        self._hit_counter = 0
        self._batch = 0  # the live cache's whole batch
        self.route_rows: tuple = ()  # rows whose prefill routing is kept

    @property
    def is_shadow(self) -> bool:
        return self.cache_cfg.is_shadow

    # -- the rank's rows ------------------------------------------------------

    def _sharded_batch(self) -> bool:
        return self.mesh is not None and self.mesh.batch_shards > 1

    def _rows(self, batch: int) -> slice:
        """This rank's decode rows of a batch of ``batch``."""
        if self.mesh is None:
            return slice(0, batch)
        return self.mesh.batch_rows(batch)

    def _sample_rows(self):
        """``sample_token``'s ``rows`` for the live batch, or None."""
        if not self._sharded_batch():
            return None
        return (self._rows(self._batch).start, self._batch)

    def _gather(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """Every rank's rows of ``x`` (batch along ``dim``), in batch
        order."""
        if not self._sharded_batch():
            return x
        return mesh_lib.all_gather(x, self.mesh.batch_group, dim=dim)

    def _sim(self, batch: int, sub: int, row0: int):
        """Where a prefill call of ``batch`` rows, ``sub`` at a time, whose
        rows start at global row ``row0``, lies in one device's ``vs_sim``
        draws (``minference.SimShard``); None on one device or without
        ``vs_sim``."""
        rt, mesh = self.rt, self.mesh
        if rt.vs_sim is None or rt.prefill_pattern != "vs" or mesh is None:
            return None
        pats = mi.resolve_patterns(rt.minference_patterns,
                                   self.model.num_heads, rt.vs_vertical_size,
                                   rt.vs_slash_size)
        vs = [p[0] == "vertical_and_slash" for p in pats]
        head0 = mesh.head_slice(self.model.num_heads).start
        return mi.SimShard(
            batch=batch, sub=sub, row0=row0, heads=sum(vs),
            head0=sum(vs[:head0]),
            layer0=mesh.layer_slice(self.model.num_layers).start)

    def _local_slot(self, slot: int) -> int | None:
        """This rank's row of global slot ``slot``, or None."""
        rows = self._rows(self._batch)
        return slot - rows.start if rows.start <= slot < rows.stop else None

    def _no_hybrid(self, what: str) -> None:
        if self.model.is_hybrid:
            raise ValueError(f"{what} serves models without sliding or MoE "
                             "layers")

    def record_routes(self, rows) -> None:
        """Keep the experts that every prompt position of batch rows
        ``rows`` chooses at the next prefill (``cache.hybrid
        .prefill_routes``; each step's are in ``route_ids``), so that a
        reference can follow them."""
        self.route_rows = tuple(int(r) for r in rows)

    # -- prefill ------------------------------------------------------------

    def prefill(self, input_ids) -> tuple[torch.Tensor, object]:
        """Prefill in sub-batches; returns (last-token logits [B, 1, V] f32,
        cache)."""
        with prof.span(prof.PREFILL):
            logits, cache = self._prefill(input_ids)
            prof.mark(prof.END, self.device)
        return logits, cache

    def _prefill(self, input_ids) -> tuple[torch.Tensor, object]:
        input_ids = torch.as_tensor(
            np.asarray(input_ids), dtype=torch.long
        ).to(self.device)
        b, s = input_ids.shape
        if s > self.cache_cfg.max_length:
            raise ValueError(
                f"prompt length {s} exceeds max_length "
                f"{self.cache_cfg.max_length}"
            )
        t = max(1, min(self.rt.prefill_sub_batch, b))
        segmented = self.rt.offload_prefill_segments > 1
        if segmented:
            t = b
        # The old cache's graphs bake in its addresses: drop them, and the
        # cache, before the new one is allocated.
        self._cache = None
        self._steps = None
        mesh, model, rt = self.mesh, self.local, self._rt_local
        self._batch = b
        b_dec = self._rows(b).stop - self._rows(b).start
        row0 = 0
        if mesh is not None:
            # this rank's prefill rows (its dp shard)
            row0 = mesh.prefill_rows(b).start
            input_ids = input_ids[mesh.prefill_rows(b)]
        parts = []
        if self.is_shadow:
            layout = ShadowLayout.build(self.cache_cfg, s)
            cache = ShadowCache.init(model, layout, b_dec, self.device,
                                     v_on_host=self.v_on_host)
            self._host_axis = "layer" if segmented else "batch"
            if model.is_hybrid:
                cache.hybrid = HybridState.init(model, b_dec, s, self.device,
                                                self.route_rows)
            if self.rt.pp > 1:
                parts.append(pipeline.prefill_shadow_pp(
                    model, self.params, cache, input_ids, self.cos_table,
                    self.sin_table, mesh, self.sketch, rt,
                    self._sim(b, t, row0)))
            elif self.rt.sp > 1:
                parts.append(forward.prefill_shadow_sp(
                    model, self.params, cache, input_ids, self.cos_table,
                    self.sin_table, mesh, self.sketch))
            else:
                for b0 in range(0, input_ids.shape[0], t):
                    with prof.span(prof.PREFILL_BATCH):
                        parts.append(forward.prefill_shadow_into(
                            model, self.params, cache, input_ids[b0:b0 + t],
                            self.cos_table, self.sin_table, b0, self.sketch,
                            rt, self.tp, self._sim(b, t, row0 + b0),
                        ))
        else:
            cache = FullCache.init(model, self.cache_cfg, b_dec, self.device)
            if model.is_hybrid:
                cache.hybrid = HybridState.init(model, b_dec, s, self.device,
                                                self.route_rows)
            for b0 in range(0, b_dec, t):
                with prof.span(prof.PREFILL_BATCH):
                    parts.append(forward.prefill_full(
                        model, self.params, cache, input_ids[b0:b0 + t],
                        self.cos_table, self.sin_table, b0, rt, self.tp,
                        self._sim(b, t, row0 + b0),
                    ))
        self._cache = cache
        if self.is_shadow:
            depth, limit = 0, self.cache_cfg.gen_capacity
        else:
            depth, limit = s, self.cache_cfg.max_length
        self._steps = StepGraphs(cache, b_dec, depth, limit, self.device,
                                 eager=self.rt.eager_decode or self.rt.pp > 1)
        return self._gather(torch.cat(parts, dim=0)), cache

    # -- decode -------------------------------------------------------------

    def _decode(self, cache, tokens: torch.Tensor) -> torch.Tensor:
        """One eager decode step of ``tokens`` [B, Qn] on the live path;
        returns logits [B, 1, V]. On the live cache the step's positions are
        booked first (``StepGraphs.take``); another cache (a copy) keeps
        its own count."""
        if cache is self._cache:
            self._steps.take(tokens.shape[1])
        with prof.span(prof.DECODE_EAGER):
            return self._forward_step(cache, tokens)

    def _forward_step(self, cache, tokens: torch.Tensor) -> torch.Tensor:
        """The decode forward of one step (this rank's rows), which the
        compiled step runs for its first step and its capture."""
        if self.rt.pp > 1:
            return pipeline.decode_shadow_pp(
                self.local, self.params, cache, tokens, self.cos_table,
                self.sin_table, self.inv_freq_full, self.mesh,
                hysteresis=self.rt.selection_hysteresis)
        if self.is_shadow:
            return forward.decode_shadow(
                self.local, self.params, cache, tokens, self.cos_table,
                self.sin_table, self.inv_freq_full,
                hysteresis=self.rt.selection_hysteresis,
                use_kernel=self._kernel_now, ring=self.ring_gather,
                debug_hit_rate=self._debug_hit_rate,
                debug_hit_layout=self.rt.debug_hit_layout,
                segmented=self.decode_segmented, tp=self.tp,
            )
        return forward.decode_full(
            self.local, self.params, cache, tokens, self.cos_table,
            self.sin_table, tp=self.tp,
        )

    def _steps_for(self, cache) -> StepGraphs:
        """The token buffers, graphs and slot depths of the live cache."""
        if cache is None or cache is not self._cache:
            raise ValueError("decode runs on the engine's live cache (the "
                             "last prefill's)")
        return self._steps

    def _step(self, steps: StepGraphs, sample_args: tuple,
              gen: torch.Generator, observe: bool = True) -> torch.Tensor:
        """One compiled decode step on the live path: the token in
        ``steps.tok`` in, the next one out (forced where ``steps`` says);
        returns the step's logits [B, V]. ``observe`` samples the slot hit
        rate afterwards, on the device."""
        sampled = sample_args[0] != 0.0
        key = (self._kernel_now, sample_args, gen if sampled else None)
        rows = self._sample_rows()

        def body():
            logits = self._forward_step(steps.cache, steps.tok[:, None])[:, -1]
            steps.record(sample_token(logits, gen, *sample_args, rows=rows))
            prof.mark(prof.END, logits.device)
            return logits

        logits = steps.step(key, body, gen if sampled else None)
        if observe and self.is_shadow and (self.rt.track_hit_rate
                                           or self.pallas_auto):
            self._observe_hits(steps.cache)
        return logits

    def _generator(self, seed: int | None = None) -> torch.Generator:
        """The engine's sampling generator, reseeded when ``seed`` is given:
        one object, so the captured steps of one cache keep drawing from
        it."""
        if self._gen is None:
            self._gen = torch.Generator(device=self.device)
        return self._gen if seed is None else self._gen.manual_seed(seed)

    def set_debug_hit_rate(self, rate: float | None) -> None:
        """BENCHMARK-ONLY: change the forced selection rate
        (``RuntimeConfig.debug_hit_rate``) of a live engine; the captured
        steps bake the old rate in and are dropped (the JAX benchmarks'
        ``_decode_shadow_jit.clear_cache()``)."""
        self._debug_hit_rate = rate
        if self._steps is not None:
            self._steps.drop_graphs()

    def _observe_hits(self, cache: ShadowCache) -> None:
        """Sample the slot hit rate on one consecutive step pair per
        ``pallas_auto_interval`` steps (JAX ``_auto_observe``). Slot-stable
        assignment makes "slot id unchanged" the same as "hit", so the rate
        is the mean of ``ids[t] == ids[t+1]``. With ``track_hit_rate`` the
        samples stay on the device until ``kv_stats`` reads them; under
        ``use_pallas="auto"`` each sample is read to the host (one scalar
        read per interval, as JAX's ``float(...)``) and the EMA picks the
        path with JAX's dead-band rule."""
        phase = self._hit_counter % max(2, self.rt.pallas_auto_interval)
        self._hit_counter += 1
        if phase == 0:
            self._hit_prev_ids = cache.cached_ids.clone()
        elif phase == 1 and self._hit_prev_ids is not None:
            frac = (self._hit_prev_ids == cache.cached_ids).float().mean()
            self._hit_prev_ids = None
            if self.pallas_auto:
                frac = float(self._mesh_mean(frac))
            ema = self._hit_ema
            self._hit_ema = frac if ema is None else 0.5 * ema + 0.5 * frac
            self._hit_samples.append(frac)
            if not self.pallas_auto:
                return
            band = self.rt.pallas_auto_deadband
            if self._kernel_now:
                want = self._hit_ema >= self._hit_threshold - band
            else:
                want = self._hit_ema >= self._hit_threshold + band
            if want != self._kernel_now:
                self._kernel_now = want
                self._auto_switches += 1

    def _mesh_mean(self, frac: torch.Tensor) -> torch.Tensor:
        """The hit rate over every rank's rows and heads, so that the ranks
        of a mesh take one decode path (as JAX's global sample does)."""
        mesh = self.mesh
        if mesh is None:
            return frac
        x = frac.reshape(1).clone()
        if mesh.tp > 1:
            x = mesh_lib.all_reduce(x, mesh.tp_group) / mesh.tp
        if mesh.batch_shards > 1:
            x = mesh_lib.all_reduce(x, mesh.batch_group) / mesh.batch_shards
        return x[0]

    def _auto_reset(self) -> None:
        """After ``batch_generate``'s warmup (JAX ``_auto_reset``)."""
        self._hit_prev_ids = None
        self._hit_counter = 0
        if self.pallas_auto:
            self._kernel_now = False

    def _check_capacity(self, prompt_len: int, steps: int) -> None:
        if self.is_shadow:
            if steps > self.cache_cfg.gen_capacity:
                raise ValueError(
                    f"{steps} decode tokens exceed gen_capacity "
                    f"{self.cache_cfg.gen_capacity}"
                )
        elif prompt_len + steps > self.cache_cfg.max_length:
            raise ValueError(
                f"prompt {prompt_len} + {steps} tokens exceed the full "
                f"cache's max_length {self.cache_cfg.max_length}"
            )

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def generate(
        self,
        input_ids,
        gen_len: int = 256,
        temperature: float = 0.0,
        top_k: int = 50,
        top_p: float = 0.9,
        seed: int = 0,
        stop_ids: tuple[int, ...] = (),
        cont: bool = False,
        cont_chunk: int = 16,
    ) -> tuple[np.ndarray, GenerationStats]:
        """Generate for a batch of equal-length prompts; returns
        ([B, <=gen_len] ids, stats). Stop tokens truncate per sequence
        afterwards (the batch decodes to the end, as the reference does;
        a batch of one stops at its stop token).

        ``cont=True`` continues from the cache of the previous call (JAX
        ``generate(cont=True)``: a chat turn over a prefilled context, with
        no new prefill). The new prompt is teacher-forced through decode
        steps of ``cont_chunk`` tokens (eager steps: the compiled step is
        the one-token step), then one-token steps for the remainder, which
        go through the compiled step as forced rows; the step that takes
        the prompt's last token gives the first generated one."""
        stats = GenerationStats()
        b, s = np.asarray(input_ids).shape
        gen = self._generator(seed)
        sample_args = (temperature, top_k, top_p)
        t0 = time.perf_counter()
        if cont:
            steps, head, off = self._continue(input_ids, gen_len, cont_chunk,
                                              gen, sample_args)
        else:
            self._check_capacity(s, gen_len)
            logits, cache = self.prefill(input_ids)
            head = sample_token(logits[:, -1], gen, *sample_args)
            head, off = head[self._rows(b)], 0
            steps = self._steps_for(cache)
            steps.begin(head)
        self._sync()
        stats.prefill_seconds = time.perf_counter() - t0
        stats.prefill_tokens = b * s

        n = gen_len - 1
        t0 = time.perf_counter()
        for i in range(gen_len - 1):
            with prof.span(prof.DECODE_STEP):
                self._step(steps, sample_args, gen)
            if stop_ids and b == 1 and int(steps.tok[0]) in stop_ids:
                n = i + 1
                break
        self._sync()
        stats.decode_seconds = time.perf_counter() - t0
        stats.decode_tokens = b * n
        result = torch.cat([head[:, None], steps.hist[off:off + n].T], dim=1)
        result = self._gather(result).cpu().numpy()
        if stop_ids:
            result = _truncate_at_stop(result, stop_ids)
        return result, stats

    def _continue(self, input_ids, gen_len: int, chunk: int,
                  gen: torch.Generator, sample_args: tuple):
        """Teacher-force a new turn into the live cache (``generate``'s
        ``cont=True``): returns (the step buffers, the first generated
        tokens [B], the history row at which the decode steps start)."""
        cache = self._cache
        if cache is None:
            raise ValueError("generate(cont=True) needs a prior generate call")
        steps = self._steps_for(cache)
        b, s = np.asarray(input_ids).shape
        used = int(steps.depth.max()) + s + gen_len
        if used > steps.limit:
            region = "gen_capacity" if self.is_shadow else "max_length"
            raise ValueError(f"continuation overflows the cache: {used} > "
                             f"{region} {steps.limit}")
        prompt = torch.as_tensor(np.asarray(input_ids)[self._rows(b)],
                                 dtype=torch.int32).to(self.device)
        if self.rt.pp > 1:
            chunk = 1  # pp decode steps one token at a time (JAX :1504)
        multi = s - s % chunk if chunk > 1 else 0
        logits = None
        for t in range(0, multi, chunk):
            with prof.span(prof.DECODE_STEP):
                logits = self._decode(cache, prompt[:, t:t + chunk])
        rest = prompt[:, multi:]
        if rest.shape[1] == 0:
            head = sample_token(logits[:, -1], gen, *sample_args,
                                rows=self._sample_rows())
            steps.begin(head)
            return steps, head, 0
        forced = rest[:, 1:].T
        steps.begin(rest[:, 0], forced, torch.ones_like(forced, dtype=torch.bool))
        for _ in range(rest.shape[1]):
            with prof.span(prof.DECODE_STEP):
                self._step(steps, sample_args, gen)
        return steps, steps.hist[rest.shape[1] - 1], rest.shape[1]

    def batch_generate(
        self,
        input_ids,
        gen_len: int = 100,
        temperature: float = 0.6,
        top_k: int = 50,
        top_p: float = 0.9,
        seed: int = 0,
        warmup_steps: int = 2,
    ) -> tuple[np.ndarray, GenerationStats]:
        """Throughput-oriented generation: ``warmup_steps`` untimed decode
        steps (on the card the first one runs eagerly and captures the
        step), then ``gen_len`` timed steps with no host sync inside the
        loop. Under ``use_pallas="auto"`` the warmup alternates the two
        paths, so both are captured before the timed loop (as JAX's warmup
        compiles both). Returns ([B, gen_len] ids of the timed steps,
        stats)."""
        b, s = np.asarray(input_ids).shape
        self._check_capacity(s, gen_len + warmup_steps)
        stats = GenerationStats()
        gen = self._generator(seed)
        sample_args = (temperature, top_k, top_p)
        t0 = time.perf_counter()
        logits, cache = self.prefill(input_ids)
        tokens = sample_token(logits[:, -1], gen, *sample_args)
        self._sync()
        stats.prefill_seconds = time.perf_counter() - t0
        stats.prefill_tokens = b * s

        steps = self._steps_for(cache)
        steps.begin(tokens[self._rows(b)])
        for i in range(warmup_steps):
            if self.pallas_auto and warmup_steps >= 2:
                self._kernel_now = i % 2 == 1
            with prof.span(prof.DECODE_STEP):
                self._step(steps, sample_args, gen)
        if self.pallas_auto:
            self._auto_reset()
        self._sync()
        t0 = time.perf_counter()
        for _ in range(gen_len):
            with prof.span(prof.DECODE_STEP):
                self._step(steps, sample_args, gen)
        self._sync()
        stats.decode_seconds = time.perf_counter() - t0
        stats.decode_tokens = b * gen_len
        out = steps.hist[warmup_steps:warmup_steps + gen_len].T
        return self._gather(out).cpu().numpy(), stats

    def decode_step(
        self,
        cache,
        tokens: torch.Tensor,
        generator: torch.Generator | None = None,
        temperature: float = 0.0,
        top_k: int = 50,
        top_p: float = 0.9,
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """One compiled decode step on ``cache`` fed ``tokens`` [B]; returns
        (next tokens [B], logits [B, V]), both buffers that the next step
        overwrites (on a mesh, the gathered rows of every rank). No host
        sync."""
        with prof.span(prof.DECODE_STEP):
            steps = self._steps_for(cache)
            steps.begin(tokens[self._rows(self._batch)])
            gen = self._generator() if generator is None else generator
            logits = self._step(steps, (temperature, top_k, top_p), gen,
                                observe=False)
            return self._gather(steps.tok), self._gather(logits)

    def decode_chunk(
        self,
        cache,
        tokens: torch.Tensor,
        forced_val,
        forced_on,
        generator: torch.Generator | None = None,
        temperature: float = 0.0,
        top_k: int = 50,
        top_p: float = 0.9,
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """k decode steps in one run (JAX ``decode_chunk_jit``): step t feeds
        ``where(forced_on[t], forced_val[t], sampled)`` ([k, B] each; on the
        engine's device they cost no host sync). Returns (the last tokens
        [B] on the device, every step's tokens [k, B] on the host); the
        host read of the latter is the chunk's one sync. Like JAX's chunk it
        samples no hit rate, so ``"auto"`` holds its path through it."""
        k = forced_val.shape[0]
        steps = self._steps_for(cache)
        rows = self._rows(self._batch)
        steps.begin(tokens[rows], forced_val[:, rows], forced_on[:, rows])
        gen = self._generator() if generator is None else generator
        sample_args = (temperature, top_k, top_p)
        for _ in range(k):
            with prof.span(prof.DECODE_STEP):
                self._step(steps, sample_args, gen, observe=False)
        if not self._sharded_batch():
            return steps.tok.clone(), steps.hist[:k].cpu()
        hist = self._gather(steps.hist[:k], dim=1)
        return hist[k - 1].clone(), hist.cpu()

    # -- slot operations (continuous batching, serving.py) -------------------

    def use_slot_depths(self, cache) -> None:
        """Give every slot of the live shadow cache its own generation depth
        (``gen_len`` becomes [B], JAX serving's ``gen_len=zeros((B,))``)
        before its first decode step is captured."""
        self._steps_for(cache).slot_depths()

    def reset_slot_depth(self, slot: int, need: int) -> None:
        """An admission into ``slot``: its depth to 0, in place, and the
        number of decode steps its request needs (the capacity check's
        end for that slot); on a mesh, by the rank that holds the slot."""
        steps = self._steps_for(self._cache)
        local = self._local_slot(slot)
        if local is not None:
            steps.reset_slot(local, need)
            if self._cache.hybrid is not None:
                # the round before overwrote the prompt's window rows
                self._cache.hybrid.restore(local)

    def clamp_idle_depths(self, active, steps: int) -> None:
        """Pin the depth of each slot that ``active`` [B] marks idle low
        enough for ``steps`` more steps (JAX serving's idle-slot clamp)."""
        active = np.asarray(active, bool)[self._rows(self._batch)]
        self._steps_for(self._cache).clamp_idle(active, steps)

    def admit_slot(self, cache, ids_row, slot: int):
        """Prefill one request into ``slot`` of the live cache (JAX
        ``admit_slot``); the other slots, the graphs and the step buffers
        are untouched. Every field is written in place, and with V in host
        memory each layer's V rows go straight into the slot's rows of the
        pinned store, so neither mode needs a one-slot cache. A store from
        a segmented offload prefill refuses, as JAX's does. On a mesh the
        dp shard that holds ``slot`` prefills it, with its tp ranks, and
        its logits reach every rank. Returns (last-token logits [1, 1, V],
        cache)."""
        if not self.is_shadow:
            raise ValueError("slot admission serves the shadow cache modes")
        self._no_hybrid("slot admission")
        if self.rt.sp > 1 or self.rt.pp > 1:
            raise ValueError("slot admission prefills one slot; the sp and "
                             "pp prefills are whole-batch")
        self._steps_for(cache)
        if self._host_axis != "batch":
            raise ValueError(
                "slot admission over a layer-sharded host store (from a "
                "segmented offload prefill) is unsupported — serve with "
                "offload_prefill_segments=1")
        ids = torch.as_tensor(np.asarray(ids_row)[None],
                              dtype=torch.long).to(self.device)
        local = self._local_slot(slot)
        if local is None:  # another dp shard holds the slot
            lg = torch.empty(1, 1, self.model.vocab_size,
                             dtype=torch.float32, device=self.device)
        else:
            lg = forward.prefill_shadow_into(
                self.local, self.params, cache, ids, self.cos_table,
                self.sin_table, local, self.sketch, self._rt_local, self.tp,
                self._sim(1, 1, 0),
            )
        if self._sharded_batch():
            lg = mesh_lib.broadcast(
                lg.contiguous(),
                self.mesh.owner_of_row(slot, self._batch),
                self.mesh.batch_group)
        return lg, cache

    def _slot_at(self, slot: int) -> tuple[int | None, int | None]:
        """Global slot ``slot``: (the global rank of this rank's batch group
        that holds it, None off a batch-sharded mesh; this rank's row of
        it, None on another dp shard)."""
        if not self._sharded_batch():
            return None, slot
        return (self.mesh.owner_of_row(slot, self._batch),
                self._local_slot(slot))

    def _extract_slot(self, cache, b0: int) -> ShadowCache | None:
        """A one-slot copy of slot ``b0`` of every field of ``cache``,
        ``gen_len`` and the int8 scales included (JAX ``extract_slot_fn``):
        a shared-prefix snapshot. A host V store's rows are not copied
        here (``host_slot_rows`` does that); the snapshot holds a zero-row
        placeholder for them, as JAX's does. On a batch-sharded mesh the
        snapshot stays on the dp shard that holds the slot (each tp rank
        its heads); the other shards get None."""
        self._no_hybrid("a shared-prefix snapshot")
        row = self._slot_at(b0)[1]
        if row is None:
            return None

        def take(t):
            return None if t is None else t[:, row:row + 1].clone()

        fields = {name: take(getattr(cache, name))
                  for name in ShadowCache.FIELDS if name != "v_full"}
        v = cache.v_full
        fields["v_full"] = (v.new_empty(v.shape[:1] + (1,) + v.shape[2:3]
                                        + (0,) + v.shape[4:])
                            if cache.v_on_host else take(v))
        gen_len = cache.gen_len
        gen_len = (gen_len[row:row + 1] if gen_len.dim() else gen_len).clone()
        return ShadowCache(layout=cache.layout, gen_len=gen_len,
                           v_on_host=cache.v_on_host, **fields)

    def _move_slot(self, parts: dict, live: dict, src: int, dst: int,
                   group) -> dict:
        """Slot ``src``'s one-slot tensors ``parts`` (name -> tensor, on the
        shard that holds it) to the shard that holds slot ``dst``: returns
        them there (``parts`` itself on one shard, {} on a rank of
        neither). Across dp shards the owner's rank sends each to the rank
        with its tp coordinate on the target shard, over ``group``; the
        receiver allocates each like one slot of ``live`` (name -> the
        live [L, B, ...] tensor)."""
        src_owner, src_row = self._slot_at(src)
        dst_owner, dst_row = self._slot_at(dst)
        if src_owner == dst_owner:
            return parts if dst_row is not None else {}
        out = {}
        for name, t in live.items():
            if src_row is not None:
                mesh_lib.exchange(parts[name], dst_owner, None, None, group)
            elif dst_row is not None:
                out[name] = torch.empty_like(t[:, :1])
                mesh_lib.exchange(None, None, out[name], src_owner, group)
        return out

    def _merge_slots(self, cache, small: ShadowCache | None, b0: int,
                     with_v: bool = False, src: int | None = None):
        """Copy the one-slot ``small`` into slot ``b0`` of the live tensors
        of ``cache``, in place (JAX ``merge_slots_fn``): every field but
        the V store, which stays where it is (a host store takes its rows
        through ``set_host_slot_rows``); ``gen_len`` is left to the
        caller. ``src`` is the slot the snapshot was taken from: on a
        batch-sharded mesh a snapshot of another dp shard's slot crosses
        to ``b0``'s shard first (``_move_slot``)."""
        names = [n for n in ShadowCache.FIELDS if n != "v_full"]
        names += ["v_full"] if with_v else []
        live = {n: getattr(cache, n) for n in names
                if getattr(cache, n) is not None}
        row = self._slot_at(b0)[1]
        parts = {} if small is None else {n: getattr(small, n) for n in live}
        parts = self._move_slot(parts, live, b0 if src is None else src, b0,
                                self.mesh.batch_group
                                if self._sharded_batch() else None)
        if row is not None:
            for name, val in parts.items():
                getattr(cache, name)[:, row:row + 1].copy_(val)
        return cache

    def _merge_slots_v(self, cache, small: ShadowCache | None, b0: int,
                       src: int | None = None):
        """``_merge_slots`` with the V store (a cache whose V is on the
        card; JAX ``merge_slots_v_fn``)."""
        return self._merge_slots(cache, small, b0, with_v=True, src=src)

    def _host_store(self) -> torch.Tensor:
        if not self.v_on_host or self._cache is None:
            raise ValueError("host V rows exist only on a live "
                             "shadow_offload cache")
        return self._cache.v_full

    def host_slot_rows(self, slot: int) -> torch.Tensor | None:
        """A copy of slot ``slot`` of the host V store [L, 1, K, rows, Dh],
        pinned when the engine runs on the card (JAX ``host_slot_rows``);
        on a batch-sharded mesh, on the dp shard that holds the slot (None
        on the others)."""
        store = self._host_store()
        row = self._slot_at(slot)[1]
        if row is None:
            return None
        rows = store[:, row:row + 1]
        out = torch.empty(rows.shape, dtype=rows.dtype,
                          pin_memory=self.device.type == "cuda")
        return out.copy_(rows)

    def set_host_slot_rows(self, rows: torch.Tensor | None, slot: int,
                           src: int | None = None) -> None:
        """Write a ``host_slot_rows`` copy back into slot ``slot`` of the
        host V store (JAX ``set_host_slot_rows``); from another dp shard's
        slot ``src``, the rows cross over the mesh's gloo group, through
        host memory only."""
        store = self._host_store()
        row = self._slot_at(slot)[1]
        parts = self._move_slot({} if rows is None else {"v": rows},
                                {"v": store}, slot if src is None else src,
                                slot,
                                self.mesh.host_group
                                if self._sharded_batch() else None)
        if row is not None:
            store[:, row:row + 1].copy_(parts["v"])

    # -- context checkpoints (utils/checkpoint.py) ----------------------------

    def save_state(self, path: str) -> None:
        """Write the live shadow cache (after a prefill, or mid-generation)
        to ``path``; ``load_state`` in this or another engine resumes it.
        On a rank mesh every rank calls it: the file is the whole cache at
        its global shape (one writer, the replica's first rank), and each
        rank returns once it is complete. A world of several replicas
        writes one file per replica: give each its own ``path``."""
        if not self.is_shadow:
            raise ValueError("save_state serves the shadow cache modes")
        self._no_hybrid("save_state")
        if self._cache is None:
            raise ValueError("save_state needs a prefilled cache: call "
                             "prefill() or generate() first")
        if not self.v_on_host:
            variant = "hbm"
        else:
            variant = "io_callback" if self.host_store else "host"
        checkpoint.save_shadow_state(self._cache, path, variant=variant,
                                     mesh=self.mesh)

    def load_state(self, path: str) -> None:
        """Load a ``save_state`` file as the live cache; afterwards
        ``generate(..., cont=True)`` continues that context. The V store
        lands where this engine keeps it (the card, or the host store: a
        file saved with V on the card loads into a ``shadow_offload``
        engine without passing through device memory, and the reverse).
        The layout must match this engine's cache config (``_check_layout``),
        the shapes its model; on a rank mesh each rank checks the header
        before reading anything and keeps its slice, so a file saved on any
        mesh (or one device) loads on any other. The old cache's graphs
        are dropped and the slots' host-side depths are rebuilt from the
        loaded ``gen_len``."""
        if not self.is_shadow:
            raise ValueError("load_state serves the shadow cache modes")
        self._no_hybrid("load_state")
        self._cache = None
        self._steps = None
        cache = checkpoint.load_shadow_state(
            path, self.device, v_on_host=self.v_on_host,
            check=self._check_layout, mesh=self.mesh,
            check_shapes=self._check_shapes)
        self._cache = cache
        self._batch = cache.k_buf.shape[1] * (
            self.mesh.batch_shards if self.mesh is not None else 1)
        self._host_axis = "batch"
        self._hit_prev_ids = None
        depth = cache.gen_len.cpu().numpy().astype(np.int64)
        self._steps = StepGraphs(cache, cache.k_buf.shape[1], depth,
                                 self.cache_cfg.gen_capacity, self.device,
                                 eager=self.rt.eager_decode or self.rt.pp > 1)

    def _check_shapes(self, shapes: dict) -> None:
        """Refuse a checkpoint whose cache does not fit this engine's model
        or mesh; every rank reads the same header, so all raise alike."""
        m = self.model
        l, b, kh, _, dh = shapes["k_buf"]
        if (l, kh, dh) != (m.num_layers, m.num_kv_heads, m.head_dim):
            raise ValueError(
                f"checkpoint cache [L {l}, K {kh}, Dh {dh}] does not match "
                f"this engine's model [L {m.num_layers}, K "
                f"{m.num_kv_heads}, Dh {m.head_dim}]")
        if self.mesh is not None:
            self.mesh.batch_rows(b)  # the batch divides over the shards

    def _check_layout(self, lo: ShadowLayout) -> None:
        """Refuse a checkpoint whose static layout differs from this engine's
        cache config: decoding it would read out of place."""
        cc = self.cache_cfg
        expect = {"chunk_size": cc.chunk_size, "select_sets": cc.select_sets,
                  "rank": cc.rank, "gen_capacity": cc.gen_capacity,
                  "quant": cc.kv_quant}
        got = {k: getattr(lo, k) for k in expect}
        if got != expect:
            raise ValueError(f"checkpoint layout does not match this engine: "
                             f"{got} != {expect}")
        if lo.prefill_len > cc.max_length:
            raise ValueError(f"checkpoint prefill_len {lo.prefill_len} "
                             f"exceeds max_length {cc.max_length} (RoPE "
                             "tables too short)")

    # -- observability ------------------------------------------------------

    def kv_stats(self) -> dict:
        """Cache statistics from the live cache: bytes per field, the
        device and host bytes (an offloaded V store counts as host bytes
        only), the cached length and, with ``track_hit_rate``, the sampled
        slot hit rate."""
        cc = self.cache_cfg
        out: dict = {"mode": cc.mode, "quant": cc.kv_quant}
        cache = self._cache
        if cache is None:
            return out
        if self.is_shadow:
            names = ShadowCache.FIELDS
        else:
            names = ("k", "v")
        bytes_by_field = {}
        for name in names:
            t = getattr(cache, name)
            if t is not None:
                bytes_by_field[name] = t.numel() * t.element_size()
        out["bytes_by_field"] = bytes_by_field
        host_bytes = 0
        if self.is_shadow and cache.v_on_host:
            # the host V store of every offload path, as JAX counts
            # v_store.rows
            host_bytes = bytes_by_field.pop("v_full")
        out["device_bytes"] = sum(bytes_by_field.values())
        out["host_bytes"] = host_bytes
        if self.is_shadow:
            m = self.local  # this rank's shard of the cache
            cached = int(cache.kv_len.max())
            bytes_per = 4 if m.dtype == torch.float32 else 2
            full_equiv = (2 * m.num_layers * cache.k_buf.shape[1]
                          * m.num_kv_heads * max(cached, 1) * m.head_dim
                          * bytes_per)
            out.update(
                sparse_budget=cc.sparse_budget, chunk_size=cc.chunk_size,
                rank=cc.rank, cached=cached, local_chunks=cc.local_chunks,
                outlier_chunks=cc.resolved_outlier_chunks(),
                full_equivalent_bytes=full_equiv,
                hbm_reduction=full_equiv / max(1, out["device_bytes"]),
            )
            if self._hit_samples:
                out.update(
                    hit_rate_mean=float(np.mean(
                        [float(x) for x in self._hit_samples])),
                    hit_rate_ema=float(self._hit_ema),
                    hit_samples=len(self._hit_samples),
                )
            if self.pallas_auto:
                out.update(
                    auto_hit_ema=self._hit_ema,
                    auto_kernel_now=self._kernel_now,
                    auto_switches=self._auto_switches,
                )
        else:
            out["cached"] = int(cache.length)
        return out

    def print_kv_stats(self) -> None:
        """One line of ``kv_stats``: the live cache's bytes by field, device
        and host GiB and, for a shadow cache, the reduction against a full
        cache of the same context."""
        s = self.kv_stats()
        if not s.get("bytes_by_field"):
            print(f"[KV] mode={s['mode']}: no live cache (prefill first)")
            return
        gib = 2.0**30
        if not self.is_shadow:
            print(f"[KV] full | cached {s['cached']} | device "
                  f"{s['device_bytes'] / gib:.2f} GiB")
            return
        parts = ", ".join(
            f"{k} {v / gib:.3f}"
            for k, v in sorted(s["bytes_by_field"].items(),
                               key=lambda kv: -kv[1]) if v > 0)
        print(
            f"[KV] {s['mode']} | budget {s['sparse_budget']} | chunk "
            f"{s['chunk_size']} | rank {s['rank']} | cached {s['cached']} | "
            f"local {s['local_chunks']} | outlier {s['outlier_chunks']} | "
            f"device {s['device_bytes'] / gib:.2f} GiB ({parts}) | host "
            f"{s['host_bytes'] / gib:.2f} GiB | full-attn equivalent "
            f"{s['full_equivalent_bytes'] / gib:.2f} GiB "
            f"({s['hbm_reduction']:.1f}x reduction)")


def _truncate_at_stop(tokens: np.ndarray, stop_ids: tuple[int, ...]):
    """Overwrite everything after the first stop token per row."""
    out = tokens.copy()
    for row in range(out.shape[0]):
        hits = np.isin(out[row], stop_ids).nonzero()[0]
        if hits.size:
            out[row, hits[0]:] = stop_ids[0]
    return out
