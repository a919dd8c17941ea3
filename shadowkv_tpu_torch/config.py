"""Configuration dataclasses (counterpart of ``shadowkv_tpu/config.py``).

A run is described by (ModelConfig, CacheConfig, RuntimeConfig), with the
fields the JAX package has for the paths this port serves:

- ``mode``: ``"full"``, ``"shadow"`` (stores on the card) and
  ``"shadow_offload"`` (the V store in pinned host memory, read in place by
  the decode kernels);
- shadow decode: ``use_pallas=True`` (fused refresh, kernel A),
  ``use_pallas`` None/False (the XLA-gather branch), with
  ``ring_gather=True`` (the chunk-gather kernel D), and
  ``use_pallas="auto"`` (a switch between the first two on the measured
  slot hit rate, ``pallas_hit_threshold`` / ``pallas_auto_deadband``);
- ``debug_hit_rate`` / ``debug_hit_layout`` (benchmark-only forced
  selection);
- prefill attention: ``prefill_pattern`` ``"dense"``/``"dense-splash"``
  (kernel B), ``"stream"`` (sink + sliding window, kernel C) and ``"vs"``
  (MInference per-head patterns through ``core/minference.py``:
  ``vs_impl="tile"``, kernel F, or ``"walk"``, kernel G; uniform
  ``minference_patterns`` or per-layer ``minference_layer_patterns``).

- ``mode="shadow_offload"`` with neither decode kernel: the JAX
  ``HostVStore`` path (bf16 stores only), whose XLA-gather branch reads
  each layer's missed chunks from the pinned store
  (``kernels/gather.py::gather_v_rows``); ``offload_prefill_segments >
  1``: the layer-segmented offload prefill (``ring_gather=True``, the
  layers a multiple of the segments); ``decode_segmented=True``: decode
  attention over the buffer's segments on the XLA-gather branch (the fused
  path ignores it); ``vs_sim="clustered"``: the benchmark-only MInference
  score simulation.

``weight_quant`` (``"none"`` | ``"int8"``) records whether the params are
int8 ``QTensor`` leaves (``core/wquant.py``); as in JAX it is
informational, the params decide. ``approx_topk`` is no field: XLA's
approximate top-k is exact off the TPU, and the port's top-k is always
exact, so ``LLM`` accepts the flag and ignores it. The JAX rules that
assert are ``ValueError`` here: ``use_pallas`` and ``ring_gather`` exclude
each other, an int8 offloaded store needs one of them, ``use_pallas="auto"``
serves the ``"shadow"`` mode without ``ring_gather`` only, and the
segmented offload prefill needs ``shadow_offload`` with ``ring_gather``
(the engine checks the layer count).

Parallelism (``parallel/``): ``dp``, ``tp``, ``sp`` and ``pp`` with the JAX
engine's composition rules (``engine.py:149-216``): sp serves
``mode="shadow"`` on the XLA decode path; pp needs ``mode="shadow"`` and
the XLA decode path, composes with dp or with tp but not both and never
with sp, and pp x tp serves ``kv_quant="none"``; the engine checks that tp
divides the KV heads and pp the layers. ``eager_decode`` (port-own) runs
every decode step eagerly on the card instead of through its CUDA graph:
a gloo group's collectives cannot be captured, so a gloo mesh on the card
needs it.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

# The slot hit rate above which the fused refresh (kernel A) decodes faster
# than the XLA-gather branch, by chunk size: the default of
# ``pallas_hit_threshold``. Measured by chip_smoke.py's crossover sweep
# (forced hit rates 0-0.9, scatter layout, Llama-3.1-8B shape at 32K x 2,
# both branches replayed as CUDA graphs) on an NVIDIA H100 80GB HBM3 at a
# 700 W power limit: the fused refresh was faster at every rate at chunk
# 16 and at chunk 8 (the ms per step are in PERF.md §6), so the crossover
# is 0.0 and 'auto' takes the kernel once the hit-rate EMA clears the
# dead-band. The JAX package's defaults are a TPU v5e crossover and do not
# apply here.
H100_HIT_THRESHOLD = {16: 0.0, 8: 0.0}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture hyper-parameters for a decoder-only transformer."""

    name: str = "llama"
    num_layers: int = 32
    hidden_size: int = 4096
    num_heads: int = 32
    num_kv_heads: int = 8
    head_dim: int = 128
    intermediate_size: int = 14336
    vocab_size: int = 128256
    rms_norm_eps: float = 1e-5
    rope_theta: float = 500000.0
    # 'neox': rotate-half over the whole head; 'glm': interleaved
    # (even, odd) pairs over the first rope_partial_dim dims.
    rope_style: str = "neox"
    rope_partial_dim: Optional[int] = None
    # Llama-3.1 rope scaling dict (stored as a sorted item tuple so the
    # config stays hashable) or None.
    rope_scaling: Optional[Any] = None
    qkv_bias: bool = False
    tie_word_embeddings: bool = False
    max_position_embeddings: int = 1048576
    dtype: torch.dtype = torch.bfloat16
    # Hybrid layers (EXAONE 4 / K-EXAONE): per layer "sliding_attention"
    # or "full_attention" (None: every layer full); a sliding layer's
    # query sees the ``sliding_window`` keys up to its own position.
    layer_types: Optional[tuple] = None
    sliding_window: Optional[int] = None
    # EXAONE 4's block: no input norm; a per-head RMSNorm of q and k over
    # head_dim lanes (own gains) before RoPE; x + norm(attn(x)), then x +
    # norm(mlp(x)); and, in a model with sliding layers, no RoPE on the
    # full-attention layers (its global NoPE).
    exaone4_block: bool = False
    # Mixture of experts (DeepSeek-V3's block): per layer "dense" or
    # "sparse" (None: every layer dense, of ``intermediate_size``). The
    # router scores all ``num_experts`` by a sigmoid, picks the top
    # ``num_experts_per_tok`` of score + bias, weights them by their
    # scores (normalised when ``norm_topk_prob``) times
    # ``routed_scaling_factor``; this device holds the routed experts
    # ``held_experts`` (None: all) and adds their part of the result, and
    # the ``num_shared_experts`` shared experts once.
    mlp_layer_types: Optional[tuple] = None
    moe_intermediate_size: int = 0
    num_experts: int = 0
    num_experts_per_tok: int = 0
    num_shared_experts: int = 0
    routed_scaling_factor: float = 1.0
    norm_topk_prob: bool = True
    held_experts: Optional[tuple] = None

    def __post_init__(self):
        if isinstance(self.rope_scaling, dict):
            object.__setattr__(
                self, "rope_scaling", tuple(sorted(self.rope_scaling.items()))
            )
        for name in ("layer_types", "mlp_layer_types", "held_experts"):
            val = getattr(self, name)
            if val is not None and not isinstance(val, tuple):
                object.__setattr__(self, name, tuple(val))
        if self.layer_types is not None:
            if len(self.layer_types) != self.num_layers:
                raise ValueError("layer_types must give every layer")
            bad = set(self.layer_types) - {"sliding_attention",
                                           "full_attention"}
            if bad:
                raise ValueError(f"unknown layer types {sorted(bad)}")
            if "sliding_attention" in self.layer_types and not (
                    self.sliding_window and self.sliding_window > 0):
                raise ValueError("sliding layers need a sliding_window")
        if self.mlp_layer_types is not None:
            if len(self.mlp_layer_types) != self.num_layers:
                raise ValueError("mlp_layer_types must give every layer")
            if set(self.mlp_layer_types) - {"dense", "sparse"}:
                raise ValueError("mlp layer types are 'dense' or 'sparse'")
            if self.moe_layers and not (
                    0 < self.num_experts_per_tok <= self.num_experts
                    and self.moe_intermediate_size > 0):
                raise ValueError("MoE layers need num_experts, "
                                 "num_experts_per_tok and "
                                 "moe_intermediate_size")
            held = self.held
            if self.moe_layers and (
                    not held or len(set(held)) != len(held)
                    or not all(0 <= e < self.num_experts for e in held)):
                raise ValueError(f"held_experts {held} are not distinct "
                                 f"ids of the {self.num_experts} experts")

    def is_sliding(self, layer: int) -> bool:
        return (self.layer_types is not None
                and self.layer_types[layer] == "sliding_attention")

    def is_moe(self, layer: int) -> bool:
        return (self.mlp_layer_types is not None
                and self.mlp_layer_types[layer] == "sparse")

    @property
    def global_layers(self) -> tuple:
        """The full-attention layers: the ones a KV cache (full or
        ShadowKV) holds."""
        return tuple(i for i in range(self.num_layers)
                     if not self.is_sliding(i))

    @property
    def sliding_layers(self) -> tuple:
        return tuple(i for i in range(self.num_layers) if self.is_sliding(i))

    @property
    def moe_layers(self) -> tuple:
        return tuple(i for i in range(self.num_layers) if self.is_moe(i))

    @property
    def held(self) -> tuple:
        """The routed experts held here."""
        return (tuple(range(self.num_experts)) if self.held_experts is None
                else self.held_experts)

    @property
    def nope_global(self) -> bool:
        """The full-attention layers take no RoPE (EXAONE 4 with sliding
        layers); the sliding layers rotate by ``rope_style``."""
        return self.exaone4_block and bool(self.sliding_layers)

    def is_nope(self, layer: int) -> bool:
        return self.nope_global and not self.is_sliding(layer)

    @property
    def is_hybrid(self) -> bool:
        """A model with sliding layers, MoE layers or EXAONE 4's block: the
        forward serves it on one device (``models/engine.py``)."""
        return bool(self.sliding_layers or self.moe_layers
                    or self.exaone4_block)

    @property
    def rope_scaling_dict(self) -> Optional[dict]:
        return dict(self.rope_scaling) if self.rope_scaling else None

    @property
    def num_groups(self) -> int:
        """GQA group size (query heads per KV head)."""
        return self.num_heads // self.num_kv_heads

    @property
    def q_size(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_size(self) -> int:
        return self.num_kv_heads * self.head_dim

    @property
    def rope_dim(self) -> int:
        """Number of head dims that get rotary applied."""
        return self.rope_partial_dim or self.head_dim


@dataclasses.dataclass(frozen=True)
class CacheConfig:
    """KV-cache / sparse-attention policy (defaults as in the JAX package)."""

    mode: str = "full"  # 'full' | 'shadow' | 'shadow_offload'
    max_length: int = 32 * 1024
    sparse_budget: int = 2048
    rank: int = 160
    chunk_size: int = 8
    local_chunks: int = 4
    # None = the reference's (sparse_budget // 1024) * 24.
    outlier_chunks: Optional[int] = None
    gen_capacity: int = 256
    kv_quant: str = "none"  # 'none' | 'int8'

    def resolved_outlier_chunks(self) -> int:
        if self.outlier_chunks is not None:
            return self.outlier_chunks
        return max(1, (self.sparse_budget // 1024) * 24)

    @property
    def select_sets(self) -> int:
        if self.sparse_budget % self.chunk_size:
            raise ValueError("sparse_budget must be a multiple of chunk_size")
        return self.sparse_budget // self.chunk_size

    @property
    def is_shadow(self) -> bool:
        return self.mode in ("shadow", "shadow_offload")

    def check_served(self) -> None:
        if self.mode not in ("full", "shadow", "shadow_offload"):
            raise ValueError(f"unknown cache mode {self.mode!r}")
        if self.kv_quant not in ("none", "int8"):
            raise ValueError(f"unknown kv_quant {self.kv_quant!r}")


@dataclasses.dataclass(frozen=True)
class RuntimeConfig:
    """Execution configuration: prefill batching and the decode path.
    (Sampling settings are arguments of ``Engine.generate``; the slot
    count of continuous batching is an argument of ``ContinuousBatcher``.)"""

    # Prefill runs in sub-batches of this many sequences.
    prefill_sub_batch: int = 4
    # 'dense' and 'dense-splash' are the same causal function and run the
    # same prefill kernel here; 'stream' is attention-sink + sliding
    # window (kernel C); 'vs' the MInference per-head patterns
    # (core/minference.py, kernel F or G).
    prefill_pattern: str = "dense"
    stream_window: int = 8192
    stream_sink: int = 1024
    # MInference 'vs' knobs (JAX defaults).
    vs_vertical_size: int = 1000
    vs_slash_size: int = 6144
    vs_block: int = 128
    # 'tile' = token-granular verticals + diagonal tiles (kernel F);
    # 'walk' = the per-block walk over column and diagonal blocks (G).
    vs_impl: str = "tile"
    # The JAX tile kernel's query-tile width. Kept for config parity; it
    # changes nothing here: kernel F tiles by 64 and pads S to that.
    vs_tile: int = 512
    # Per-q-head table of (kind, vertical_size, slash_size) tuples or kind
    # strings, uniform over layers; None = all heads vertical_and_slash.
    minference_patterns: Optional[tuple] = None
    # Per-layer table: num_layers per-head tables (no block_sparse).
    # Takes precedence over minference_patterns.
    minference_layer_patterns: Optional[tuple] = None
    # BENCHMARK-ONLY MInference score simulation (core/minference.py
    # sim_vs_scores): None, or 'clustered' (decaying slashes plus hot
    # verticals in place of the estimated scores). Uniform pattern tables
    # only, as in JAX: a per-layer table ignores it.
    vs_sim: Optional[str] = None
    # Shadow decode path: True = the fused sparse-refresh kernel (hit
    # reuse, misses only); None/False = the XLA-gather branch (every
    # selected chunk gathered, hits kept by a select); 'auto' = switch
    # between them on the slot hit rate sampled every
    # pallas_auto_interval steps ('shadow' mode, no ring_gather).
    use_pallas: Optional[object] = None
    # 'auto' switches to the fused refresh when the hit-rate EMA is
    # above this; None = H100_HIT_THRESHOLD for the cache's chunk size.
    pallas_hit_threshold: Optional[float] = None
    pallas_auto_interval: int = 16
    # Dead-band around the threshold: 'auto' turns the kernel on above
    # threshold + band and off below threshold - band (JAX's rule).
    pallas_auto_deadband: float = 0.05
    # The XLA-gather branch's gather through the chunk-gather kernel
    # (kernels/gather.py) instead of tensor indexing. Excludes use_pallas.
    ring_gather: Optional[bool] = None
    # Observe-only slot-hit-rate sampling (one consecutive step pair per
    # pallas_auto_interval decode steps); kv_stats() reports it.
    track_hit_rate: bool = False
    selection_hysteresis: float = 0.0
    # BENCHMARK-ONLY forced selection: every layer selects a window of
    # select_sets chunk ids that slides by select_sets * (1 - rate) per
    # step, so the slot hit rate is ``rate`` by construction; 'scatter'
    # maps the window through a fixed bijection, 'contig' keeps it. The
    # window ignores the landmark mask: never combine with accuracy runs.
    debug_hit_rate: Optional[float] = None
    debug_hit_layout: str = "scatter"
    # Decode attention over the compact buffer's segments (static prefix,
    # sparse region, gen region) instead of one view of the whole buffer,
    # on the XLA-gather branch (core/attention.py
    # decode_attention_segments); the fused refresh ignores it.
    decode_segmented: Optional[bool] = None
    # > 1: the layer-segmented offload prefill: the whole batch in one
    # call, its store recorded as sharded over layers, so admissions are
    # refused (shadow_offload with ring_gather only; the layers must divide
    # evenly). Each layer's V rows go straight into the pinned store, so
    # no segment is staged on the card (models/engine.py).
    offload_prefill_segments: int = 1
    # Weight-only quantization of the dense path ('none' | 'int8':
    # per-output-channel QTensor leaves, core/wquant.py). Informational,
    # as in JAX: the params' leaves decide; LLM and the loaders set both.
    weight_quant: str = "none"
    # Parallelism (parallel/mesh.py): data, tensor, sequence and pipeline
    # ranks of one model replica; one process per rank.
    dp: int = 1
    tp: int = 1
    sp: int = 1
    pp: int = 1
    # Decode steps run eagerly on the card (no CUDA graph); a gloo mesh on
    # the card needs it. A CPU engine always steps eagerly.
    eager_decode: bool = False

    @property
    def mesh_size(self) -> int:
        return self.dp * self.tp * self.sp * self.pp

    def check_parallel(self, cache: CacheConfig) -> None:
        """The JAX engine's composition rules of dp/tp/sp/pp
        (``ValueError``)."""
        for name in ("dp", "tp", "sp", "pp"):
            if getattr(self, name) < 1:
                raise ValueError(f"{name} must be >= 1")
        kernel = bool(self.ring_gather or self.use_pallas)
        if self.pp > 1:
            if self.sp > 1:
                raise ValueError("pp x sp unsupported")
            if self.tp > 1 and self.dp > 1:
                raise ValueError(
                    "pp composes with EITHER dp OR tp; a 3-axis pp x dp x tp "
                    "mesh is unsupported")
            if cache.mode != "shadow":
                raise ValueError("pp > 1 supports cache mode 'shadow' only")
            if kernel:
                raise ValueError("pp > 1 runs the XLA decode path (no "
                                 "use_pallas, no ring_gather)")
            if self.tp > 1 and cache.kv_quant != "none":
                raise ValueError("pp x tp serves kv_quant='none'")
        if self.sp > 1:
            if cache.mode != "shadow":
                raise ValueError("sp > 1 supports cache mode 'shadow' only")
            if kernel:
                raise ValueError("sp > 1 runs the XLA decode path (no "
                                 "use_pallas, no ring_gather)")
        if self.mesh_size > 1 and self.offload_prefill_segments > 1:
            raise ValueError("the segmented offload prefill serves one rank")
        if (self.pp > 1 and self.prefill_pattern == "vs"
                and self.minference_layer_patterns is not None):
            raise ValueError("per-layer MInference tables are not supported "
                             "under pp")
        if self.sp > 1 and self.prefill_pattern not in ("dense",
                                                        "dense-splash"):
            raise ValueError("the sequence-parallel prefill is dense")

    def check_served(self, cache: CacheConfig) -> None:
        """Raise ``ValueError`` for unknown values and for combinations the
        JAX engine rejects."""
        if self.prefill_pattern not in ("dense", "dense-splash", "stream",
                                        "vs"):
            raise ValueError(f"unknown prefill_pattern {self.prefill_pattern!r}")
        if self.weight_quant not in ("none", "int8"):
            raise ValueError(f"unknown weight_quant {self.weight_quant!r}")
        if self.vs_impl not in ("tile", "walk"):
            raise ValueError(f"unknown vs_impl {self.vs_impl!r}")
        if self.vs_sim not in (None, "clustered"):
            raise ValueError(f"unknown vs_sim regime {self.vs_sim!r} "
                             "(supported: 'clustered')")
        if self.use_pallas not in (None, True, False, "auto"):
            raise ValueError(
                f"use_pallas must be None/True/False/'auto', got "
                f"{self.use_pallas!r}"
            )
        if self.debug_hit_layout not in ("scatter", "contig"):
            raise ValueError(
                f"unknown debug_hit_layout {self.debug_hit_layout!r}"
            )
        self.check_parallel(cache)
        if self.offload_prefill_segments < 1:
            raise ValueError("offload_prefill_segments must be >= 1")
        if self.offload_prefill_segments > 1 and not (
            cache.mode == "shadow_offload" and self.ring_gather
        ):
            raise ValueError(
                "segmented offload prefill serves the single-chip ring path: "
                "mode='shadow_offload' with ring_gather=True"
            )
        if self.use_pallas == "auto":
            if cache.mode != "shadow":
                raise ValueError(
                    "use_pallas='auto' supports the 'shadow' mode only"
                )
            if self.ring_gather:
                raise ValueError(
                    "use_pallas='auto' switches between the XLA-gather "
                    "branch and the fused kernel; it does not compose with "
                    "ring_gather"
                )
        if not cache.is_shadow:
            return
        if self.use_pallas and self.ring_gather:
            raise ValueError(
                "use_pallas and ring_gather are mutually exclusive decode "
                "paths"
            )
        if (cache.mode == "shadow_offload" and cache.kv_quant != "none"
                and not (self.use_pallas or self.ring_gather)):
            raise ValueError(
                "offload + quantized V store needs ring_gather=True or "
                "use_pallas=True (the host V store path serves bf16 rows "
                "only)"
            )

    def hit_threshold(self, cache: CacheConfig) -> float:
        """The 'auto' switch point: ``pallas_hit_threshold``, or the H100
        crossover measured at chunk size 16 for chunks of 16 and more, at
        chunk size 8 below (the JAX engine's split of its own defaults)."""
        if self.pallas_hit_threshold is not None:
            return self.pallas_hit_threshold
        return H100_HIT_THRESHOLD[16 if cache.chunk_size >= 16 else 8]
