"""The inference engine: prefill + autoregressive decode loops
(counterpart of ``shadowkv_tpu/models/engine.py``, single device, no mesh).

The engine runs on ``device="cuda"`` unless the caller passes another
device; asking for CUDA on a machine without one raises, it never falls
back to the CPU. Prefill runs in sub-batches into one preallocated cache.
Decode runs one eager step per token (JAX jits each step; a CUDA graph of
the step is later work).

``mode="shadow_offload"`` keeps the V store in host memory: one tensor,
pinned when the engine runs on the card (a plain CPU tensor on a CPU
engine, so the same code runs in the tests), allocated at prefill. Each
layer of each prefill sub-batch copies its V rows straight into it, so the
full-batch V store is never on the card; the JAX engine instead prefills a
sub-batch's whole V store on the device and evicts it after the sub-batch.
Decode reads the host store in place through the fused refresh kernel
(misses only) or the chunk-gather kernel (every selected chunk); no host
copy enters the decode step. Not ported (ROADMAP.md §1 'Host offload,
rest'): the ``HostVStore`` io_callback path, the layer-segmented offload
prefill, per-slot host parts and the TPU's 4096-byte host layout.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from shadowkv_tpu_torch.cache.full import FullCache
from shadowkv_tpu_torch.cache.shadow import ShadowCache, ShadowLayout
from shadowkv_tpu_torch.config import CacheConfig, ModelConfig, RuntimeConfig
from shadowkv_tpu_torch.core import rope as rope_lib
from shadowkv_tpu_torch.core.layers import ModelParams
from shadowkv_tpu_torch.core.sampling import sample_token
from shadowkv_tpu_torch.models import forward


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


def _resolve_device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "Engine(device='cuda') needs a CUDA device and none is available; "
            "pass device='cpu' to run the plain kernel versions on the CPU"
        )
    return device


class Engine:
    """Single-device inference engine over one model + cache config."""

    def __init__(
        self,
        model: ModelConfig,
        cache_cfg: CacheConfig,
        rt: RuntimeConfig,
        params: ModelParams,
        device="cuda",
        sketch: torch.Tensor | None = None,
    ):
        """``sketch`` optionally fixes the low-rank Gaussian sketch
        (core/lowrank.py); by default it is drawn from a seeded generator."""
        self.device = _resolve_device(device)
        cache_cfg.check_served()
        rt.check_served(cache_cfg)
        forward.check_layer_patterns(rt, model)
        self.model = model
        self.cache_cfg = cache_cfg
        self.rt = rt
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
        # chunk-gather kernel with ring_gather=True.
        self.use_kernel = bool(rt.use_pallas)
        self.ring_gather = bool(rt.ring_gather)
        self.v_on_host = cache_cfg.mode == "shadow_offload"
        self._cache = None
        self._hit_samples: list[torch.Tensor] = []
        self._hit_ema: torch.Tensor | None = None
        self._hit_prev_ids = None
        self._hit_counter = 0

    @property
    def is_shadow(self) -> bool:
        return self.cache_cfg.is_shadow

    # -- prefill ------------------------------------------------------------

    def prefill(self, input_ids) -> tuple[torch.Tensor, object]:
        """Prefill in sub-batches; returns (last-token logits [B, 1, V] f32,
        cache)."""
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
        self._cache = None
        parts = []
        if self.is_shadow:
            layout = ShadowLayout.build(self.cache_cfg, s)
            cache = ShadowCache.init(self.model, layout, b, self.device,
                                     v_on_host=self.v_on_host)
            for b0 in range(0, b, t):
                parts.append(forward.prefill_shadow_into(
                    self.model, self.params, cache, input_ids[b0:b0 + t],
                    self.cos_table, self.sin_table, b0, self.sketch, self.rt,
                ))
        else:
            cache = FullCache.init(self.model, self.cache_cfg, b, self.device)
            for b0 in range(0, b, t):
                parts.append(forward.prefill_full(
                    self.model, self.params, cache, input_ids[b0:b0 + t],
                    self.cos_table, self.sin_table, b0, self.rt,
                ))
        self._cache = cache
        return torch.cat(parts, dim=0), cache

    # -- decode -------------------------------------------------------------

    def _decode(self, cache, tokens: torch.Tensor) -> torch.Tensor:
        """One decode step; returns logits [B, 1, V]."""
        if self.is_shadow:
            logits = forward.decode_shadow(
                self.model, self.params, cache, tokens, self.cos_table,
                self.sin_table, self.inv_freq_full,
                hysteresis=self.rt.selection_hysteresis,
                use_kernel=self.use_kernel, ring=self.ring_gather,
                debug_hit_rate=self.rt.debug_hit_rate,
                debug_hit_layout=self.rt.debug_hit_layout,
            )
            if self.rt.track_hit_rate:
                self._observe_hits(cache)
            return logits
        return forward.decode_full(
            self.model, self.params, cache, tokens, self.cos_table,
            self.sin_table,
        )

    def _observe_hits(self, cache: ShadowCache) -> None:
        """Sample the slot hit rate on one consecutive step pair per
        ``pallas_auto_interval`` steps. Slot-stable assignment makes "slot
        id unchanged" the same as "hit", so the rate is the mean of
        ``ids[t] == ids[t+1]``. Samples stay on the device until
        ``kv_stats`` reads them, so the decode loop never syncs here."""
        phase = self._hit_counter % max(2, self.rt.pallas_auto_interval)
        self._hit_counter += 1
        if phase == 0:
            self._hit_prev_ids = cache.cached_ids.clone()
        elif phase == 1 and self._hit_prev_ids is not None:
            frac = (self._hit_prev_ids == cache.cached_ids).float().mean()
            self._hit_prev_ids = None
            ema = self._hit_ema
            self._hit_ema = frac if ema is None else 0.5 * ema + 0.5 * frac
            self._hit_samples.append(frac)

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
    ) -> tuple[np.ndarray, GenerationStats]:
        """Generate for a batch of equal-length prompts; returns
        ([B, <=gen_len] ids, stats). Stop tokens truncate per sequence
        afterwards (the batch decodes to the end, as the reference does)."""
        stats = GenerationStats()
        b, s = np.asarray(input_ids).shape
        self._check_capacity(s, gen_len)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        sample_args = (temperature, top_k, top_p)
        t0 = time.perf_counter()
        logits, cache = self.prefill(input_ids)
        tokens = sample_token(logits[:, -1], gen, *sample_args)
        self._sync()
        stats.prefill_seconds = time.perf_counter() - t0
        stats.prefill_tokens = b * s

        out = [tokens.cpu().numpy()]
        t0 = time.perf_counter()
        for _ in range(gen_len - 1):
            logits = self._decode(cache, tokens[:, None])
            tokens = sample_token(logits[:, -1], gen, *sample_args)
            out.append(tokens.cpu().numpy())
            if stop_ids and b == 1 and out[-1][0] in stop_ids:
                break
        self._sync()
        stats.decode_seconds = time.perf_counter() - t0
        stats.decode_tokens = b * (len(out) - 1)
        result = np.stack(out, axis=1)
        if stop_ids:
            result = _truncate_at_stop(result, stop_ids)
        return result, stats

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
        steps, then ``gen_len`` timed steps with no host sync inside the
        loop. Returns ([B, gen_len] ids of the timed steps, stats)."""
        b, s = np.asarray(input_ids).shape
        self._check_capacity(s, gen_len + warmup_steps)
        stats = GenerationStats()
        gen = torch.Generator(device=self.device).manual_seed(seed)
        sample_args = (temperature, top_k, top_p)
        self._cache = None  # never hold two caches at the prefill peak
        t0 = time.perf_counter()
        logits, cache = self.prefill(input_ids)
        tokens = sample_token(logits[:, -1], gen, *sample_args)
        self._sync()
        stats.prefill_seconds = time.perf_counter() - t0
        stats.prefill_tokens = b * s

        for _ in range(warmup_steps):
            logits = self._decode(cache, tokens[:, None])
            tokens = sample_token(logits[:, -1], gen, *sample_args)
        self._sync()
        out = []
        t0 = time.perf_counter()
        for _ in range(gen_len):
            logits = self._decode(cache, tokens[:, None])
            tokens = sample_token(logits[:, -1], gen, *sample_args)
            out.append(tokens)
        self._sync()
        stats.decode_seconds = time.perf_counter() - t0
        stats.decode_tokens = b * gen_len
        return torch.stack(out, dim=1).cpu().numpy(), stats

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
            host_bytes = bytes_by_field.pop("v_full")
        out["device_bytes"] = sum(bytes_by_field.values())
        out["host_bytes"] = host_bytes
        if self.is_shadow:
            out["cached"] = cache.kv_len
            if self._hit_samples:
                out.update(
                    hit_rate_mean=float(torch.stack(self._hit_samples).mean()),
                    hit_rate_ema=float(self._hit_ema),
                    hit_samples=len(self._hit_samples),
                )
        else:
            out["cached"] = cache.length
        return out


def _truncate_at_stop(tokens: np.ndarray, stop_ids: tuple[int, ...]):
    """Overwrite everything after the first stop token per row."""
    out = tokens.copy()
    for row in range(out.shape[0]):
        hits = np.isin(out[row], stop_ids).nonzero()[0]
        if hits.size:
            out[row, hits[0]:] = stop_ids[0]
    return out
