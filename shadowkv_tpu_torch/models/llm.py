"""High-level LLM interface: tokenizer + templates + engine (counterpart of
``shadowkv_tpu/models/llm.py``).

One class serves every model family: family differences (RoPE style,
biases, templates, stop tokens) are data in ModelConfig and
``prompt_templates``. The model runs on ``device="cuda"`` unless the caller
passes another device; without a card that raises, as ``Engine`` does.

Weights come from a local HF checkpoint (``model_dir``, or the
``SHADOWKV_MODEL_DIR`` environment variable; its ``config.json`` is
authoritative for the dims), read by the port's own safetensors reader, or
else are synthetic, drawn from a seeded ``torch.Generator`` on the device
(throughput measurement only). The tokenizer is optional and local:
``transformers`` is imported only inside ``load_tokenizer``, which reads
local files only, and without a local tokenizer (or without
``transformers``) the LLM keeps to token ids.
"""

from __future__ import annotations

import os
import sys
from typing import Optional

import numpy as np
import torch

from shadowkv_tpu_torch.config import CacheConfig, ModelConfig, RuntimeConfig
from shadowkv_tpu_torch.models.engine import Engine, GenerationStats
from shadowkv_tpu_torch.models.params import (
    init_synthetic_params,
    load_hf_params,
)
from shadowkv_tpu_torch.models.prompt_templates import (
    CHAT_TEMPLATES,
    CTX_TEMPLATES,
    PREFIX_TEMPLATES,
    STOP_STRINGS,
    template_family,
)
from shadowkv_tpu_torch.models.registry import (
    choose_model_config,
    config_from_hf_dir,
)

MODE_ALIASES = {"shadowkv": "shadow", "shadowkv_cpu": "shadow_offload"}
SYNTHETIC_SEED = 0


def model_config(model_name: str, model_dir: Optional[str] = None,
                 dtype=None) -> ModelConfig:
    """The ModelConfig ``LLM`` runs: a local checkpoint's ``config.json``
    (authoritative for the dims), else the registry entry of the name."""
    overrides = {"dtype": dtype} if dtype is not None else {}
    if model_dir and os.path.exists(os.path.join(model_dir, "config.json")):
        return config_from_hf_dir(model_dir, name=model_name, **overrides)
    return choose_model_config(model_name, **overrides)


def load_tokenizer(model_dir: Optional[str], model_name: str):
    """The HF tokenizer of a local checkpoint, or of a model name already in
    the local HF cache, or None: without ``transformers``, or with no local
    tokenizer, callers keep to token ids. Local files only: it never asks
    the network."""
    try:
        from transformers import AutoTokenizer
    except ImportError:
        AutoTokenizer = None
    for candidate in (model_dir, model_name):
        if not candidate or AutoTokenizer is None:
            continue
        try:
            return AutoTokenizer.from_pretrained(
                candidate, trust_remote_code=True, local_files_only=True)
        except Exception:  # no tokenizer files there
            continue
    print("[LLM] no local tokenizer (or no transformers); token-id "
          "interfaces only",
          file=sys.stderr)
    return None


class LLM:
    """A loaded model + tokenizer + inference engine.

    The arguments are JAX ``LLM``'s (``attn_mode`` in {'full', 'shadow',
    'shadow_offload'}, 'shadowkv'/'shadowkv_cpu' accepted as aliases;
    sparse defaults budget 2048, rank 160, chunk 8), plus ``device``.
    ``minference`` True or 'vs' selects the per-head vertical + slash
    prefill, 'stream' the sink + window prefill. ``approx_topk`` is
    accepted for the JAX flag and ignored: JAX takes ``approx_max_k`` only
    off the CPU, and XLA's approximate top-k is exact outside the TPU, so
    the port runs its exact top-k either way and the reference's
    ``--approx_topk 1`` command lines run unchanged."""

    def __init__(
        self,
        model_name: str,
        batch_size: int = 1,
        max_length: int = 64 * 1024,
        attn_mode: str = "full",
        sparse_budget: int = 2048,
        rank: int = 160,
        chunk_size: int = 8,
        model_dir: Optional[str] = None,
        dtype=None,
        minference=False,
        prefill_sub_batch: int = 4,
        gen_capacity: int = 256,
        dp: int = 1,
        tp: int = 1,
        sp: int = 1,
        pp: int = 1,
        weight_quant: str = "none",
        track_hit_rate: bool = False,
        kv_quant: str = "none",
        approx_topk: Optional[bool] = None,
        stream_sink: Optional[int] = None,
        stream_window: Optional[int] = None,
        use_pallas=None,
        selection_hysteresis: float = 0.0,
        device="cuda",
        mesh=None,
    ):
        """``dp/tp/sp/pp`` above 1 run this process as one rank of the
        model's mesh (``parallel/mesh.py``): the process group must be
        initialised (``torchrun``; ``eval/evaluator.py::init_dist``) with a
        world size of dp * tp * sp * pp, unless ``mesh`` gives this rank's
        mesh within a larger world (data-parallel replicas of the
        evaluator). On the card a mesh's backend is NCCL: the decode step
        is captured with its collectives."""
        n_ranks = dp * tp * sp * pp
        if mesh is None and n_ranks > 1:
            import torch.distributed as dist

            world = (dist.get_world_size()
                     if dist.is_available() and dist.is_initialized() else 1)
            if world != n_ranks:
                raise ValueError(
                    f"dp*tp*sp*pp = {n_ranks} ranks, but the world size is "
                    f"{world} (launch one process per rank, e.g. torchrun "
                    f"--nproc-per-node {n_ranks})")
        weight_quant = weight_quant or "none"
        if weight_quant not in ("none", "int8"):
            raise ValueError(f"unknown weight_quant {weight_quant!r}")
        attn_mode = MODE_ALIASES.get(attn_mode, attn_mode)
        # The engine's device check, before any weight is made.
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "LLM(device='cuda') needs a CUDA device and none is "
                "available; pass device='cpu' to run the plain kernel "
                "versions on the CPU")
        self.model_name = model_name
        self.model_dir = model_dir or os.environ.get("SHADOWKV_MODEL_DIR", "")
        self.config = model_config(model_name, self.model_dir, dtype)
        self.family = template_family(model_name)
        self.batch_size = batch_size
        self.tokenizer = self._load_tokenizer()
        params = self._load_params(weight_quant)

        self.cache_cfg = CacheConfig(
            mode=attn_mode, max_length=max_length,
            sparse_budget=sparse_budget, rank=rank, chunk_size=chunk_size,
            gen_capacity=gen_capacity, kv_quant=kv_quant,
        )
        if minference is True:
            pattern = "vs"
        elif minference in ("vs", "stream"):
            pattern = minference
        elif not minference:
            pattern = "dense"
        else:
            raise ValueError(f"unknown minference {minference!r}")
        stream_kw = {}
        if stream_sink is not None:
            stream_kw["stream_sink"] = stream_sink
        if stream_window is not None:
            stream_kw["stream_window"] = stream_window
        rt = RuntimeConfig(
            prefill_sub_batch=prefill_sub_batch, prefill_pattern=pattern,
            weight_quant=weight_quant, track_hit_rate=track_hit_rate,
            use_pallas=use_pallas,
            selection_hysteresis=selection_hysteresis,
            dp=dp, tp=tp, sp=sp, pp=pp,
            **stream_kw,
        )
        self.engine = Engine(self.config, self.cache_cfg, rt, params,
                             device=self.device, mesh=mesh)
        del params  # the engine holds this rank's shard
        self.stop_ids = self._resolve_stop_ids()
        self.stats: Optional[GenerationStats] = None  # of the last call

    # -- setup ---------------------------------------------------------------

    def _load_tokenizer(self):
        return load_tokenizer(self.model_dir, self.model_name)

    def _load_params(self, weight_quant: str):
        if self.model_dir and os.path.isdir(self.model_dir):
            # The loader quantizes on the host: the device holds only the
            # final params.
            return load_hf_params(self.model_dir, self.config,
                                  weight_quant=weight_quant,
                                  device=self.device)
        print(f"[LLM] no checkpoint dir for {self.model_name}; using "
              "synthetic weights (throughput measurement only)",
              file=sys.stderr)
        gen = torch.Generator(device=self.device).manual_seed(SYNTHETIC_SEED)
        return init_synthetic_params(self.config, gen, device=self.device,
                                     weight_quant=weight_quant)

    def _resolve_stop_ids(self) -> tuple[int, ...]:
        if self.tokenizer is None:
            return ()
        ids = []
        for s in STOP_STRINGS.get(self.family, []):
            tid = self.tokenizer.convert_tokens_to_ids(s)
            if tid is not None and tid >= 0:
                ids.append(int(tid))
        eos = getattr(self.tokenizer, "eos_token_id", None)
        if eos is not None:
            ids.append(int(eos))
        return tuple(dict.fromkeys(ids))

    # -- prompting -------------------------------------------------------------

    def _need_tokenizer(self) -> None:
        if self.tokenizer is None:
            raise ValueError("no tokenizer loaded; pass token ids")

    def encode(self, text: str, template: Optional[str] = None) -> np.ndarray:
        """Tokenize with an optional model template ('ctx', 'chat' or
        'prefix'); [1, S] int32."""
        self._need_tokenizer()
        if template == "ctx":
            text = CTX_TEMPLATES[self.family].format(ctx=text)
        elif template == "chat":
            text = CHAT_TEMPLATES[self.family].format(msg=text)
        elif template == "prefix":
            text = PREFIX_TEMPLATES[self.family].format(ctx=text)
        ids = self.tokenizer.encode(text, add_special_tokens=False)
        return np.asarray(ids, np.int32)[None]

    def decode(self, token_rows) -> list[str]:
        self._need_tokenizer()
        out = []
        for row in token_rows:
            row = [int(t) for t in row if int(t) not in self.stop_ids]
            out.append(self.tokenizer.decode(row, skip_special_tokens=True))
        return out

    def _out(self, tokens: np.ndarray):
        """Decoded text, or the token ids when there is no tokenizer."""
        return self.decode(tokens) if self.tokenizer is not None else tokens

    # -- generation ------------------------------------------------------------

    def generate(
        self,
        input_ids,
        gen_len: int = 256,
        temperature: float = 0.0,
        top_k: int = 50,
        top_p: float = 0.9,
        verbose: bool = False,
        seed: int = 0,
        cont: bool = False,
    ):
        """Generate for a [B, S] batch of token ids; returns the decoded
        texts (the [B, <=gen_len] ids without a tokenizer). ``cont=True``
        continues the previous call's cache (chat turns against a
        prefilled or loaded context)."""
        input_ids = np.atleast_2d(np.asarray(input_ids))
        tokens, self.stats = self.engine.generate(
            input_ids, gen_len=gen_len, temperature=temperature, top_k=top_k,
            top_p=top_p, seed=seed, stop_ids=self.stop_ids, cont=cont,
        )
        if verbose:
            print(f"prefill {self.stats.prefill_tokens} tok in "
                  f"{self.stats.prefill_seconds:.1f}s | decode "
                  f"{self.stats.decode_tokens_per_second:.1f} tok/s",
                  file=sys.stderr)
        return self._out(tokens)

    def batch_generate(
        self,
        input_ids,
        gen_len: int = 100,
        temperature: float = 0.6,
        top_k: int = 50,
        top_p: float = 0.9,
        benchmark: bool = False,
        seed: int = 0,
    ):
        """Throughput loop; returns (decoded texts or ids, decode tokens/s).
        ``benchmark`` is accepted for the reference's signature; the rate
        is always returned."""
        tokens, self.stats = self.engine.batch_generate(
            np.asarray(input_ids), gen_len=gen_len, temperature=temperature,
            top_k=top_k, top_p=top_p, seed=seed,
        )
        return self._out(tokens), self.stats.decode_tokens_per_second

    # -- context checkpoints ---------------------------------------------------

    def save_context(self, path: str) -> None:
        """Persist the prefilled context (``utils/checkpoint.py``); resume
        it with ``load_context`` and ``generate(..., cont=True)``."""
        self.engine.save_state(path)

    def load_context(self, path: str) -> None:
        self.engine.load_state(path)

    def __str__(self) -> str:
        """One line, with the device memory in use (``torch.cuda``)."""
        mem = ""
        if self.device.type == "cuda":
            used = torch.cuda.memory_allocated(self.device) / 2**30
            total = torch.cuda.get_device_properties(
                self.device).total_memory / 2**30
            mem = f", device mem: {used:.2f} / {total:.2f} GB"
        return (
            f"LLM: {self.model_name}, attn_mode: {self.cache_cfg.mode}, "
            f"max_length: {self.cache_cfg.max_length}, batch_size: "
            f"{self.batch_size}, device: {self.device}, dtype: "
            f"{str(self.config.dtype).removeprefix('torch.')}{mem}"
        )

    def print_kv_stats(self) -> None:
        """KV memory accounting: the engine's measured live-cache stats, or
        before any prefill an estimate from the configs."""
        if self.engine._cache is not None:
            self.engine.print_kv_stats()
            return
        cfg, cc = self.config, self.cache_cfg
        bytes_per = 4 if cfg.dtype == torch.float32 else 2
        full = (2 * cfg.num_layers * self.batch_size * cfg.num_kv_heads
                * cc.max_length * cfg.head_dim * bytes_per)
        if cc.mode == "full":
            print(f"[KV] full cache: {full / 2**30:.2f} GiB")
            return
        rank_bytes = (cfg.num_layers * self.batch_size * cc.max_length
                      * cc.rank * bytes_per)
        sv = (cfg.num_layers * self.batch_size * cfg.num_kv_heads * cc.rank
              * cfg.head_dim * bytes_per)
        bufcap = cc.sparse_budget + cc.gen_capacity + 2048
        bufs = (2 * cfg.num_layers * self.batch_size * cfg.num_kv_heads
                * bufcap * cfg.head_dim * bytes_per)
        where = "host" if cc.mode == "shadow_offload" else "device"
        print(
            f"[KV] shadow: U {rank_bytes / 2**30:.2f} + SV "
            f"{sv / 2**30:.3f} + buffers {bufs / 2**30:.2f} GiB on the "
            f"device; V store {full // 2 / 2**30:.2f} GiB on the {where}; "
            f"full-attn equivalent {full / 2**30:.2f} GiB")
