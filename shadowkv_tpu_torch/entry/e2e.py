"""End-to-end decode-throughput benchmark (counterpart of
``shadowkv_tpu/entry/e2e.py``, after the reference's ``test/e2e.py``):
the full-attention baseline at its largest batch, then ShadowKV at its
(larger) batch, on ruler/qa_2 prompts cut to the target length; reports
tokens/s of each and the speedup as one JSON line.

    python -m shadowkv_tpu_torch.entry.e2e --datalen 122k --model_dir DIR

``measure`` is the measurement itself (baseline run, then shadow run, then
the speedup JSON) over given token rows; ``main`` builds the rows from
``Dataset("ruler/qa_2", ...)``, which needs a local tokenizer. A caller
without one passes its own rows to ``measure``.

The batch sizes are reckoned for one 80 GB card from the cache's bytes per
sequence (``plan_batch``), not taken from a table. They are not measured:
the prefill's activations are only a fixed headroom here.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
from typing import Optional

import numpy as np
import torch

from shadowkv_tpu_torch.cache.full import FullCache
from shadowkv_tpu_torch.cache.shadow import ShadowCache, ShadowLayout
from shadowkv_tpu_torch.config import CacheConfig, ModelConfig

# (sparse_budget, prompt length) per datalen, the reference's
# (test/e2e.py). Its batches on an 80 GB A100 (baseline / ShadowKV):
# 60k 8 / 48, 122k 4 / 24, 244k 2 / 12 (with bf16 V offloaded to the host
# in ShadowKV's case); here ``plan_batch`` reckons both from the cache.
CONFIGS = {
    "60k": dict(sparse_budget=1024, min_prompt_len=1024 * 60),
    "122k": dict(sparse_budget=2048, min_prompt_len=1024 * 122),
    "244k": dict(sparse_budget=4096, min_prompt_len=1024 * 244),
}
EXTRA_LEN = 28  # max_length = prompt + gen_len + 28, as the reference
CARD_BYTES = 79.2 * 2**30  # what an H100 80GB shows (mem_get_info total)
# Left for the prefill's activations and the decode graph's pool: a guess,
# not a measurement.
HEADROOM_BYTES = 4.0 * 2**30


def weight_bytes(cfg: ModelConfig, weight_quant: str = "none") -> int:
    """Bytes of the params (``init_synthetic_params``' leaves)."""
    item = torch.tensor([], dtype=cfg.dtype).element_size()
    d, i, v, l = (cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size,
                  cfg.num_layers)
    qkv = (cfg.num_heads + 2 * cfg.num_kv_heads) * cfg.head_dim
    mats = [(d, qkv), (cfg.q_size, d), (d, 2 * i), (i, d)]
    vecs = 2 * d + (qkv if cfg.qkv_bias else 0)
    if weight_quant == "int8":  # int8 values + f32 scales per column/row
        layer = sum(a * b + 4 * b for a, b in mats)
        tables = 2 * (v * d + 4 * v)
    else:
        layer = sum(a * b for a, b in mats) * item
        tables = 2 * v * d * item
    return l * (layer + vecs * item) + tables + d * item


def cache_bytes_per_seq(cfg: ModelConfig, cache_cfg: CacheConfig,
                        prompt_len: int) -> int:
    """Device bytes of one sequence's cache: the cache built on the meta
    device (shapes only), its fields summed."""
    if cache_cfg.is_shadow:
        lo = ShadowLayout.build(cache_cfg, prompt_len)
        cache = ShadowCache.init(cfg, lo, 1, device="meta")
        fields = [getattr(cache, n) for n in ShadowCache.FIELDS
                  if not (n == "v_full" and cache_cfg.mode == "shadow_offload")]
    else:
        cache = FullCache.init(cfg, cache_cfg, 1, device="meta")
        fields = [cache.k, cache.v]
    return sum(t.numel() * t.element_size() for t in fields if t is not None)


def plan_batch(cfg: ModelConfig, mode: str, prompt_len: int, gen_len: int,
               sparse_budget: int, weight_quant: str = "none",
               card_bytes: float = CARD_BYTES) -> int:
    """The largest batch whose caches fit on the card beside the weights
    and the headroom (at least 1)."""
    cc = CacheConfig(mode=mode, max_length=prompt_len + gen_len + EXTRA_LEN,
                     sparse_budget=sparse_budget)
    free = card_bytes - weight_bytes(cfg, weight_quant) - HEADROOM_BYTES
    return max(1, int(free // cache_bytes_per_seq(cfg, cc, prompt_len)))


def measure(
    model_name: str,
    baseline_rows,
    shadow_rows,
    sparse_budget: int,
    gen_len: int = 100,
    temperature: float = 0.6,
    rank: int = 160,
    model_dir: Optional[str] = None,
    weight_quant: str = "none",
    device="cuda",
    datalen: Optional[str] = None,
    seed: int = 0,
    runs: Optional[dict] = None,
    dp: int = 1,
    tp: int = 1,
    sp: int = 1,
    pp: int = 1,
) -> dict:
    """The full-attention baseline on ``baseline_rows`` [Bb, S], then
    ShadowKV on ``shadow_rows`` [Bs, S] (chunk 8, the XLA-gather branch:
    ``LLM``'s defaults), each through ``LLM.batch_generate`` and freed
    before the next. Returns JAX e2e's JSON object; ``runs``, when given,
    receives each run's ``LLM.stats``, tokens and configs under
    'baseline' and 'shadowkv'. ``dp/tp/sp/pp`` run this process as one
    rank of the model's mesh (the process group initialised by the
    caller, as ``main`` does under ``torchrun``); the baseline serves dp
    and tp only, so sp and pp raise."""
    from shadowkv_tpu_torch.models.llm import LLM

    rates = {}
    for key, mode, label, rows in (
        ("baseline", "full", "Baseline", baseline_rows),
        ("shadowkv", "shadow", "ShadowKV", shadow_rows),
    ):
        rows = np.asarray(rows)
        llm = LLM(model_name=model_name, batch_size=rows.shape[0],
                  max_length=rows.shape[1] + gen_len + EXTRA_LEN,
                  attn_mode=mode, sparse_budget=sparse_budget, rank=rank,
                  model_dir=model_dir, weight_quant=weight_quant,
                  device=device, **_axes(mode, dp, tp, sp, pp))
        out, rates[key] = llm.batch_generate(
            rows, gen_len=gen_len, temperature=temperature, benchmark=True,
            seed=seed)
        print(f"[{label}] Throughput: {rates[key]:.2f} tokens/s",
              file=sys.stderr)
        if runs is not None:
            runs[key] = dict(out=out, stats=llm.stats, model=llm.config,
                             cache=llm.cache_cfg, rt=llm.engine.rt)
        del llm
        gc.collect()
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
    tb, ts = rates["baseline"], rates["shadowkv"]
    print(f"Speedup: {ts / tb:.2f}x", file=sys.stderr)
    return {
        "datalen": datalen,
        "baseline_tokens_per_sec": round(tb, 2),
        "shadowkv_tokens_per_sec": round(ts, 2),
        "speedup": round(ts / tb, 3),
    }


def _axes(mode: str, dp: int, tp: int, sp: int, pp: int) -> dict:
    """The LLM's mesh arguments of a run. The full-attention baseline
    serves dp and tp only (JAX's rules), so e2e, which runs it, does too."""
    if mode == "full" and (sp > 1 or pp > 1):
        raise ValueError("the full-attention baseline serves dp and tp only; "
                         "measure sp and pp with the shadow run alone")
    return dict(dp=dp, tp=tp, sp=sp, pp=pp)


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--model_name", type=str,
                   default="meta-llama/Meta-Llama-3.1-8B-Instruct")
    p.add_argument("--datalen", type=str, default="122k",
                   choices=sorted(CONFIGS))
    p.add_argument("--model_dir", type=str, default=None)
    p.add_argument("--baseline_bsz", type=int, default=None)
    p.add_argument("--shadowkv_bsz", type=int, default=None)
    p.add_argument("--gen_len", type=int, default=100)
    p.add_argument("--weight_quant", type=str, default="none",
                   choices=["none", "int8"])
    p.add_argument("--device", type=str, default="cuda")
    # one process per rank (torchrun --nproc-per-node dp*tp*sp*pp)
    p.add_argument("--dp", type=int, default=1)
    p.add_argument("--tp", type=int, default=1)
    p.add_argument("--sp", type=int, default=1)
    p.add_argument("--pp", type=int, default=1)
    return p.parse_args(argv)


def main(argv=None):
    from shadowkv_tpu_torch.data.dataset import Dataset
    from shadowkv_tpu_torch.models.llm import load_tokenizer, model_config

    args = parse_args(argv)
    cfg = CONFIGS[args.datalen]
    min_len = cfg["min_prompt_len"]
    model = model_config(args.model_name, args.model_dir)
    bsz = {}
    for key, mode, given in (("baseline", "full", args.baseline_bsz),
                             ("shadowkv", "shadow", args.shadowkv_bsz)):
        bsz[key] = given or plan_batch(model, mode, min_len, args.gen_len,
                                       cfg["sparse_budget"],
                                       args.weight_quant)
    tokenizer = load_tokenizer(args.model_dir, args.model_name)
    if tokenizer is None:
        raise SystemExit("e2e builds its prompts from ruler/qa_2 and needs "
                         "a tokenizer; without one, call measure() with "
                         "token rows")
    n = max(bsz.values())
    dataset = Dataset("ruler/qa_2", tokenizer, 256 * 1024, max(20, n))
    rows = [dataset.tokenized_prompts[i][:min_len] for i in range(n)]
    if not all(len(r) == min_len for r in rows):
        raise SystemExit("qa_2 prompts shorter than the target length")
    rows = np.stack(rows)
    from shadowkv_tpu_torch.eval.evaluator import close_dist, init_dist

    dist = init_dist()
    try:
        result = measure(
            args.model_name, rows[:bsz["baseline"]], rows[:bsz["shadowkv"]],
            cfg["sparse_budget"], gen_len=args.gen_len, temperature=0.6,
            model_dir=args.model_dir, weight_quant=args.weight_quant,
            device=args.device, datalen=args.datalen, dp=args.dp,
            tp=args.tp, sp=args.sp, pp=args.pp,
        )
    finally:
        close_dist(dist)
    if dist.master_process:
        print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
