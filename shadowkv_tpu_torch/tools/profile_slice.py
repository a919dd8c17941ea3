"""Where the time goes: profile the port's slice on one GPU.

Runs the same Llama-3.1-8B-shape slice as ``chip_smoke.py`` (synthetic
bf16 weights, shadow cache with budget 2048 / rank 160 / chunk 16 / int8
stores, or the full-attention baseline) with one of its decode paths:

- ``shadow``: V store on the card, fused refresh (kernel A);
- ``ring``: V store on the card, XLA-gather branch through kernel D;
- ``offload-fused`` / ``offload-ring``: the same two with the V store
  pinned in host memory (the kernels read it over the host link);
- ``full``: the full-attention baseline;
- ``stream``, ``vs``, ``vs-walk``: ``shadow`` with the sparse prefill
  (attention sink + window, kernel C; MInference vertical + slash through
  kernel F or the block walk, kernel G; the JAX defaults);

then traces with ``torch.profiler`` (CPU + CUDA activities):

- the whole prefill;
- ``--steps`` eager greedy decode steps (``Engine._decode``, every op
  issued from Python) after two untimed ones;
- ``--steps`` greedy decode steps through the compiled step
  (``Engine.decode_chunk``: replays of the captured CUDA graph, one host
  sync at the end) after two untimed ones (one eager step and the
  capture, one replay).

For each window it prints one JSON line: wall seconds (host clock around
work that ends in a synchronize), device-busy seconds (the union of the
CUDA kernels' intervals), the idle share, per decode step the wall and
device-busy milliseconds, and the kernels and operators that take the
most device time, with the device time of the port's own kernels (A, B,
C, D, F, G) summed apart. The full tables go to
``<out-dir>/profile_<mode>_<window>.txt``.

    python -m shadowkv_tpu_torch.tools.profile_slice --mode offload-fused
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from shadowkv_tpu_torch.config import CacheConfig, RuntimeConfig
from shadowkv_tpu_torch.core.sampling import sample_token
from shadowkv_tpu_torch.models.engine import Engine
from shadowkv_tpu_torch.models.params import init_synthetic_params
from shadowkv_tpu_torch.models.registry import llama31_8b


def _busy_seconds(prof) -> float:
    """Union of the device kernels' [start, end) intervals, in seconds."""
    spans = sorted(
        (e.time_range.start, e.time_range.end)
        for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CUDA
    )
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy * 1e-6  # profiler times are microseconds


def _top(prof, n: int = 12) -> list[dict]:
    rows = []
    for a in prof.key_averages():
        dev_us = getattr(a, "self_device_time_total", 0.0)
        if dev_us > 0:
            rows.append({"name": a.key[:80], "calls": a.count,
                         "device_ms": dev_us / 1e3})
    rows.sort(key=lambda r: -r["device_ms"])
    return rows[:n]


# mode -> (cache mode, decode runtime settings)
MODES = {
    "shadow": ("shadow", dict(use_pallas=True)),
    "ring": ("shadow", dict(ring_gather=True)),
    "offload-fused": ("shadow_offload", dict(use_pallas=True)),
    "offload-ring": ("shadow_offload", dict(ring_gather=True)),
    "full": ("full", dict()),
    "stream": ("shadow", dict(use_pallas=True, prefill_pattern="stream")),
    "vs": ("shadow", dict(use_pallas=True, prefill_pattern="vs")),
    "vs-walk": ("shadow", dict(use_pallas=True, prefill_pattern="vs",
                               vs_impl="walk")),
}
# the port's kernels, by fragments of their demangled or mangled names
# (B and C are one kernel: B in the dense prefill, C in the stream one)
KERNELS = {("RefreshArgs",): "A refresh", ("GatherArgs",): "D gather",
           ("prefill_attention_kernel",): "B/C prefill",
           ("vs_tile_kernel",): "F vs tile", ("vs_sparse_kernel",): "G vs walk"}


def _kernel_ms(prof) -> dict:
    """Device ms and calls of the port's kernels."""
    out = {}
    for a in prof.key_averages():
        for keys, label in KERNELS.items():
            if any(key in a.key for key in keys):
                ms, n = out.get(label, (0.0, 0))
                out[label] = (ms + getattr(a, "self_device_time_total", 0.0)
                              / 1e3, n + a.count)
    return {k: {"device_ms": ms, "calls": n} for k, (ms, n) in out.items()}


def _report(prof, wall: float, label: str, extra: dict, out_dir: Path,
            steps: int | None = None) -> None:
    busy = _busy_seconds(prof)
    if steps:
        extra = dict(extra, steps=steps, ms_per_step=wall / steps * 1e3,
                     device_busy_ms_per_step=busy / steps * 1e3)
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / f"profile_{label}.txt").write_text(
        prof.key_averages().table(sort_by="self_device_time_total",
                                  row_limit=60)
    )
    print(json.dumps({
        "window": label, "wall_s": wall, "device_busy_s": busy,
        "idle_share": 1.0 - busy / wall if wall > 0 else None,
        "kernels": _kernel_ms(prof), "top": _top(prof), **extra,
    }), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mode", choices=tuple(MODES), default="shadow")
    ap.add_argument("--prompt", type=int, default=32768)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out-dir", type=Path, default=Path("profile_out"),
                    help="where the full profiler tables are written")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_slice needs a CUDA device")

    cfg = llama31_8b("meta-llama/Llama-3.1-8B-Instruct", dtype=torch.bfloat16)
    params = init_synthetic_params(
        cfg, torch.Generator(device="cuda").manual_seed(args.seed),
        device="cuda")
    mode, rt_kw = MODES[args.mode]
    cc = CacheConfig(mode=mode, max_length=args.prompt + 256,
                     sparse_budget=2048, rank=160, chunk_size=16,
                     kv_quant="int8", gen_capacity=256)
    rt = RuntimeConfig(**{"prefill_pattern": "dense-splash", **rt_kw})
    eng = Engine(cfg, cc, rt, params, device="cuda")
    ids = np.random.RandomState(args.seed).randint(
        1, cfg.vocab_size, (args.batch, args.prompt))
    meta = {"mode": args.mode, "prompt": args.prompt, "batch": args.batch,
            "device": torch.cuda.get_device_name(0)}

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        logits, cache = eng.prefill(ids)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    _report(prof, wall, f"{args.mode}_prefill", meta, args.out_dir)

    tokens = sample_token(logits[:, -1])
    for _ in range(2):  # untimed: first-call setup of every decode op
        tokens = sample_token(eng._decode(cache, tokens[:, None])[:, -1])
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            tokens = sample_token(eng._decode(cache, tokens[:, None])[:, -1])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    _report(prof, wall, f"{args.mode}_decode", meta, args.out_dir, args.steps)

    def unforced(k):
        z = torch.zeros(k, args.batch, dtype=torch.int32, device="cuda")
        return z, z.bool()

    tokens, _ = eng.decode_chunk(cache, tokens, *unforced(2))  # capture
    forced = unforced(args.steps)
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        tokens, _ = eng.decode_chunk(cache, tokens, *forced)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    _report(prof, wall, f"{args.mode}_decode_graph", meta, args.out_dir,
            args.steps)


if __name__ == "__main__":
    main()
