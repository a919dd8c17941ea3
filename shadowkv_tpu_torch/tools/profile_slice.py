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

- ``offload-host``: the V store in bf16 pinned in host memory and
  neither decode kernel (JAX's HostVStore path: ``gather_v_rows``);

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

Last, ``batch_generate`` of 128 greedy tokens from a new prefill
(the graph-replayed loop chip_smoke times) gives one JSON line with decode
tok/s, ``prefill_s``, the number of distinct tokens in each row's output
and, on the shadow paths, the organic slot hit rate that the engine
samples (``track_hit_rate``), which follows the decoded stream.

``--weights DIR`` runs the bench-shape 1.4B model (``sbench-1.4b-llama``,
``tools/train_bench_weights.py``) on ``DIR/params.npz`` (trained by that
tool, or synthetic from ``tools/gen_bench_npz.py``) with its prompt rows
from ``--prompt-ids`` (default ``DIR/prompt.npy``, the prompt stream the
weights were trained beside; random ids without one), as the JAX
``bench.py`` reads ``BENCH_WEIGHTS``. Where that bench repeats the
stream's first ``--prompt`` tokens in every row, here row r starts r
strides into the stream (the strides spread the rows' windows from its
start to its end), so the batch's rates come from ``--batch`` sequences.
``--generate-only`` skips the profiled windows (long prompts).

``--mode serve`` profiles one serve-plain run of ``chip_smoke.py`` instead
(``ContinuousBatcher``, 2 slots, 4 requests, gen lengths 32-64, decode
chunks of 16 replays, fused refresh; ``serve-offload`` the same with V
pinned on the host) and splits the serve loop's wall time
into admissions (``ServeStats.admission_seconds``), decode chunks (the
``decode_chunk`` calls, each ending in its host read) and the host
bookkeeping between them (the rest), with the device idle share inside
the decode chunks.

    python -m shadowkv_tpu_torch.tools.profile_slice --mode offload-fused
    python -m shadowkv_tpu_torch.tools.profile_slice --mode serve
    python -m shadowkv_tpu_torch.tools.profile_slice --mode shadow \
        --weights checkpoints/bench1p4b
"""

from __future__ import annotations

import argparse
import json
import os
import time
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from shadowkv_tpu_torch.config import CacheConfig, RuntimeConfig
from shadowkv_tpu_torch.core.sampling import sample_token
from shadowkv_tpu_torch.models.engine import Engine
from shadowkv_tpu_torch.models.params import (
    init_synthetic_params,
    load_params_npz,
)
from shadowkv_tpu_torch.models.registry import llama31_8b
from shadowkv_tpu_torch.utils.profiling import busy_seconds, top_kernels


# mode -> (cache mode, decode runtime settings)
MODES = {
    "shadow": ("shadow", dict(use_pallas=True)),
    "ring": ("shadow", dict(ring_gather=True)),
    "offload-fused": ("shadow_offload", dict(use_pallas=True)),
    "offload-ring": ("shadow_offload", dict(ring_gather=True)),
    "offload-host": ("shadow_offload", dict()),
    "full": ("full", dict()),
    "stream": ("shadow", dict(use_pallas=True, prefill_pattern="stream")),
    "vs": ("shadow", dict(use_pallas=True, prefill_pattern="vs")),
    "vs-walk": ("shadow", dict(use_pallas=True, prefill_pattern="vs",
                               vs_impl="walk")),
    "serve": ("shadow", dict(use_pallas=True, prefill_sub_batch=1)),
    "serve-offload": ("shadow_offload",
                      dict(use_pallas=True, prefill_sub_batch=1)),
}
# modes whose V store is bf16 (the HostVStore path takes no int8 store)
BF16_STORE = {"offload-host"}
SERVE_STEPS = 64  # the serve stream's longest gen length
GEN_STEPS = 128  # the closing batch_generate (a hit-rate pair per 16 steps)
SERVE_CHUNK = 16  # decode steps per host sync


def serve_requests(vocab: int, shared_ctx: bool, n: int, prompt_len: int,
                   steps: int, suffix: int, seed: int = 0):
    """``bench.py`` ``run_serve``'s stream from ``RandomState(seed)``: n
    random prompts with gen lengths staggered from steps // 2 to steps, or
    one shared context plus a random suffix per request, gen ``steps``."""
    from shadowkv_tpu_torch.serving import Request

    rng = np.random.RandomState(seed)
    if shared_ctx:
        prefix = rng.randint(1, vocab, prompt_len)
        ids = [np.concatenate([prefix, rng.randint(1, vocab, suffix)])
               for _ in range(n)]
        gen_lens = [steps] * n
    else:
        ids = list(rng.randint(1, vocab, (n, prompt_len)))
        gen_lens = [steps // 2 + i * (steps // 2) // max(1, n - 1)
                    for i in range(n)]
    return [Request(uid=i, input_ids=ids[i], gen_len=gen_lens[i],
                    context_id=0 if shared_ctx else None,
                    context_len=prompt_len if shared_ctx else None)
            for i in range(n)]


def profile_serve(eng, args, meta: dict) -> None:
    """One serve-plain run (V on the card or on the host) under the
    profiler: the serve loop's wall split into admissions, decode chunks
    and host bookkeeping, and the device time inside each decode chunk."""
    from shadowkv_tpu_torch.kernels import build
    from shadowkv_tpu_torch.serving import ContinuousBatcher

    build.library()  # the nvcc build, outside the profiled run
    reqs = serve_requests(eng.model.vocab_size, False, 2 * args.batch,
                          args.prompt, SERVE_STEPS, 0, args.seed)
    chunk_walls = []
    decode_chunk = eng.decode_chunk

    def timed_chunk(*a, **k):
        with record_function("serve_decode_chunk"):
            t0 = time.perf_counter()
            out = decode_chunk(*a, **k)  # ends in its tokens' host read
            chunk_walls.append(time.perf_counter() - t0)
        return out

    eng.decode_chunk = timed_chunk
    cb = ContinuousBatcher(eng, slots=args.batch, max_dispatch=SERVE_CHUNK)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, st = cb.run(reqs)
        torch.cuda.synchronize()
    windows = [(e.time_range.start, e.time_range.end) for e in prof.events()
               if e.name == "serve_decode_chunk"
               and e.device_type == torch.autograd.DeviceType.CPU]
    busy = busy_seconds(prof, windows)
    chunks = sum(chunk_walls)
    span = sum(b - a for a, b in windows) * 1e-6
    print(json.dumps({
        "window": args.mode, "wall_s": st.wall_seconds,
        "initial_prefill_s": st.prefill_seconds - st.admission_seconds,
        "admissions_s": st.admission_seconds, "decode_chunks_s": chunks,
        "bookkeeping_s": st.wall_seconds - st.admission_seconds - chunks,
        "bookkeeping_ms_per_chunk": (st.wall_seconds - st.admission_seconds
                                     - chunks) / max(1, st.chunks) * 1e3,
        "chunk_walls_s": chunk_walls,
        "chunk_busy_s": [busy_seconds(prof, [w]) for w in windows],
        "chunk_device_busy_s": busy,
        "chunk_idle_share": 1.0 - busy / span if span > 0 else None,
        "decode_steps": st.decode_steps, "chunks": st.chunks,
        "admissions": st.admissions, "completed_tokens": st.completed_tokens,
        "served_tok_s": st.tokens_per_second,
        "decode_tok_s": st.decode_tokens_per_second,
        "kernels": _kernel_ms(prof), **meta,
    }), flush=True)
    out_dir = args.out_dir
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / f"profile_{args.mode}.txt").write_text(
        prof.key_averages().table(sort_by="self_device_time_total",
                                  row_limit=60))


# the port's kernels, by fragments of their demangled or mangled names
# (B and C are one kernel: B in the dense prefill, C in the stream one)
KERNELS = {("RefreshArgs",): "A refresh", ("GatherArgs",): "D gather",
           ("VRowsArgs",): "gather_v_rows",
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
    busy = busy_seconds(prof)
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
        "kernels": _kernel_ms(prof), "top": top_kernels(prof), **extra,
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
    ap.add_argument("--weights", default=None,
                    help="a bench-shape params.npz directory (trained or "
                         "synthetic) in place of the 8B synthetic weights")
    ap.add_argument("--prompt-ids", default=None,
                    help="a token stream (.npy) whose --prompt-token "
                         "windows, spread from its start to its end, are "
                         "the rows (default: the weights directory's "
                         "prompt.npy)")
    ap.add_argument("--generate-only", action="store_true", default=False)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_slice needs a CUDA device")

    if args.weights:
        from shadowkv_tpu_torch.tools.train_bench_weights import (
            bench_model_config,
        )

        cfg = bench_model_config()
        params = load_params_npz(os.path.join(args.weights, "params.npz"),
                                 device="cuda")
    else:
        cfg = llama31_8b("meta-llama/Llama-3.1-8B-Instruct",
                         dtype=torch.bfloat16)
        params = init_synthetic_params(
            cfg, torch.Generator(device="cuda").manual_seed(args.seed),
            device="cuda")
    mode, rt_kw = MODES[args.mode]
    cc = CacheConfig(mode=mode, max_length=args.prompt + 256,
                     sparse_budget=2048, rank=160, chunk_size=16,
                     kv_quant="none" if args.mode in BF16_STORE else "int8",
                     gen_capacity=256)
    rt = RuntimeConfig(**{"prefill_pattern": "dense-splash",
                          "track_hit_rate": mode != "full", **rt_kw})
    eng = Engine(cfg, cc, rt, params, device="cuda")
    ppath = args.prompt_ids or (
        os.path.join(args.weights, "prompt.npy") if args.weights else None)
    if ppath and os.path.exists(ppath):
        stream = np.load(ppath)
        if stream.shape[0] < args.prompt:
            raise SystemExit(f"{ppath} holds {stream.shape[0]} tokens, "
                             f"fewer than --prompt {args.prompt}")
        stride = (stream.shape[0] - args.prompt) // max(args.batch - 1, 1)
        ids = np.stack([stream[r * stride:r * stride + args.prompt]
                        for r in range(args.batch)])
    else:
        ppath = None
        ids = np.random.RandomState(args.seed).randint(
            1, cfg.vocab_size, (args.batch, args.prompt))
    meta = {"mode": args.mode, "prompt": args.prompt, "batch": args.batch,
            "model": cfg.name, "weights": args.weights, "prompt_ids": ppath,
            "device": torch.cuda.get_device_name(0)}
    if args.mode.startswith("serve"):
        profile_serve(eng, args, meta)
        return
    if not args.generate_only:
        profile_windows(eng, ids, args, meta)
    toks, st = eng.batch_generate(ids, gen_len=GEN_STEPS, temperature=0.0)
    kv = eng.kv_stats()
    print(json.dumps({
        "window": f"{args.mode}_generate", "decode_tok_s":
        st.decode_tokens_per_second, "prefill_s": st.prefill_seconds,
        "gen": GEN_STEPS, "hit_rate_mean": kv.get("hit_rate_mean"),
        "hit_rate_ema": kv.get("hit_rate_ema"),
        "hit_samples": kv.get("hit_samples"),
        "distinct_tokens": [len(set(row.tolist())) for row in toks],
        "peak_gib": torch.cuda.max_memory_allocated() / 2**30, **meta,
    }), flush=True)


def profile_windows(eng, ids, args, meta: dict) -> None:
    """The profiled prefill, eager decode and graph decode windows."""
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
