#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of ShadowKV on one GPU and check its kernels.

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Phases (any failure ends the run with a non-zero exit; nothing falls back
to the CPU):

1. Device facts: the card's name, and its name and power limit from
   ``nvidia-smi``.
2. Build the CUDA kernels from ``shadowkv_tpu_torch/csrc`` (nvcc, sm_90a).
3. Host-link peak: a 1 GiB pinned-host -> device copy, the yardstick of
   the bounds of kernels that read host memory.
4. The SASS of the built kernels (``cuobjdump -sass``, registers and
   spills from ``nvcc.log``): kernel A must hold tensor-core (HMMA) and
   asynchronous-load (LDGSTS) instructions, B/C, F and G wgmma (HGMMA) and
   TMA loads (UTMALDG). Then kernel A (``sparse_refresh``) against its
   plain PyTorch version at the slice's per-layer shapes: int8 stores with
   a miss mix of all-hit heads, all-miss heads, contiguous runs and partial
   overlap; one bf16-store case, one glm partial-RoPE case and one no-RoPE
   case (K-EXAONE's NoPE layers: bf16, rank 160, chunk 8); timed with a
   cold L2 (each launch refreshes the next of 32 stacked layers, as a
   decode step does), the warm-L2 time of one layer beside it. Then A with
   the V store pinned in host memory (``shadow_offload``), held to the same
   tolerances and timed, with the store on the card beside it, at that mix
   and at 40 % missed slots (``tools/time_refresh.py``'s inputs).
5. Kernel B (causal GQA prefill attention) against its plain version at
   B 1 / S 4104 (ragged tile) and at the main path's shape, B 2 / S 32768,
   H 32 / KV 8, with a per-row tolerance that is shown to reject a skipped
   KV tile; timed at the main path's shape, with SDPA as a yardstick only.
   B's query-offset form is checked beside it (phase 17).
   B and C are one Hopper kernel, F and G two more on the same tile-plan
   loop (wgmma, TMA K/V ring): each timing line gives its TFLOP/s, its
   SASS evidence (phase 4) and the tile plan's visited and masked tiles
   beside the active pairs.
6. Kernel C (sink + sliding-window prefill attention) against its plain
   version at B 1 / S 4104 (window 1024, sink 64) and at the main path's
   shape, B 2 / S 32768 (window 8192, sink 1024), per-row tolerance as B;
   timed, with SDPA under the boolean [S, S] mask and the compiled
   ``flex_attention`` under a block mask of the same function as
   yardsticks (the faster one is the library time).
7. Kernel D (``gather_chunks``) against its plain version at the slice's
   per-layer shapes (int8 and bf16 stores), with V on the card and pinned
   in host memory (row E of the TPU kernels); bit-equal; timed, with two
   ``index_select`` calls as the yardstick.
8. Kernels F (vertical + slash tiles) and G (block walk) against their
   blockwise plain versions at B*H 64, S 32768, Dh 128 on two flag sets
   (estimation on random q/k at the JAX default sizes, and a clustered set:
   slashes decaying from the diagonal plus 512 hot verticals), and at a
   ragged S with duplicate and past-the-end verticals, where the per-row
   check must reject a planted skipped tile of each; timed on both sets,
   each bound counted from the active pairs of its flags, with the
   compiled ``flex_attention`` under a block mask built from the same
   flags as the library yardstick (held to the kernel's output first).
   Then the decode-attention kernel (``kernels/decode_attention.py``)
   against its plain version at the glm4 decode cell's buffer (B 8, 4 KV
   heads of G 8, 2624 rows of 128; [B] depths and a 0-d kv_len), per row
   as B, rejecting a skipped key tile; timed cycling 40 stacked layers
   (cold L2) against K and V read once, with SDPA as a yardstick only.
   The slice's runs below count its launches (once per layer and step,
   none on the segmented path). Then the selection kernel
   (``kernels/select.py``: landmark scores, top-S and the slot-stable
   assignment in one launch) at each decode cell's layer (C 4088, S 256,
   B 8: glm4's bf16 table at 4 KV heads, Yi's int8 one with row scales,
   K-EXAONE's bf16 one at 8 KV heads): its chosen sets equal the plain
   version's outside near-ties and its assignment is
   ``assign_slots_stable``'s for them bit for bit, a check shown to reject
   the S-th chunk swapped for the (S+1)-th; timed cycling stacked layers
   (cold L2) against the table read once, with the plain version beside
   it. The slice's runs count its launches (once per ShadowKV layer and
   step, none on the full cache), as does phase 19's slice.
9. A toy bf16 engine on the card against the same engine on the CPU
   (plain kernel versions) for the four decode strategies (fused refresh,
   XLA-gather, and both over an offloaded V store), the full baseline and
   the sparse prefills on the full cache (stream with a window below the
   prompt, vs tile, vs walk, a per-layer vs table): the logits of the
   prefill and of eight decode steps fed the CPU's greedy tokens (on the
   card through the compiled step: one eager step, its CUDA graph's
   capture, then replays; eager steps on the CPU), the greedy tokens
   wherever the CPU's choice is not a near-tie, and the final cached chunk
   ids.
10. head_dim 96 (Phi-3): B, C, F and G against their plain versions at S
   4096 through the wrappers that zero-pad to the kernels' 128 lanes, per
   row as above; then a toy bf16 engine with head_dim 96 on the card
   against the CPU as in 9: dense prefill, then the XLA-gather decode
   branch (kernel A serves head_dim 128 only) or the full cache.
11. The slice end to end: Llama-3.1-8B shape (32 layers, full width) with
   synthetic bf16 weights, shadow cache (budget 2048, rank 160, chunk 16,
   int8 stores), prefill through kernel B, greedy ``batch_generate``;
   eight runs: shadow with the fused refresh (kernel A), shadow with the
   ring gather (kernel D), shadow_offload with each of the two (A and D
   reading V from pinned host memory), the full-attention baseline, and
   shadow with the fused refresh after each sparse prefill: stream (kernel
   C), vs tile (F) and vs walk (G), at the JAX default settings.
   Every decode step after each run's first replays the captured step
   (one CUDA graph per path). Kernel launch counts are reset just before
   each run and asserted just after, counted through the replays (A or D
   once per layer and decode step; C, F or G once per layer and prefill
   sub-batch, B none in those runs); each offload run's tokens and final
   cached ids equal its HBM twin's, its device cache is at least 1.9 GiB
   smaller and its host store is the int8 V store's 1.99 GiB. After each
   run, from the state it left: eight eager steps (``_decode``, the loop
   before the compiled step) on a copy of the cache give the eager tok/s
   beside the graph's, and eight steps through the graph on the cache
   (``decode_chunk``) must give the same tokens and cached ids and count
   one kernel launch per layer and step; on the shadow run eight steps
   at temperature 0.6 through the graph must not repeat one token.
   Then the last single-device settings: ``gather_v_rows`` (the miss-only
   V gather of JAX's HostVStore path) against its plain version with a forced
   stay mask that skips about half of the slots, bit-equal on the missed
   ones, timed over 8 layers against the missed bytes over the measured
   link rate; and six more runs as above: offload-host
   (``shadow_offload`` with a 3.98 GiB bf16 V store pinned on the host and
   neither decode kernel, so ``gather_v_rows`` once per layer and step),
   whose tokens and cached ids must equal those of shadow-bf16-gather (the
   same engine with V on the card); offload-seg4 (the layer-segmented
   offload prefill, 4 segments, ring gather), whose tokens must equal
   those of offload-ring run again just before it, with prefill_s and
   peak GiB beside it (the port's
   prefill already writes each layer's V into the pinned store, so the
   setting runs the ordinary prefill over the whole batch and refuses
   admissions); ring-segmented (segmented decode attention on the ring
   path), ms per step beside shadow-ring's, whose per-segment sums round
   otherwise, so from one prefilled state the two attentions agree in f32
   on layer 0's buffers, and at every layer of eight teacher-forced
   segmented steps on the segments the engine hands over, within 1e-5 of
   the largest output; the steps' logits agree within 5 % of the largest
   (the toy engine's decode bound) with those of stacked steps through the
   plain decode attention, and give the same greedy token
   wherever the top two are more than twice the difference apart; the
   logit bound's noise floor (one ulp on layer 0's attention output of
   the stacked path) is printed beside it, and two planted faults of the
   segments (the gen mask a row short, the sparse segment dropped) must
   fail both bounds; vs-sim (``vs_sim="clustered"``
   on the vs-tile run) beside vs-tile, with the mean diagonal blocks per
   head and F's ms on one layer's simulated and estimated flags.
12. The crossover of the two shadow decode branches at full width, chunk
   sizes 16 and 8: ms per step of the fused refresh and of the XLA-gather
   branch at forced slot hit rates 0, 0.25, 0.5, 0.75 and 0.9
   (``debug_hit_rate``, one prefill per chunk size, a new graph per rate),
   and the hit rate from which the fused refresh is faster (the default
   of ``pallas_hit_threshold``, ``config.H100_HIT_THRESHOLD``).
13. ``use_pallas="auto"`` on the shadow path at full width: both paths
   captured in the warmup; its switches and the steps on each path.
14. Continuous batching (``serving.py``) on the CPU tests' toy shape (head
   dim 128, 2 layers, bf16 for kernels A and B): a 5-request stream at
   decode chunk 3 and a shared-prefix stream, each request's greedy tokens
   equal to its oracle run on the card.
15. Continuous batching at full width, 2 slots, 4 requests of 32768 tokens
   (fused refresh, dense prefill one sequence at a time): serve-plain (gen
   lengths 32, 42, 53, 64, as ``bench.py`` ``run_serve`` staggers them),
   serve-ctx (one shared context plus a 16-token suffix each, gen 32, the
   snapshot path) and serve-offload (serve-plain with V pinned on the
   host). Each: the static baseline (fixed batches of 2 through
   ``batch_generate``), the serve run with every kernel count set to 0
   just before it and read just after (B once per layer and
   one-sequence prefill, A, and A with host V, once per layer and decode
   step through the replays; every ``ServeStats`` counter; one captured
   decode graph across all admissions), and oracle runs with the serve
   run's shapes (requests 0 and 2 of serve-plain, 2 of serve-ctx) whose
   greedy tokens must equal the served ones. Served, decode-only and
   static tok/s and their ratio are printed.
16. The entry points at full width (the slice's params freed first; each
   ``LLM`` makes its own weights and is freed before the next; no local
   tokenizer, so token ids in and out):
   - ``entry/e2e.py::measure`` through ``LLM`` on synthetic weights: the
     full baseline, then shadow (chunk 8, budget 2048, the XLA-gather
     branch), batch 2 each, 32768-token seeded rows, 64 tokens at
     temperature 0.6; B launched once per layer per prefill and nothing
     else; baseline and shadow tok/s, the speedup and ``prefill_s``; an
     ``Engine`` built from the same seed's params and the shadow LLM's
     configs gives the LLM's tokens;
   - ``LLM(weight_quant="int8")`` with the headline cache (int8 stores,
     chunk 16, fused refresh): A and B launches exact, decode tok/s and
     peak GiB beside the bf16-weight shadow slice run, last-token prefill
     logits of a 4096-token prompt within 30 % relative RMS of the
     bf16-weight ones (``INT8_LOGIT_RMS_BOUND``);
   - context checkpoints at 32768 x 2 with that LLM: prefill, one step,
     ``save_context``, 32 tokens continued (the uninterrupted run); a
     fresh LLM and a ``shadow_offload`` LLM (V loaded straight into the
     pinned host store, A reading it) each ``load_context`` and continue
     to the same tokens, with A's launches exact; file size, save and
     load seconds beside ``prefill_s``;
   - HF loading: a 2-layer full-width Llama-3.1 checkpoint written here
     (``config.json``, two bf16 safetensors shards in HF's [out, in]
     layout, an index) and loaded by ``LLM(model_dir=...)`` through the
     port's safetensors reader, bf16 and int8: the config equals the
     registry's at 2 layers, the params are bit-equal to the written
     arrays, the prefill logits equal an ``Engine``'s over those arrays,
     and the int8 load equals ``quantize_params`` of the bf16 one; load
     seconds and GB/s.
17. Parallelism (``shadowkv_tpu_torch/parallel/``). Kernel B's query-offset
   form (the sequence-parallel prefill's attention) against its plain
   version at S_q 16384 rows at key offset 16384 of T_k 32768, B 2, per
   row as B (the bound rejects the rows attended 128 keys early); timed,
   with SDPA under the explicit offset mask as the library yardstick
   (run beside kernel B's check). Kernel A at the tp=2 shard's shapes (4
   KV heads). ``tp1-nccl``: a 1-rank NCCL group through the
   tensor-parallel code path (all-reduces and the logits' all-gather on
   the group) at full width and depth, prompt 8192 x 2, 32 greedy tokens,
   fused refresh, the decode step captured as one CUDA graph with the
   collectives inside: tokens equal to the single-device engine's, A and
   B counted, tok/s beside the single device's. Then 2-rank gloo
   phases, run by one pair of processes of this script
   (``--parallel-rank``) sharing the card with eager decode, prompt 4096 x 2, 32 greedy tokens: tp2 (16
   layers, fused refresh: A and B on 16 heads / 4 KV heads per rank), dp2
   (8 layers, ring gather: D and B on one row each), sp2 (8 layers:
   B's offset form on 2048 query rows each), pp2 (16 layers, 8 per
   stage, two microbatches), with V on the host dp2 ring (E), tp2 fused
   (A-host) and tp2 HostVStore (``gather_v_rows``), and on a rank's 16
   query heads the sparse prefills C (window 1024, sink 64), F and G
   (``vs_sim="clustered"``, 128 verticals and 768 slashes: each rank's
   draws bit-equal to its head slice of the single device's), 8 layers
   each. Each against the single-device engine at the same config: layer
   0 in f32 on each rank's shard, with the phase's prefill attention,
   within 1e-5 of the single device's (a planted fault: the all-reduce
   left out, the rows 64 keys off, another shard's rows, must fail it),
   teacher-forced logits within 0.3 of the largest (one rank's o_proj and
   MLP zeroed must fail it) and, under tp, within 1.5 x the half-sums
   floor of the rank-shapes control (every GEMM at a rank's shapes), the
   launches of every rank's kernels exact, the greedy tokens with their
   first divergence step. Context checkpoints on tp2 (8 layers, fused, V
   on the card and on the host): the tp2 resume equal to the unbroken tp2
   run, a single-device file resumed on tp2 and the tp2 file resumed on
   one device within 1.5 x the half-sums floor of the single device (the
   file with its tp halves swapped must fail it), with V on the host the
   loaded store pinned and never on the card; save and load seconds, the
   file's GiB. Shared-prefix snapshots over dp2 (8 layers, 2 slots a
   shard): two restores cross the shards, one each way, and every
   request's tokens equal the single-device batcher's at a rank's batch
   shape; ms per restore across and within a shard. Before the phases
   C, F and G are held to their plain versions at the tp=2 head slice of
   that prefill and timed against their bounds. Two ranks share one card:
   their tok/s claims no scaling.
18. Training (``tools/make_tiny_checkpoint.py``, ``train_tiny_model.py``,
   ``train_bench_weights.py``), after the entry points:
   - ``train-tiny``: the trained BPE tokenizer and the initial 6 x 1024
     oracle written to the gitignored build directory; step 0 of the
     trainer on the card against the CPU at a 2-layer narrow f32 config
     (loss within 1e-5 relative, each leaf's gradient within 1e-4 relative
     RMS; the same step with TF32 products, a planted control, must miss
     the gradient bound); then the first 200 steps of the
     tool's curriculum at its defaults (dense recall, ctx 256, batch 32,
     AdamW) on the full-width oracle: every loss finite, the mean of the
     last 20 at least 1 nat below the first 20's; steps/s, peak GiB and
     the dense-recall probe;
   - ``train-bench``: three Adafactor steps of the bench-shape model (16
     layers, d 2048, bf16) at ctx 2048 x 2; ms per step and peak GiB,
     every loss finite;
   - ``text``: the train-tiny checkpoint with its tokenizer through
     ``LLM(model_dir=...)`` (bf16), one RULER niah_single_1 sample at 4096
     with the port's template and eval_acc's prompt bucket, greedy, shadow
     at budget 512, rank 64, chunk 8 with the fused refresh, and full: B
     once per layer and A once per layer and decode step (exact), the
     decoded strings and their score, and the organic slot hit rate of 64
     further greedy steps.

19. K-EXAONE (``k-exaone``, the hybrid model of the benchmark's
   ``k-exaone.decode-32k-b8`` cell), after the decode-attention check: kernel
   C at a sliding layer's prefill (B 1, S 32768, 64 / 8 heads, window 128,
   sink 0) and the decode-attention kernel over a sliding layer's 128-row
   ring (kv_len = min(pos + 1, 128) per row) and over the global layers'
   compact buffer (B 8, 8 KV heads of G 8, 2624 rows), each against its
   plain version per row as B, each check shown to reject a planted fault
   (a window of 129, one key fewer, the last key tile skipped). Then an
   engine slice at full width, 8 layers (layer 0 dense, LLLG twice; 7 MoE
   layers holding experts 0-7 of 128), the cell's cache at 32768 x 8:
   ``Engine.prefill`` with every kernel count set to 0 just before it (B
   once per global layer and row, C once per sliding layer and row), then
   eight replayed ``decode_step`` calls with the counts set to 0 again (A
   once per global layer and step, decode attention once per layer and
   step); kernel A's no-RoPE case runs in phase 4.

``python3 chip_smoke.py --k-exaone`` runs phases 1, 2, kernel A's cases of
phase 4 and phase 19 alone; ``python3 chip_smoke.py --select`` runs phases
1, 2, the SASS of phase 4 and phase 8's selection kernel alone.

The line before the card line is a JSON object with every kernel's
numbers; the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
BF16_OPS_PER_S = 989e12  # H100 SXM dense bf16 tensor-core rate

PROMPT_LEN = 32768
BATCH = 2
GEN_LEN = 64
WARMUP_STEPS = 2
SEED = 0
DEVICE = "cuda"  # every phase runs on the card


def log(*args) -> None:
    print(*args, flush=True)


def time_ms(torch, fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``reps`` runs (CUDA events)."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_facts(torch) -> dict:
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {name} count {torch.cuda.device_count()}")
    return {"name": name, "smi": smi}


def bound(nbytes_dev: float, ops: float, nbytes_host: float = 0.0,
          link_bytes_per_s: float = 1.0) -> tuple[float, str]:
    """(least ms, what bounds it): device bytes over the HBM rate, host
    bytes over the measured link rate, operations over the bf16 peak."""
    t_bytes = max(nbytes_dev / HBM_BYTES_PER_S,
                  nbytes_host / link_bytes_per_s) * 1e3
    t_ops = ops / BF16_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def pinned_copy(torch, t):
    """A pinned host copy of the CUDA tensor ``t``."""
    h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    h.copy_(t)
    return h


def host_link_peak(torch) -> float:
    """Bytes/s of a 1 GiB pinned-host -> device copy."""
    n = 2**30
    h = torch.empty(n, dtype=torch.uint8, pin_memory=True)
    d = torch.empty(n, dtype=torch.uint8, device=DEVICE)
    ms = time_ms(torch, lambda: d.copy_(h, non_blocking=True), reps=5)
    rate = n / (ms * 1e-3)
    log(f"[host link] 1 GiB pinned->device copy {ms:.3f} ms = "
        f"{rate / 1e9:.2f} GB/s")
    del h, d
    return rate


# ---------------------------------------------------------------------------
# Kernel A: sparse refresh
# ---------------------------------------------------------------------------


def check_refresh(torch, cfg, lay, layer: int = 31) -> dict:
    from shadowkv_tpu_torch.core.rope import inv_freq_full_neox
    from shadowkv_tpu_torch.kernels.reconstruct import (
        sparse_refresh, sparse_refresh_plain,
    )
    from shadowkv_tpu_torch.tools.time_refresh import (
        cycle_layers, device_ms, refresh_bytes_ops, refresh_inputs,
    )

    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    invf = inv_freq_full_neox(cfg).to(DEVICE)
    entry = None
    cases = [
        ("int8", cfg, True),
        ("bf16", cfg, False),
        ("glm-int8", None, True),
        ("nope-bf16", cfg, False),
    ]
    for label, case_cfg, quant in cases:
        rope_style, rope_dim, inv = "neox", cfg.head_dim, invf
        c_lay = lay
        if label.startswith("nope"):
            # no RoPE: a NoPE layer's keys (K-EXAONE's global layers), at
            # 8 KV heads, rank 160 and chunk 8, as that model's cell runs
            from shadowkv_tpu_torch.cache.shadow import ShadowLayout
            from shadowkv_tpu_torch.config import CacheConfig

            rope_style = "none"
            c_lay = ShadowLayout.build(CacheConfig(
                sparse_budget=2048, rank=160, chunk_size=8, local_chunks=4,
                outlier_chunks=48, gen_capacity=128), lay.prefill_len)
        if case_cfg is None:  # GLM-4 style: interleaved RoPE on 64 lanes
            from shadowkv_tpu_torch.models.registry import glm4_9b

            glm = glm4_9b("glm-4-9b-chat-1m")
            rope_style, rope_dim = glm.rope_style, glm.rope_dim
            inv = inv_freq_full_neox(glm).to(DEVICE)
        layers = cfg.num_layers if label == "int8" else 2
        lyr = layer if label == "int8" else 1
        t = refresh_inputs(cfg, c_lay, BATCH, layers, quant, gen)
        kw = dict(chunk_size=c_lay.chunk_size,
                  sparse_start=c_lay.sparse_start, rope_dim=rope_dim,
                  rope_style=rope_style, u_scale=t["u_scale"],
                  v_scale=t["v_scale"])
        args = (t["mc"], t["ms"], t["cnt"], t["u"], t["sv"], t["v_full"], inv)
        k_ref, v_ref = t["k_buf"].clone(), t["v_buf"].clone()
        sparse_refresh_plain(lyr, *args, k_ref, v_ref, **kw)
        k_out, v_out = t["k_buf"].clone(), t["v_buf"].clone()
        sparse_refresh(lyr, *args, k_out, v_out, **kw)
        torch.cuda.synchronize()
        k_err = float((k_out.float() - k_ref.float()).abs().max())
        v_err = float((v_out.float() - v_ref.float()).abs().max())
        # K: f32 sums in another order, then one bf16 rounding -> up to 2
        # bf16 ulps of the largest K value. V: the same exact product
        # rounded once to bf16 on both sides -> bit-equal.
        k_tol = 2.0**-7 * float(k_ref.float().abs().max())
        log(f"[refresh {label}] misses {int(t['cnt'].sum())} of "
            f"{t['cnt'].numel() * c_lay.select_sets} slots; max_abs_err K "
            f"{k_err:.3e} (tol {k_tol:.3e}) V {v_err:.3e} (tol 0)")
        if not (k_err <= k_tol and v_err == 0.0):
            raise AssertionError(f"refresh {label}: kernel disagrees with "
                                 "its plain version")
        if label == "int8":
            nbytes, ops, misses = refresh_bytes_ops(t, lay, cfg.head_dim)
            k_buf, v_buf = t["k_buf"], t["v_buf"]
            # Cold L2, as in a decode step (the bound counts device-memory
            # bytes): each launch refreshes the next of the 32 layers.
            ms = device_ms(cycle_layers(lambda lyr_: sparse_refresh(
                lyr_, *args, k_buf, v_buf, **kw), layers), reps=64)
            warm_ms = device_ms(lambda: sparse_refresh(
                lyr, *args, k_buf, v_buf, **kw), reps=50)
            plain_ms = device_ms(lambda: sparse_refresh_plain(
                lyr, *args, k_buf, v_buf, **kw), reps=5)
            bound_b = nbytes / HBM_BYTES_PER_S * 1e3
            bound_o = ops / BF16_OPS_PER_S * 1e3
            entry = dict(
                name="sparse_refresh", route="cuda",
                source="shadowkv_tpu_torch/csrc/refresh.cu",
                replaces="shadowkv_tpu/kernels/reconstruct.py:86",
                launches=0, max_abs_err=k_err, ms=ms, plain_ms=plain_ms,
                bound_ms=max(bound_b, bound_o),
                bound_by="bytes" if bound_b >= bound_o else "operations",
                library_ms=None,
            )
            log(f"[refresh int8] kernel_ms {ms:.4f} (device time, cold L2, "
                f"cycling over {layers} layers; one layer over and over, warm "
                f"L2: {warm_ms:.4f}) plain_ms {plain_ms:.4f} "
                f"bound_ms {entry['bound_ms']:.4f} ({entry['bound_by']}: "
                f"{nbytes} B, {ops} operations, {misses} missed chunks)")
        del t, k_ref, v_ref, k_out, v_out
        torch.cuda.empty_cache()
    return entry


def check_refresh_host(torch, cfg, lay, link: float, layer: int = 31,
                       layers: int = 64) -> dict:
    """Kernel A with the V store pinned in host memory: the int8 inputs and
    miss mix of ``check_refresh``, held to A's tolerances against the plain version (which
    reads the same bytes from a device copy); timed at that mix and at
    40 % missed slots, cycling over ``layers`` stacked layers (64: one pass
    reads 168 MB of V rows over the link at the mixed-heads mix, 3.4x the
    L2, so no launch finds its V rows there). The device store is timed the
    same way beside it."""
    from shadowkv_tpu_torch.core.rope import inv_freq_full_neox
    from shadowkv_tpu_torch.kernels.reconstruct import (
        sparse_refresh, sparse_refresh_plain,
    )
    from shadowkv_tpu_torch.tools.time_refresh import (
        device_ms, miss_fraction_lists, refresh_bytes_ops, refresh_inputs,
        time_mixes,
    )

    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 3)
    inv = inv_freq_full_neox(cfg).to(DEVICE)
    t = refresh_inputs(cfg, lay, BATCH, layers, True, gen)
    v_host = pinned_copy(torch, t["v_full"])
    kw = dict(chunk_size=lay.chunk_size, sparse_start=lay.sparse_start,
              rope_dim=cfg.head_dim, rope_style="neox",
              u_scale=t["u_scale"], v_scale=t["v_scale"])
    k_ref, v_ref = t["k_buf"].clone(), t["v_buf"].clone()
    sparse_refresh_plain(layer, t["mc"], t["ms"], t["cnt"], t["u"], t["sv"],
                         t["v_full"], inv, k_ref, v_ref, **kw)
    k_out, v_out = t["k_buf"].clone(), t["v_buf"].clone()
    sparse_refresh(layer, t["mc"], t["ms"], t["cnt"], t["u"], t["sv"],
                   v_host, inv, k_out, v_out, **kw)
    torch.cuda.synchronize()
    k_err = float((k_out.float() - k_ref.float()).abs().max())
    v_err = float((v_out.float() - v_ref.float()).abs().max())
    k_tol = 2.0**-7 * float(k_ref.float().abs().max())
    log(f"[refresh host-V] max_abs_err K {k_err:.3e} (tol {k_tol:.3e}) "
        f"V {v_err:.3e} (tol 0)")
    if not (k_err <= k_tol and v_err == 0.0):
        raise AssertionError("refresh host-V: kernel disagrees with its "
                             "plain version")
    del k_ref, v_ref, k_out, v_out
    kh, dh, cs = cfg.num_kv_heads, cfg.head_dim, lay.chunk_size
    entry = None
    mixes = {"mixed heads": (t["mc"], t["ms"], t["cnt"]),
             "40% missed": miss_fraction_lists(lay, BATCH, kh, 0.4, gen)}
    times = time_mixes(cfg, lay, t, v_host, inv, mixes)
    for label, (mc, ms_, cnt) in mixes.items():
        tt = dict(t, mc=mc, ms=ms_, cnt=cnt)
        nbytes, ops, misses = refresh_bytes_ops(tt, lay, dh)
        host_b = misses * cs * dh  # int8 V rows over the host link
        plain_ms = device_ms(lambda: sparse_refresh_plain(
            layer, mc, ms_, cnt, t["u"], t["sv"], t["v_full"], inv,
            t["k_buf"], t["v_buf"], **kw), reps=3)
        b_ms, b_by = bound(nbytes - host_b, ops, host_b, link)
        dev_b_ms, _ = bound(nbytes, ops)
        log(f"[refresh host-V, {label}] {misses} of "
            f"{cnt.numel() * lay.select_sets} slots missed; kernel_ms host V "
            f"{times[label]['host']:.4f} (bound {b_ms:.4f}, {b_by}: {host_b} B "
            f"over the link at {link / 1e9:.2f} GB/s, {nbytes - host_b} B in "
            f"device memory), device V {times[label]['device']:.4f} (bound "
            f"{dev_b_ms:.4f}); both cold L2, cycling over {layers} "
            f"layers; plain_ms {plain_ms:.4f}")
        if entry is None:
            entry = dict(
                name="sparse_refresh_host_v", route="cuda",
                source="shadowkv_tpu_torch/csrc/refresh.cu",
                replaces="shadowkv_tpu/kernels/reconstruct.py:86",
                launches=0, max_abs_err=k_err, ms=times[label]["host"],
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=None,
            )
    del t, v_host
    torch.cuda.empty_cache()
    return entry


# ---------------------------------------------------------------------------
# Kernel D: chunk gather (V on the card, and V pinned in host memory: row E)
# ---------------------------------------------------------------------------


def check_gather(torch, cfg, lay, link: float, layers: int = 32,
                 batch: int = BATCH, timed: bool = True):
    """Kernel D against its plain version at the slice's per-layer shapes
    (B 2, 8 KV heads, 128 of 2040 chunks of 16 rows, rank 160) on int8
    stores, with V on the card and pinned in host memory, and on bf16
    stores; bit-equal. Timed on the int8 stores cycling over ``layers``
    stacked layers (32: one pass gathers 300 MB of rows, 6x the L2, so no
    launch finds its rows there), with two ``index_select`` calls that gather
    the same U and V rows as the yardstick of the device case. Returns
    (entry D, entry D with host V); ``timed=False`` only checks, at
    ``batch`` rows and ``cfg``'s KV heads (a rank's shard), and returns
    None."""
    from shadowkv_tpu_torch.core.quant import quantize_store
    from shadowkv_tpu_torch.kernels.gather import (
        gather_chunks, gather_chunks_plain,
    )
    from shadowkv_tpu_torch.tools.time_refresh import cycle_layers, device_ms

    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 4)
    kh, dh, cs, s = cfg.num_kv_heads, cfg.head_dim, lay.chunk_size, lay.select_sets
    n_rows, rank, c = lay.chunks * cs, lay.rank, lay.chunks
    entries = {}
    for quant in (True, False):
        n_l = layers if quant and timed else 2  # the others only check
        u = torch.randn(n_l, batch, n_rows, rank, device=DEVICE,
                        generator=gen, dtype=torch.bfloat16)
        v = torch.randn(n_l, batch, kh, n_rows, dh, device=DEVICE,
                        generator=gen, dtype=torch.bfloat16)
        u_sc = v_sc = None
        if quant:
            u, u_sc = quantize_store(u)
            v, v_sc = quantize_store(v)
        ids = torch.stack([torch.randperm(c, device=DEVICE, generator=gen)[:s]
                           for _ in range(batch * kh)]).reshape(
                               batch, kh, s).to(torch.int32)
        v_host = pinned_copy(torch, v)
        layer = n_l - 1
        ref = gather_chunks_plain(layer, ids, u, v, u_sc, v_sc, chunk_size=cs)
        for place, v_in in (("device", v), ("host", v_host)):
            out = gather_chunks(layer, ids, u, v_in, u_sc, v_sc, chunk_size=cs)
            torch.cuda.synchronize()
            same = all((o is None and r is None) or torch.equal(o, r)
                       for o, r in zip(out, ref))
            label = f"{'int8' if quant else 'bf16'}, V on {place}"
            log(f"[gather {label}] bit-equal to the plain version: {same}")
            if not same:
                raise AssertionError(f"gather {label}: kernel disagrees with "
                                     "its plain version")
        if not (quant and timed):
            del u, v, v_host, ref, out
            continue
        plain_ms = device_ms(cycle_layers(lambda lyr: gather_chunks_plain(
            lyr, ids, u, v, u_sc, v_sc, chunk_size=cs), layers), reps=16)
        # The yardstick: index_select of the same U rows and V rows (not
        # their scales) from the flattened stores.
        rows = (ids.long()[..., None] * cs + torch.arange(cs, device=DEVICE))
        rows = rows.reshape(batch, kh, s * cs)
        bi = torch.arange(batch, device=DEVICE)[:, None, None]
        ki = torch.arange(kh, device=DEVICE)[None, :, None]
        u_idx = (bi * n_rows + rows).reshape(-1)
        v_idx = ((bi * kh + ki) * n_rows + rows).reshape(-1)
        u_flat, v_flat = u.reshape(layers, -1, rank), v.reshape(layers, -1, dh)
        lib_ms = device_ms(cycle_layers(lambda lyr: (
            torch.index_select(u_flat[lyr], 0, u_idx),
            torch.index_select(v_flat[lyr], 0, v_idx)), layers), reps=64)
        n_tok = batch * kh * s * cs
        u_b, v_b, sc_b = n_tok * rank, n_tok * dh, n_tok * 2 * 2
        for place, v_in in (("device", v), ("host", v_host)):
            ms = device_ms(cycle_layers(lambda lyr: gather_chunks(
                lyr, ids, u, v_in, u_sc, v_sc, chunk_size=cs), layers), reps=64)
            if place == "device":  # every row read once and written once
                b_ms, b_by = bound(2 * (u_b + v_b + sc_b), 0)
            else:  # V rows cross the link; the rest moves in device memory
                b_ms, b_by = bound(2 * (u_b + sc_b) + v_b, 0, v_b, link)
            log(f"[gather int8, V on {place}] kernel_ms {ms:.4f} plain_ms "
                f"{plain_ms:.4f} index_select_ms {lib_ms:.4f} bound_ms "
                f"{b_ms:.4f} ({b_by}; {n_tok} rows of U {rank} B, V {dh} B, "
                f"2 scales; cycling over {layers} layers)")
            entries[place] = dict(
                name="gather_chunks" if place == "device"
                else "gather_chunks_host_v",
                route="cuda", source="shadowkv_tpu_torch/csrc/gather.cu",
                replaces="shadowkv_tpu/kernels/gather.py:81" if place == "device"
                else "shadowkv_tpu/kernels/gather.py:165",
                launches=0, max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by,
                library_ms=lib_ms if place == "device" else None,
            )
        del u, v, v_host, ref, out, u_flat, v_flat
        torch.cuda.empty_cache()
    if timed:
        return entries["device"], entries["host"]


# ---------------------------------------------------------------------------
# Kernel B: causal GQA prefill attention
# ---------------------------------------------------------------------------


# Per-row tolerance for attention outputs. With N(0,1) q/k/v the output of
# row i has a scale of about sqrt(e / i), so one tolerance from the largest
# value would hide faults in late rows. Each (b, s, h) row's largest error
# is taken relative to that row's largest |ref|: bf16 probabilities in P @ V
# (kernel: unnormalised, plain: normalised) and one bf16 rounding of the
# output give a few 2^-9; 2^-6 leaves room for that and no more.
ATTN_ROW_TOL = 2.0**-6


def row_rel_err(torch, out, ref) -> float:
    """max over rows of max|out - ref|_row / max(max|ref|_row, 1e-6)."""
    err = (out.float() - ref.float()).abs().amax(dim=-1)
    scale = ref.float().abs().amax(dim=-1).clamp_min(1e-6)
    return float((err / scale).max())


def _timed(torch, fn):
    """(result, device ms) of one call of ``fn``."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def _skip_tile_fault(torch, q, k, v, ref, rows, tile, mask=None,
                     kv_map=None):
    """``ref`` with rows ``rows`` recomputed by the plain attention without
    KV positions ``tile``: what a kernel that skips one KV tile would give.
    The per-row check must reject it. B's layout ([B, S, H, Dh], causal
    mask) by default; F's and G's ([B*H, S, Dh] with ``kv_map``) when
    ``mask`` [B*H, rows, S], the function's token mask of those rows, is
    given."""
    r0, r1 = rows
    pos_k = torch.arange(k.shape[1], device=q.device)
    keep = ~((pos_k >= tile[0]) & (pos_k < tile[1]))
    bad = ref.clone()
    if mask is None:
        from shadowkv_tpu_torch.core.attention import mha

        pos_q = torch.arange(r0, r1, device=q.device)
        causal = (pos_q[:, None] >= pos_k[None, :]) & keep[None, :]
        bad[:, r0:r1] = mha(q[:, r0:r1], k, v, mask=causal[None, None, None])
    else:
        from shadowkv_tpu_torch.core.minference import masked_attention

        kv = kv_map.long()
        bad[:, r0:r1] = masked_attention(
            q[:, r0:r1], k.float()[kv], v[kv], mask & keep,
            q.shape[-1] ** -0.5).to(ref.dtype)
    return bad


# The kernels whose SASS is read, by the names in their mangled symbols,
# with the tensor-core and asynchronous-load instructions each must hold:
# the Hopper attention kernels (wgmma, TMA), kernel A's main-path
# instance (int8 stores, 16-byte U rows: mma.sync, cp.async) and the
# decode-attention kernel's instance of the decode cells (head_dim 128, one
# n8 tile of query rows: mma.sync, cp.async).
SASS_KERNELS = {
    "B, C": ("prefill_attention_kernel", "HGMMA", "UTMALDG"),
    "F": ("vs_tile_kernel", "HGMMA", "UTMALDG"),
    "G": ("vs_sparse_kernel", "HGMMA", "UTMALDG"),
    "A": ("refresh_kernelILb1ELi16E", "HMMA", "LDGSTS"),
    "decode attention": ("decode_attention_kernelILi128ELi1E", "HMMA",
                         "LDGSTS"),
    "select": ("select_kernelILi128ELb0E", "HMMA", "LDGSTS"),
}


def kernel_evidence(so) -> dict:
    """What each built kernel of SASS_KERNELS is made of: its tensor-core
    and asynchronous-load instructions in ``cuobjdump -sass`` of the
    library, and its registers and spills from ``nvcc.log`` (``-Xptxas
    -v``). {label: text}. Fails when cuobjdump finds no tensor-core
    instruction or no asynchronous load in one of them."""
    from shadowkv_tpu_torch.kernels import build

    log_lines = (build.BUILD_DIR / "nvcc.log").read_text().splitlines()
    cuda = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    tool = shutil.which("cuobjdump", path=os.path.join(cuda, "bin")) \
        or shutil.which("cuobjdump")
    funcs = []
    if tool is not None:
        sass = subprocess.run([tool, "-sass", str(so)], capture_output=True,
                              text=True, check=True, timeout=300).stdout
        funcs = sass.split("Function : ")[1:]
    out = {}
    for label, (symbol, mma, load) in SASS_KERNELS.items():
        regs = spills = "not found"
        for i, line in enumerate(log_lines):
            if "Compiling entry function" in line and symbol in line:
                for nxt in log_lines[i + 1:i + 6]:
                    m = re.search(r"Used (\d+) registers", nxt)
                    regs = m.group(1) if m else regs
                    m = re.search(r"(\d+) bytes spill stores, (\d+) bytes "
                                  r"spill loads", nxt)
                    spills = f"{m.group(1)}/{m.group(2)} B" if m else spills
        ptxas = f"ptxas: {regs} registers, spill stores/loads {spills}"
        if tool is None:
            out[label] = ("SASS: cuobjdump absent, no instruction counts; "
                          + ptxas)
            continue
        counts = {mma: 0, load: 0}
        for func in funcs:
            if symbol in func.split("\n", 1)[0]:
                for op in counts:
                    counts[op] += len(re.findall(rf"\b{op}\b", func))
        if not (counts[mma] and counts[load]):
            raise AssertionError(f"{symbol}: SASS holds {counts}; expected "
                                 f"{mma} and {load}")
        out[label] = (f"SASS of {symbol}: {mma} {counts[mma]}, {load} "
                      f"{counts[load]}; {ptxas}")
    return out


def plan_counts(s: int, window=None, sink: int = 0) -> str:
    """Visited and masked 128-key tiles of one (batch row, head) under the
    kernel's tile plan, against the causal tiles."""
    from shadowkv_tpu_torch.kernels.prefill_attention import (
        prefill_tile_plan,
    )

    plans = prefill_tile_plan(s, window=window, sink=sink)
    visited = sum(len(p.full) + len(p.masked) for p in plans)
    masked = sum(len(p.masked) for p in plans)
    causal = len(plans) * (len(plans) + 1) // 2
    return (f"tile plan per (b, h): {visited} of {causal} causal tiles "
            f"visited, {masked} of them masked")


def check_prefill_attention(torch, cfg, evidence: str) -> dict:
    """Kernel B against its plain version at the ragged tile (B 1, S 4104)
    and at the shape the main path gives it (B 2, S 32768: one prefill
    sub-batch), timed at the latter."""
    import torch.nn.functional as F

    from shadowkv_tpu_torch.core.attention import causal_prefill_attention
    from shadowkv_tpu_torch.kernels.prefill_attention import (
        causal_prefill_splash,
    )

    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 1)
    h, kh, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    entry = None
    for b, s in ((1, 4104), (BATCH, PROMPT_LEN)):
        q = torch.randn(b, s, h, dh, device=DEVICE, generator=gen,
                        dtype=torch.bfloat16)
        k = torch.randn(b, s, kh, dh, device=DEVICE, generator=gen,
                        dtype=torch.bfloat16)
        v = torch.randn(b, s, kh, dh, device=DEVICE, generator=gen,
                        dtype=torch.bfloat16)
        ref, plain_ms = _timed(torch, lambda: causal_prefill_attention(q, k, v))
        out = causal_prefill_splash(q, k, v)
        torch.cuda.synchronize()
        err = float((out.float() - ref.float()).abs().max())
        rel = row_rel_err(torch, out, ref)
        log(f"[prefill-attn B={b} S={s}] max_abs_err {err:.3e}; per-row "
            f"relative {rel:.3e} (tol {ATTN_ROW_TOL:.3e})")
        if not rel <= ATTN_ROW_TOL:
            raise AssertionError(f"prefill attention B={b} S={s}: kernel "
                                 "disagrees with its plain version")
        if s == 4104:
            # The check itself must catch a late skipped tile, which a
            # tolerance from the largest output value lets through.
            bad = _skip_tile_fault(torch, q, k, v, ref, (3584, 4104),
                                   (2048, 2112))
            bad_rel = row_rel_err(torch, bad, ref)
            bad_abs = float((bad.float() - ref.float()).abs().max())
            log(f"[prefill-attn fault: KV tile 2048-2111 skipped for rows "
                f"3584-4103] per-row relative {bad_rel:.3e} (rejected: "
                f"{bad_rel > ATTN_ROW_TOL}); max_abs {bad_abs:.3e} vs the "
                f"old 2^-7*max|ref| tolerance "
                f"{2.0**-7 * float(ref.float().abs().max()):.3e}")
            if not bad_rel > ATTN_ROW_TOL:
                raise AssertionError("the per-row check misses a skipped tile")
            del bad
        else:
            ms = time_ms(torch, lambda: causal_prefill_splash(q, k, v),
                         reps=3, warmup=1)
            qh = q.transpose(1, 2)
            kr = k.transpose(1, 2).repeat_interleave(h // kh, dim=1)
            vr = v.transpose(1, 2).repeat_interleave(h // kh, dim=1)
            lib_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
                qh, kr, vr, is_causal=True), reps=3, warmup=1)
            del qh, kr, vr
            ops = 2 * 2 * dh * h * b * s * (s + 1) // 2  # QK and PV, causal
            nbytes = (2 * q.numel() + k.numel() + v.numel()) * 2
            bound_b = nbytes / HBM_BYTES_PER_S * 1e3
            bound_o = ops / BF16_OPS_PER_S * 1e3
            entry = dict(
                name="prefill_attention", route="cuda",
                source="shadowkv_tpu_torch/csrc/prefill_attention.cu",
                replaces="shadowkv_tpu/core/attention.py:223",
                launches=0, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=max(bound_b, bound_o),
                bound_by="bytes" if bound_b >= bound_o else "operations",
                library_ms=lib_ms,
            )
            log(f"[prefill-attn B={b} S={s}] kernel_ms {ms:.4f} plain_ms "
                f"{plain_ms:.4f} sdpa_ms {lib_ms:.4f} bound_ms "
                f"{entry['bound_ms']:.4f} ({entry['bound_by']}; "
                f"{ops / ms / 1e9:.1f} TFLOP/s achieved; "
                f"{b * h * s * (s + 1) // 2} active pairs; "
                f"{plan_counts(s)})")
            log(f"[prefill-attn kernel B] {ops / ms / 1e9:.1f} TFLOP/s; "
                f"{evidence}")
        del q, k, v, ref, out
        torch.cuda.empty_cache()
    return entry


# ---------------------------------------------------------------------------
# Kernel C: attention sink + sliding window prefill
# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# Library yardstick of kernels C, F and G: flex_attention (timed only)
# ---------------------------------------------------------------------------


FLEX_BLOCK = 128  # flex_attention's block; also vs_block at the JAX defaults
_FLEX = {}


def _flex_call(torch):
    """``flex_attention`` under ``torch.compile``: the one PyTorch call that
    computes C's, F's and G's functions without a dense [S, S] mask. Timed
    beside the kernels only; the port never calls it."""
    if "fn" not in _FLEX:
        from torch.nn.attention.flex_attention import flex_attention

        _FLEX["fn"] = torch.compile(flex_attention, dynamic=False)
    return _FLEX["fn"]


def _block_grid(torch, n: int, device):
    """(qb [n, 1], kb [1, n]) block indices."""
    i = torch.arange(n, device=device)
    return i[:, None], i[None, :]


def flex_block_mask(torch, active, full, mask_mod, s: int):
    """A ``BlockMask`` from [B, H, nQ, nK] block flags: ``full`` blocks hold
    only active pairs and skip ``mask_mod``; the other ``active`` blocks
    apply it pair by pair."""
    from torch.nn.attention.flex_attention import BlockMask

    def lists(m):
        ids = torch.argsort((~m).to(torch.uint8), dim=-1, stable=True)
        return m.sum(-1, dtype=torch.int32), ids.to(torch.int32).contiguous()

    kv_num, kv_ids = lists(active & ~full)
    f_num, f_ids = lists(full)
    return BlockMask.from_kv_blocks(kv_num, kv_ids, f_num, f_ids,
                                    BLOCK_SIZE=FLEX_BLOCK, mask_mod=mask_mod,
                                    seq_lengths=(s, s))


def stream_flex_mask(torch, s: int, window: int, sink: int, device):
    """C's function, causal & (k < sink | q - k < window), one mask for
    every batch row and head."""
    qb, kb = _block_grid(torch, s // FLEX_BLOCK, device)
    d = (qb - kb) * FLEX_BLOCK  # q - k spans d - 127 .. d + 127 in a block
    active = (kb <= qb) & ((kb * FLEX_BLOCK < sink)
                           | (d - (FLEX_BLOCK - 1) < window))
    full = (kb < qb) & (((kb + 1) * FLEX_BLOCK <= sink)
                        | (d + (FLEX_BLOCK - 1) < window))

    def mask_mod(b, h, q, k):
        return (q >= k) & ((k < sink) | (q - k < window))

    return flex_block_mask(torch, active[None, None], full[None, None],
                           mask_mod, s)


def walk_flex_mask(torch, col_flag, diag_flag, b: int, h: int, s: int):
    """G's function at 128-blocks: causal & (col_flag[k // 128] |
    diag_flag[q // 128 - k // 128]), flags [B*H, S / 128]."""
    n = s // FLEX_BLOCK
    col = (col_flag > 0).reshape(b, h, n)
    dg = (diag_flag > 0).reshape(b, h, n)
    qb, kb = _block_grid(torch, n, col.device)
    active = (kb <= qb) & (col[..., None, :] | dg[..., (qb - kb).clamp(min=0)])
    full = active & (kb < qb)

    def mask_mod(bi, hi, q, k):
        kbi = k // FLEX_BLOCK
        return (q >= k) & (col[bi, hi, kbi]
                           | dg[bi, hi, (q // FLEX_BLOCK - kbi).clamp(min=0)])

    return flex_block_mask(torch, active, full, mask_mod, s)


def tile_flex_mask(torch, v_idx, diag_flag, b: int, h: int, s: int,
                   seq_len: int):
    """F's function: causal & k < seq_len & (diag_flag[(q - k) // 128] |
    k in v_idx), v_idx [B*H, NV] (pads >= seq_len), flags [B*H, S / 128]."""
    n = s // FLEX_BLOCK
    vert = torch.zeros(v_idx.shape[0], s + 1, dtype=torch.bool,
                       device=v_idx.device)
    vert.scatter_(1, torch.where(v_idx < seq_len, v_idx, s).long(), True)
    vert = vert[:, :s].reshape(b, h, s)
    dg = (diag_flag > 0).reshape(b, h, n)
    qb, kb = _block_grid(torch, n, vert.device)
    below = kb < qb
    # A block below the diagonal spans bands qb - kb - 1 and qb - kb.
    hi_band = dg[..., (qb - kb).clamp(min=0)]
    lo_band = dg[..., (qb - kb - 1).clamp(min=0)] & below
    any_vert = vert.reshape(b, h, n, FLEX_BLOCK).any(-1)[..., None, :]
    active = (kb <= qb) & (hi_band | lo_band | any_vert)
    full = below & hi_band & lo_band & ((kb + 1) * FLEX_BLOCK <= seq_len)

    def mask_mod(bi, hi, q, k):
        band = dg[bi, hi, ((q - k) // FLEX_BLOCK).clamp(min=0)]
        return (q >= k) & (k < seq_len) & (band | vert[bi, hi, k])

    return flex_block_mask(torch, active, full, mask_mod, s)


def flex_ms(torch, label, q, k, v, block_mask, scale, kernel_out):
    """Device ms of the compiled ``flex_attention`` on q [B, H, S, Dh] and
    k/v [B, KV, S, Dh] under ``block_mask``, after holding its output to
    the kernel's ([B*H, S, Dh]) at the kernels' per-row tolerance; None,
    with the reason logged, when it fails to compile, run or agree."""
    fn = _flex_call(torch)

    def run():
        return fn(q, k, v, block_mask=block_mask, scale=scale,
                  enable_gqa=True)

    try:
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        rel = row_rel_err(torch, out.reshape(kernel_out.shape), kernel_out)
        del out
        if not rel <= ATTN_ROW_TOL:
            log(f"[{label}] flex_attention disagrees with the kernel: "
                f"per-row relative {rel:.3e}; library: none")
            return None
        ms = time_ms(torch, run, reps=3, warmup=1)
    except Exception as e:  # noqa: BLE001 — a yardstick, not the port
        log(f"[{label}] flex_attention failed ({type(e).__name__}: {e}); "
            "library: none")
        return None
    log(f"[{label}] flex_attention (compiled) {ms:.4f} ms; per-row relative "
        f"to the kernel {rel:.3e}; first call with compile {first_s:.1f} s")
    return ms


STREAM = dict(stream_window=8192, stream_sink=1024)  # the JAX defaults


def _stream_pairs(torch, s: int, window: int, sink: int) -> int:
    """Active (query, key) pairs of one head: the window's keys plus the
    sink keys below it."""
    q = torch.arange(s, dtype=torch.int64)
    win = q.clamp(max=window - 1) + 1
    extra = (q - window + 1).clamp(min=0).clamp(max=sink)
    return int((win + extra).sum())


def check_sparse_prefill(torch, cfg, evidence: str) -> dict:
    """Kernel C against its plain version at B 1 / S 4104 (window 1024, sink
    64) and at the main path's shape, B 2 / S 32768 (window 8192, sink
    1024), timed at the latter beside SDPA under the same boolean mask and
    the compiled flex_attention under the same function's block mask."""
    import torch.nn.functional as F

    from shadowkv_tpu_torch.core.attention import sparse_prefill_attention
    from shadowkv_tpu_torch.kernels.prefill_attention import (
        sparse_prefill_splash,
    )

    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 5)
    h, kh, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    entry = None
    for b, s, window, sink in ((1, 4104, 1024, 64),
                               (BATCH, PROMPT_LEN, STREAM["stream_window"],
                                STREAM["stream_sink"])):
        q = torch.randn(b, s, h, dh, device=DEVICE, generator=gen,
                        dtype=torch.bfloat16)
        k = torch.randn(b, s, kh, dh, device=DEVICE, generator=gen,
                        dtype=torch.bfloat16)
        v = torch.randn(b, s, kh, dh, device=DEVICE, generator=gen,
                        dtype=torch.bfloat16)
        run = lambda: sparse_prefill_splash(q, k, v, window, sink)  # noqa: E731
        ref, plain_ms = _timed(torch, lambda: sparse_prefill_attention(
            q, k, v, window, sink))
        out = run()
        torch.cuda.synchronize()
        err = float((out.float() - ref.float()).abs().max())
        rel = row_rel_err(torch, out, ref)
        log(f"[stream-attn B={b} S={s} window {window} sink {sink}] "
            f"max_abs_err {err:.3e}; per-row relative {rel:.3e} (tol "
            f"{ATTN_ROW_TOL:.3e})")
        if not rel <= ATTN_ROW_TOL:
            raise AssertionError(f"stream attention B={b} S={s}: kernel "
                                 "disagrees with its plain version")
        del ref
        if s != PROMPT_LEN:
            del out
            continue
        ms = time_ms(torch, run, reps=5, warmup=1)
        pairs = _stream_pairs(torch, s, window, sink) * b * h
        nbytes = (2 * q.numel() + k.numel() + v.numel()) * 2
        b_ms, b_by = bound(nbytes, 4 * dh * pairs)
        qh = q.transpose(1, 2).contiguous()
        kh_, vh = k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous()
        flex = flex_ms(torch, f"stream-attn B={b} S={s}", qh, kh_, vh,
                       stream_flex_mask(torch, s, window, sink, DEVICE),
                       dh**-0.5, out.transpose(1, 2))
        del out
        sdpa = None
        try:
            pos = torch.arange(s, device=DEVICE)
            mask = (pos[None] <= pos[:, None]) & (
                (pos[None] < sink) | (pos[:, None] - pos[None] < window))
            kr = kh_.repeat_interleave(h // kh, dim=1)
            vr = vh.repeat_interleave(h // kh, dim=1)
            sdpa = time_ms(torch, lambda: F.scaled_dot_product_attention(
                qh, kr, vr, attn_mask=mask), reps=3, warmup=1)
            del kr, vr, mask
        except (RuntimeError, torch.OutOfMemoryError) as e:
            log(f"[stream-attn] SDPA under the [S, S] mask: none ({e})")
        del qh, kh_, vh
        # The faster of the two library calls is the yardstick.
        lib_ms = min((t for t in (flex, sdpa) if t is not None), default=None)
        entry = dict(
            name="sparse_prefill_attention", route="cuda",
            source="shadowkv_tpu_torch/csrc/prefill_attention.cu",
            replaces="shadowkv_tpu/core/attention.py:158",
            launches=0, max_abs_err=err, ms=ms, plain_ms=plain_ms,
            bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
        )
        log(f"[stream-attn B={b} S={s}] kernel_ms {ms:.4f} plain_ms "
            f"{plain_ms:.4f} flex_ms {flex} sdpa_masked_ms {sdpa} bound_ms "
            f"{b_ms:.4f} ({b_by}; {pairs} active pairs, "
            f"{4 * dh * pairs / ms / 1e9:.1f} TFLOP/s achieved; "
            f"{plan_counts(s, window, sink)})")
        log(f"[stream-attn kernel C] {4 * dh * pairs / ms / 1e9:.1f} TFLOP/s; "
            f"{evidence}")
        del q, k, v
        torch.cuda.empty_cache()
    return entry


# ---------------------------------------------------------------------------
# Kernels F and G: MInference vertical + slash prefill (tile and walk)
# ---------------------------------------------------------------------------


VS = dict(vs_vertical_size=1000, vs_slash_size=6144,
          vs_block=128)  # the JAX defaults


def _vs_flag_sets(torch, gen, q, k, s: int):
    """{label: ([BH, S] vertical, [BH, S] slash scores)}: the estimate from
    q/k, and a clustered set (slashes decaying from the diagonal with
    noise, 512 hot vertical tokens; the forced regions as the estimate's)."""
    from shadowkv_tpu_torch.core.minference import estimate_vertical_slash

    vert, sl = estimate_vertical_slash(q, k)
    bh = vert.shape[0] * vert.shape[1]
    sets = {"estimated": (vert.reshape(bh, s), sl.reshape(bh, s))}
    del vert, sl
    d = torch.arange(s, device=DEVICE, dtype=torch.float32)
    sl = -d / 2048.0 + 0.2 * torch.randn(bh, s, device=DEVICE, generator=gen)
    vert = 0.1 * torch.rand(bh, s, device=DEVICE, generator=gen)
    hot = torch.randint(0, s, (bh, 512), device=DEVICE, generator=gen)
    vert.scatter_add_(1, hot, torch.ones(bh, 512, device=DEVICE))
    vert[:, :30] = torch.inf
    sl[:, :100] = torch.inf
    sets["clustered"] = (vert, sl)
    return sets


def _vs_inputs(torch, vert, sl, s: int, sizes: dict = VS):
    """F's vertical ids [BH, vertical size] and band flags, G's block
    metadata and column flags, from scores at ``sizes`` (the JAX defaults;
    as minference_prefill(_tile) with every head vertical_and_slash)."""
    from shadowkv_tpu_torch.core import minference as mi

    vsz, ssz = mi.topk_sizes(sizes["vs_vertical_size"],
                             sizes["vs_slash_size"], s)
    block = sizes["vs_block"]
    v_idx, s_top = mi.top_k(vert, vsz), mi.top_k(sl, ssz)
    col, dflag = mi.vs_flags(v_idx, s_top, s // block, block)
    return v_idx, dflag, mi.meta_from_flags(col, dflag), col


def _check_rows(torch, label, out, ref, seq_len):
    rel = row_rel_err(torch, out[:, :seq_len], ref[:, :seq_len])
    err = float((out[:, :seq_len].float() - ref[:, :seq_len].float()).abs().max())
    log(f"[{label}] max_abs_err {err:.3e}; per-row relative {rel:.3e} (tol "
        f"{ATTN_ROW_TOL:.3e}) over the rows below {seq_len}")
    if not rel <= ATTN_ROW_TOL:
        raise AssertionError(f"{label}: kernel disagrees with its plain version")
    return err


def vs_plan_counts(name, v_idx, dflag, col, block: int, s: int) -> str:
    """Visited, masked and (F) vertical tiles of kernel F's or G's tile
    plan over all rows, against the causal key tiles."""
    from shadowkv_tpu_torch.kernels import vs_sparse, vs_tile

    if name == "F":
        vpos = vs_tile.vertical_positions(v_idx, s, s)
        plan = vs_tile.vs_tile_plan(vpos, dflag, block, s, s)
        extra = (f", {int(plan.vertical.sum())} vertical tiles of "
                 f"{plan.vertical.numel()} visited (all masked)")
    else:
        plan = vs_sparse.vs_walk_plan(col, dflag, block, s, s)
        extra = ""
    nq = plan.full.shape[1]
    causal = plan.full.shape[0] * nq * (nq + 1) // 2
    visited = int(plan.full.sum()) + int(plan.masked.sum())
    return (f"tile plan over {plan.full.shape[0]} rows: {visited} of "
            f"{causal} causal key tiles visited, {int(plan.masked.sum())} "
            f"of them masked{extra}")


def check_vs_kernels(torch, cfg, evidence: dict) -> tuple[dict, dict]:
    """Kernels F and G against their plain versions at the path's shape
    (B*H 64, S 32768, Dh 128) on both flag sets, timed on each; then at a
    ragged S with duplicate and past-the-end verticals, where a planted
    skipped tile must be rejected. Returns (F, G) entries timed on the
    estimated set."""
    from shadowkv_tpu_torch.core import minference as mi
    from shadowkv_tpu_torch.kernels import vs_sparse, vs_tile

    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 6)
    b, s, h, kh, dh = BATCH, PROMPT_LEN, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    block, scale = VS["vs_block"], dh**-0.5
    q = torch.randn(b, s, h, dh, device=DEVICE, generator=gen, dtype=torch.bfloat16)
    k = torch.randn(b, s, kh, dh, device=DEVICE, generator=gen, dtype=torch.bfloat16)
    v = torch.randn(b, s, kh, dh, device=DEVICE, generator=gen, dtype=torch.bfloat16)
    sets = _vs_flag_sets(torch, gen, q, k, s)
    q_f, k_f, v_f = mi.flat_heads(q, s), mi.flat_heads(k, s), mi.flat_heads(v, s)
    del q, k, v
    kv_map = mi.kv_map_of(b, kh, range(h), h // kh, DEVICE)
    io_bytes = (2 * q_f.numel() + k_f.numel() + v_f.numel()) * 2
    if block != FLEX_BLOCK:
        raise AssertionError("the flex_attention masks assume vs_block 128")
    q4, k4, v4 = (t.view(b, -1, s, dh) for t in (q_f, k_f, v_f))
    entries = {}
    for label, (vert, sl) in sets.items():
        v_idx, dflag, meta, col = _vs_inputs(torch, vert, sl, s)
        kw = dict(block=block, scale=scale, seq_len=s)
        runs = {
            "F": (lambda: vs_tile.vs_tile_attention(
                      q_f, k_f, v_f, v_idx, dflag, kv_map, **kw),
                  lambda: vs_tile.vs_tok_attention_reference(
                      q_f, k_f, v_f, v_idx, dflag, kv_map, **kw),
                  vs_tile.tile_masks(v_idx, dflag, block, s, s, 256),
                  (v_idx.numel() + dflag.numel()) * 4,
                  lambda: tile_flex_mask(torch, v_idx, dflag, b, h, s, s)),
            "G": (lambda: vs_sparse.vs_sparse_attention(
                      q_f, k_f, v_f, meta.col_ids, meta.col_cnt,
                      meta.col_flag, meta.diag_ids, meta.diag_cnt, kv_map,
                      **kw),
                  lambda: mi.vs_attention_reference(
                      q_f, k_f, v_f, meta, kv_map, **kw),
                  mi.walk_masks(meta, block, s, s, 256),
                  5 * meta.col_ids.numel() * 4,
                  lambda: walk_flex_mask(torch, col, dflag, b, h, s)),
        }
        for name, (run, plain, masks, extra_bytes, flex_mask) in runs.items():
            ref, plain_ms = _timed(torch, plain)
            out = run()
            torch.cuda.synchronize()
            err = _check_rows(torch, f"vs {name} {label}, BH {b * h} S {s}",
                              out, ref, s)
            del ref
            lib_ms = flex_ms(torch, f"vs {name} {label}", q4, k4, v4,
                             flex_mask(), scale, out)
            del out
            ms = time_ms(torch, run, reps=3, warmup=1)
            pairs = mi.active_pairs(masks, s)
            b_ms, b_by = bound(io_bytes + extra_bytes, 4 * dh * pairs)
            log(f"[vs {name} {label}] kernel_ms {ms:.4f} plain_ms "
                f"{plain_ms:.4f} flex_ms {lib_ms} bound_ms {b_ms:.4f} "
                f"({b_by}; {pairs} active pairs = "
                f"{pairs / (b * h * s * (s + 1) / 2):.4f} of causal; "
                f"{4 * dh * pairs / ms / 1e9:.1f} TFLOP/s achieved; "
                f"{vs_plan_counts(name, v_idx, dflag, col, block, s)})")
            log(f"[vs kernel {name}] {4 * dh * pairs / ms / 1e9:.1f} "
                f"TFLOP/s; {evidence[name]}")
            if label == "estimated":
                entries[name] = dict(
                    name=("vs_tile_attention" if name == "F"
                          else "vs_sparse_attention"),
                    route="cuda",
                    source=("shadowkv_tpu_torch/csrc/vs_tile.cu" if name == "F"
                            else "shadowkv_tpu_torch/csrc/vs_sparse.cu"),
                    replaces=("shadowkv_tpu/kernels/vs_tile.py:48" if name == "F"
                              else "shadowkv_tpu/kernels/vs_sparse.py:39"),
                    launches=0, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                    bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                )
        del v_idx, dflag, meta, col, runs
    del q_f, k_f, v_f, q4, k4, v4, sets
    torch.cuda.empty_cache()
    _check_vs_ragged(torch, gen)
    return entries["F"], entries["G"]


# ---------------------------------------------------------------------------
# Decode attention over the compact buffer
# ---------------------------------------------------------------------------

# The glm4 decode cell's buffer (portbench): B 8, 4 KV heads of 8 query
# heads, 2496 + 128 rows of 128, 40 layers.
DECODE_ATTN = dict(batch=8, kv_heads=4, groups=8, rows=2624, head_dim=128,
                   layers=40)


def check_decode_attention(torch, evidence: str) -> dict:
    """The decode-attention kernel against its plain version at the glm4
    decode cell's buffer, with [B] depths that differ and with a 0-d
    kv_len, per row within ATTN_ROW_TOL; the same check must reject the
    last valid key tile skipped (the kernel given kv_len - 64). Timed by
    device time over the whole buffer, each launch reading the next of 40
    stacked layers (cold L2, as in a decode step), against K and V read
    once over the HBM rate; the plain version and SDPA (GQA, the same bf16
    buffer; a yardstick the port never calls) beside it."""
    import torch.nn.functional as F

    from shadowkv_tpu_torch.kernels.decode_attention import (
        decode_attention,
        decode_attention_plain,
        plan,
    )
    from shadowkv_tpu_torch.tools.time_refresh import cycle_layers, device_ms

    sh = DECODE_ATTN
    b, kh, g, t, dh, n_l = (sh["batch"], sh["kv_heads"], sh["groups"],
                            sh["rows"], sh["head_dim"], sh["layers"])
    h = kh * g
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 17)
    k = torch.randn(n_l, b, kh, t, dh, device=DEVICE, generator=gen,
                    dtype=torch.bfloat16)
    v = torch.randn(n_l, b, kh, t, dh, device=DEVICE, generator=gen,
                    dtype=torch.bfloat16)
    q = torch.randn(b, 1, h, dh, device=DEVICE, generator=gen,
                    dtype=torch.bfloat16)
    depths = torch.randint(t - 128, t + 1, (b,), device=DEVICE, generator=gen,
                           dtype=torch.int32)
    depths[0] = t
    scalar = torch.tensor(t - 77, dtype=torch.int32, device=DEVICE)
    errs = {}
    for label, kv_len in (("[B] depths", depths), ("0-d kv_len", scalar)):
        ref = decode_attention_plain(q, k[0], v[0], kv_len)
        out = decode_attention(q, k[0], v[0], kv_len)
        torch.cuda.synchronize()
        errs[label] = row_rel_err(torch, out, ref)
        if label == "[B] depths":
            err = float((out.float() - ref.float()).abs().max())
            bad = decode_attention(q, k[0], v[0], depths - 64)
            torch.cuda.synchronize()
            bad_rel = row_rel_err(torch, bad, ref)
    log(f"[decode-attn B={b} K={kh} G={g} T={t}] per-row relative "
        + ", ".join(f"{k_} {e:.3e}" for k_, e in errs.items())
        + f" (tol {ATTN_ROW_TOL:.3e}); last key tile skipped {bad_rel:.3e} "
        f"(rejected: {bad_rel > ATTN_ROW_TOL}); {plan(b, kh, g, t, dh)}")
    if not max(errs.values()) <= ATTN_ROW_TOL:
        raise AssertionError("decode attention: kernel disagrees with its "
                             "plain version")
    if not bad_rel > ATTN_ROW_TOL:
        raise AssertionError("the per-row check misses a skipped key tile")

    full = torch.tensor(t, dtype=torch.int32, device=DEVICE)
    ms = device_ms(cycle_layers(lambda lyr: decode_attention(
        q, k[lyr], v[lyr], full), n_l), reps=4 * n_l, warmup=n_l)
    plain_ms = device_ms(lambda: decode_attention_plain(q, k[0], v[0], full),
                         reps=5)
    qh = q.transpose(1, 2)
    lib_ms = device_ms(cycle_layers(lambda lyr: F.scaled_dot_product_attention(
        qh, k[lyr], v[lyr], enable_gqa=True), n_l), reps=4 * n_l, warmup=n_l)
    nbytes = 2 * k[0].numel() * 2 + 2 * q.numel() * 2
    b_ms, b_by = bound(nbytes, 2 * 2 * b * h * t * dh)
    log(f"[decode-attn] kernel_ms {ms:.4f} (device time, cold L2, cycling "
        f"{n_l} layers) plain_ms {plain_ms:.4f} sdpa_ms {lib_ms:.4f} "
        f"bound_ms {b_ms:.4f} ({b_by}: {nbytes} B) = "
        f"{100 * b_ms / ms:.1f} % of the bound; {evidence}")
    del k, v, q
    torch.cuda.empty_cache()
    return dict(
        name="decode_attention", route="cuda",
        source="shadowkv_tpu_torch/csrc/decode_attention.cu",
        replaces=None, launches=0, max_abs_err=err, ms=ms, plain_ms=plain_ms,
        bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
    )


# The decode cells' selection at one layer: (label, B, K, int8, layers
# cycled for a cold L2). C 4088 and S 256 are the cells' (32K prompt, chunk
# 8, 4 local and 48 outlier chunks, budget 2048), G 8 query heads a KV head.
SELECT_SHAPES = (("glm4", 8, 4, False, 8), ("yi int8", 8, 4, True, 16),
                 ("k-exaone", 8, 8, False, 4))
SELECT_CHUNKS, SELECT_SETS, SELECT_GROUPS = 4088, 256, 8
SELECT_TIE_TOL = 1e-6  # near-ties: plain probs within this of the S-th


def select_agrees(torch, asg, probs, prev, s: int) -> bool:
    """The kernel's chosen set (its slot ids) is S distinct chunks equal to
    the plain top-S but at near-ties (plain probs within SELECT_TIE_TOL of
    the S-th, relative), and its slot ids, stay flags and count are
    ``assign_slots_stable``'s for that set, bit for bit."""
    from shadowkv_tpu_torch.core.selection import assign_slots_stable

    ids = asg.slot_ids.long()
    if not bool(((ids >= 0) & (ids < probs.shape[-1])).all()):
        return False
    got = torch.zeros_like(probs, dtype=torch.bool).scatter_(-1, ids, True)
    top = torch.topk(probs, s)
    want = torch.zeros_like(got).scatter_(-1, top.indices, True)
    t = top.values[..., -1:]
    near = (probs - t).abs() <= SELECT_TIE_TOL * t
    ref = assign_slots_stable(prev, asg.slot_ids)
    return bool((got.sum(-1) == s).all()) \
        and not bool(((got ^ want) & ~near).any()) \
        and torch.equal(asg.slot_ids, ref.slot_ids) \
        and torch.equal(asg.stay_mask, ref.stay_mask) \
        and torch.equal(asg.stay_count, ref.stay_count)


def check_select(torch, evidence: str) -> dict:
    """The selection kernel against its plain version at each decode cell's
    layer (SELECT_SHAPES): random bf16 queries and landmarks (int8 with f32
    row scales for Yi), ~1.2 % outlier chunks, previous ids that overlap
    the new choice (the plain selection for a nearby query). The check
    (``select_agrees``) must pass the kernel and reject its output with the
    S-th chunk swapped for the (S+1)-th. Timed by device time, each launch
    reading the next of the stacked layers' tables (cold L2, as in a decode
    step), against the table, its scales and mask read once; the plain
    version beside it. Returns the kernel-table entry (glm4's shape)."""
    from shadowkv_tpu_torch.core.quant import quantize_rows
    from shadowkv_tpu_torch.core.selection import (
        landmark_probs,
        score_and_select,
    )
    from shadowkv_tpu_torch.kernels.select import (
        plan,
        select_slots,
        select_slots_plain,
    )
    from shadowkv_tpu_torch.tools.time_refresh import cycle_layers, device_ms

    c, s, g, dh = SELECT_CHUNKS, SELECT_SETS, SELECT_GROUPS, 128
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 29)
    entry = None
    for label, b, kh, int8, n_l in SELECT_SHAPES:
        lm = torch.randn(n_l, b, kh, c, dh, device=DEVICE, generator=gen,
                         dtype=torch.bfloat16)
        scale = None
        if int8:
            lm, scale = quantize_rows(lm)
        mask = torch.rand(b, kh, c, device=DEVICE, generator=gen) > 0.012
        q = torch.randn(b, 1, kh * g, dh, device=DEVICE, generator=gen,
                        dtype=torch.bfloat16).transpose(1, 2).reshape(
                            b, kh, g, 1, dh)
        near = (q.float() + torch.randn(q.shape, device=DEVICE,
                                        generator=gen)).bfloat16()
        sc0 = None if scale is None else scale[0]
        prev = score_and_select(near, lm[0], mask, s, landmark_scale=sc0)
        asg = select_slots(q, lm[0], mask, prev, s, landmark_scale=sc0)
        probs = landmark_probs(q, lm[0], mask, sc0)
        ok = select_agrees(torch, asg, probs, prev, s)
        order = torch.argsort(probs[0, 0], descending=True)
        swapped = asg.slot_ids.clone()
        row = swapped[0, 0]
        row[row == order[s - 1]] = order[s].int()
        caught = not select_agrees(torch, asg._replace(slot_ids=swapped),
                                   probs, prev, s)
        stays = int(asg.stay_count.sum())
        log(f"[select {label} B={b} K={kh} G={g} C={c} S={s}] agrees with "
            f"the plain version: {ok} (near-tie tolerance {SELECT_TIE_TOL}); "
            f"S-th swapped for the (S+1)-th rejected: {caught}; {stays} of "
            f"{b * kh * s} slots stay; {plan(b, kh, g, c, s, dh, int8)}")
        if not ok:
            raise AssertionError(f"select {label}: kernel disagrees with its "
                                 "plain version")
        if not caught:
            raise AssertionError(f"select {label}: the check misses the S-th "
                                 "chunk swapped for the (S+1)-th")
        ms = device_ms(cycle_layers(lambda lyr: select_slots(
            q, lm[lyr], mask, prev, s,
            landmark_scale=None if scale is None else scale[lyr]), n_l),
            reps=4 * n_l, warmup=n_l)
        plain_ms = device_ms(lambda: select_slots_plain(
            q, lm[0], mask, prev, s, landmark_scale=sc0), reps=5)
        nbytes = (lm[0].numel() * lm.element_size() + mask.numel()
                  + (0 if sc0 is None else sc0.numel() * 4)
                  + q.numel() * 2 + 2 * prev.numel() * 4 + prev.numel())
        b_ms, b_by = bound(nbytes, 2 * b * kh * g * c * dh)
        log(f"[select {label}] kernel_ms {ms:.4f} (device time, cold L2, "
            f"cycling {n_l} layers) plain_ms {plain_ms:.4f} bound_ms "
            f"{b_ms:.4f} ({b_by}: {nbytes} B) = {100 * b_ms / ms:.1f} % of "
            f"the bound; {evidence}")
        if entry is None:
            entry = dict(
                name="select_slots", route="cuda",
                source="shadowkv_tpu_torch/csrc/select.cu", replaces=None,
                launches=0, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=None)
        del lm, scale
        torch.cuda.empty_cache()
    return entry


# ---------------------------------------------------------------------------
# K-EXAONE: the hybrid model's kernel shapes and its engine slice
# ---------------------------------------------------------------------------


# The K-EXAONE decode cell's shapes: 64 / 8 heads of 128, a 128-row window
# ring per sliding layer, ShadowKV's compact buffer (budget 2048, 48
# outlier and 4 local chunks of 8, a 128-row gen region) on the global ones.
K_EXAONE = dict(batch=8, prompt=32768, heads=64, kv_heads=8, window=128,
                rows=2624, head_dim=128)
K_EXAONE_LAYERS = 8  # the slice: layer 0 dense, LLLG twice
K_EXAONE_STEPS = 8


def _rows_within(torch, label: str, out, ref, fault, fault_label: str):
    """Per-row relative error of ``out`` against ``ref`` within
    ATTN_ROW_TOL, and of the planted ``fault`` beyond it."""
    rel = row_rel_err(torch, out, ref)
    bad = row_rel_err(torch, fault, ref)
    log(f"[{label}] per-row relative {rel:.3e} (tol {ATTN_ROW_TOL:.3e}); "
        f"{fault_label} {bad:.3e} (rejected: {bad > ATTN_ROW_TOL})")
    if not rel <= ATTN_ROW_TOL:
        raise AssertionError(f"{label}: kernel disagrees with its plain "
                             "version")
    if not bad > ATTN_ROW_TOL:
        raise AssertionError(f"{label}: the per-row check misses "
                             f"{fault_label}")


def check_k_exaone_attention(torch) -> None:
    """The attention kernels at the K-EXAONE cell's shapes against their
    plain versions, per row within ATTN_ROW_TOL: kernel C at B 1, S 32768,
    64 / 8 heads, window 128, sink 0 (a sliding layer's prefill; a window
    of 129 must be rejected); the decode-attention kernel over a sliding
    layer's ring [8, 8, 128, 128] with kv_len = min(pos + 1, 128) per row
    (positions before, at and past the window; one key fewer must be
    rejected) and over the global layers' compact buffer (B 8, 8 KV heads
    of G 8, 2624 rows; [B] depths and a 0-d kv_len; the last key tile
    skipped must be rejected)."""
    from shadowkv_tpu_torch.core.attention import sparse_prefill_attention
    from shadowkv_tpu_torch.kernels.decode_attention import (
        decode_attention,
        decode_attention_plain,
        plan,
    )
    from shadowkv_tpu_torch.kernels.prefill_attention import (
        sparse_prefill_splash,
    )

    sh = K_EXAONE
    b, s, h, kh, w, t, dh = (sh["batch"], sh["prompt"], sh["heads"],
                             sh["kv_heads"], sh["window"], sh["rows"],
                             sh["head_dim"])
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 19)

    def rnd(*shape):
        return torch.randn(*shape, device=DEVICE, generator=gen,
                           dtype=torch.bfloat16)

    q, k, v = rnd(1, s, h, dh), rnd(1, s, kh, dh), rnd(1, s, kh, dh)
    ref = sparse_prefill_attention(q, k, v, w, 0)
    out = sparse_prefill_splash(q, k, v, w, 0)
    wide = sparse_prefill_splash(q, k, v, w + 1, 0)
    torch.cuda.synchronize()
    _rows_within(torch, f"k-exaone stream-attn B=1 S={s} H={h}/{kh} window "
                 f"{w} sink 0; {plan_counts(s, w, 0)}", out, ref, wide,
                 f"window {w + 1}")
    del q, k, v, ref, out, wide

    q = rnd(b, 1, h, dh)
    ring_k, ring_v = rnd(b, kh, w, dh), rnd(b, kh, w, dh)
    pos = torch.tensor([0, 5, 63, 64, 126, 127, 128, s + 77], device=DEVICE)
    kv_len = (pos + 1).clamp(max=w).to(torch.int32)
    _rows_within(
        torch, f"k-exaone ring decode-attn B={b} K={kh} G={h // kh} W={w}, "
        f"kv_len {kv_len.tolist()}",
        decode_attention(q, ring_k, ring_v, kv_len),
        decode_attention_plain(q, ring_k, ring_v, kv_len),
        decode_attention(q, ring_k, ring_v, (kv_len - 1).clamp(min=1)),
        "one key fewer")

    buf_k, buf_v = rnd(b, kh, t, dh), rnd(b, kh, t, dh)
    depths = torch.randint(t - 128, t + 1, (b,), device=DEVICE,
                           generator=gen, dtype=torch.int32)
    depths[0] = t
    scalar = torch.tensor(t - 77, dtype=torch.int32, device=DEVICE)
    for label, n in (("[B] depths", depths), ("0-d kv_len", scalar)):
        _rows_within(
            torch, f"k-exaone buffer decode-attn B={b} K={kh} G={h // kh} "
            f"T={t}, {label}; {plan(b, kh, h // kh, t, dh)}",
            decode_attention(q, buf_k, buf_v, n),
            decode_attention_plain(q, buf_k, buf_v, n),
            decode_attention(q, buf_k, buf_v, n - 64), "last key tile skipped")
    del q, ring_k, ring_v, buf_k, buf_v
    torch.cuda.empty_cache()


def _k_exaone_weights(torch, md, gen) -> dict:
    """Random bf16 weights of a K-EXAONE slice in ``ModelParams
    .from_tensors``'s layout (the router and its bias f32): N(0, 0.02), the
    router N(0, 1/sqrt(D)), every norm gain 1."""
    n, d, v = md.num_layers, md.hidden_size, md.vocab_size
    h, kh, dh = md.num_heads, md.num_kv_heads, md.head_dim
    moe = md.moe_layers
    lm, ld = len(moe), n - len(moe)
    eh, ie, e = len(md.held), md.moe_intermediate_size, md.num_experts
    i_s, i_d = ie * md.num_shared_experts, md.intermediate_size

    def rnd(*shape, std=0.02, dtype=torch.bfloat16):
        return torch.empty(shape, dtype=dtype, device=DEVICE).normal_(
            0.0, std, generator=gen)

    def ones(*shape):
        return torch.ones(shape, dtype=torch.bfloat16, device=DEVICE)

    return dict(
        embed=rnd(v, d), wqkv=rnd(n, d, (h + 2 * kh) * dh),
        wo=rnd(n, h * dh, d), q_norm=ones(n, dh), k_norm=ones(n, dh),
        post_attn_norm=ones(n, d), post_mlp_norm=ones(n, d),
        dense_gate_up=rnd(ld, d, 2 * i_d), dense_down=rnd(ld, i_d, d),
        router=rnd(lm, d, e, std=d**-0.5, dtype=torch.float32),
        e_bias=rnd(lm, e, dtype=torch.float32),
        experts_gate_up=rnd(lm, eh, d, 2 * ie),
        experts_down=rnd(lm, eh, ie, d), shared_gate_up=rnd(lm, d, 2 * i_s),
        shared_down=rnd(lm, i_s, d), final_norm=ones(d), lm_head=rnd(d, v))


def run_k_exaone_slice(torch) -> dict:
    """K-EXAONE at full width, its first K_EXAONE_LAYERS layers (layer 0
    dense, then LLLG twice: 6 sliding layers, 2 NoPE global ones, 7 MoE
    layers of experts 0-7 held of 128), with the cell's cache settings
    (ShadowKV on the global layers, budget 2048, rank 160, chunk 8, bf16
    stores, the fused refresh; a 128-row ring per sliding layer) at 32768
    x 8 through ``Engine.prefill`` and the compiled ``decode_step``. The
    launches are counted from zero just before the prefill (B once per
    global layer and row, C once per sliding layer and row, nothing else)
    and again just before K_EXAONE_STEPS replayed steps (A and selection
    once per global layer and step, decode attention once per layer and
    step, nothing else); the caches hold only their layers."""
    import dataclasses

    import numpy as np

    from shadowkv_tpu_torch.config import CacheConfig, RuntimeConfig
    from shadowkv_tpu_torch.core.layers import ModelParams
    from shadowkv_tpu_torch.kernels.decode_attention import decode_attention
    from shadowkv_tpu_torch.kernels.select import select_slots
    from shadowkv_tpu_torch.models.engine import Engine
    from shadowkv_tpu_torch.models.registry import k_exaone_236b

    sh, n = K_EXAONE, K_EXAONE_LAYERS
    full = k_exaone_236b("LGAI-EXAONE/K-EXAONE-236B-A23B",
                         held_experts=tuple(range(8)))
    md = dataclasses.replace(full, num_layers=n,
                             layer_types=full.layer_types[:n],
                             mlp_layer_types=full.mlp_layer_types[:n])
    n_glob, n_slide = len(md.global_layers), len(md.sliding_layers)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 23)
    params = ModelParams.from_tensors(_k_exaone_weights(torch, md, gen), md)
    b, s = sh["batch"], sh["prompt"]
    cc = CacheConfig(mode="shadow", max_length=s, sparse_budget=2048,
                     rank=160, chunk_size=8, local_chunks=4,
                     outlier_chunks=48, gen_capacity=128, kv_quant="none")
    eng = Engine(md, cc, RuntimeConfig(use_pallas=True, prefill_sub_batch=1),
                 params, device=DEVICE)
    ids = np.random.RandomState(SEED).randint(1, md.vocab_size, (b, s))
    counters = _counters()
    _reset_counts(counters)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = eng.prefill(ids)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    _expect("k-exaone prefill", _read_counts(counters),
            prefill_attention=n_glob * b,
            sparse_prefill_attention=n_slide * b)
    hy = cache.hybrid
    if not (cache.u.shape[0] == n_glob and hy.ring_k.shape[:4] == (
            n_slide, b, sh["kv_heads"], sh["window"])):
        raise AssertionError(f"k-exaone slice: ShadowKV state for "
                             f"{cache.u.shape[0]} layers, rings "
                             f"{tuple(hy.ring_k.shape)}")
    tok = logits[:, -1].argmax(-1).to(torch.int32)
    for _ in range(3):  # an eager step, the capture, a replay
        tok, _ = eng.decode_step(cache, tok)
    _reset_counts(counters)
    attn_before = decode_attention.launches
    select_before = select_slots.launches
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    toks = []
    for _ in range(K_EXAONE_STEPS):
        tok, _ = eng.decode_step(cache, tok)
        toks.append(tok.clone())
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / K_EXAONE_STEPS * 1e3
    got = _read_counts(counters)
    got["decode_attention"] = decode_attention.launches - attn_before
    got["select_slots"] = select_slots.launches - select_before
    _expect("k-exaone replayed steps", got,
            sparse_refresh=n_glob * K_EXAONE_STEPS,
            decode_attention=n * K_EXAONE_STEPS,
            select_slots=n_glob * K_EXAONE_STEPS)
    toks = torch.stack(toks)
    if eng._steps.captures != 2 or toks.min() < 0 \
            or toks.max() >= md.vocab_size:
        raise AssertionError(f"k-exaone slice: {eng._steps.captures} "
                             f"captures, tokens {toks.min()}..{toks.max()}")
    res = dict(layers=n, global_layers=n_glob, sliding_layers=n_slide,
               prefill_s=prefill_s, step_ms=step_ms, launches=got,
               peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    log("[k-exaone slice] " + json.dumps(res))
    del eng, cache, params, logits, hy
    _release(torch)
    return res


def _check_vs_ragged(torch, gen) -> None:
    """F and G at S 4104 (padded to 4608 and 4224) with random flags, and
    for F verticals with duplicates, entries past the sequence and pads.
    Then each check must reject a planted fault: rows 3584-4095 recomputed
    without the off-diagonal 128-key tile that holds most of their active
    pairs."""
    from shadowkv_tpu_torch.core import minference as mi
    from shadowkv_tpu_torch.kernels import vs_sparse, vs_tile

    s, block, bh, bkv = 4104, 128, 8, 2
    r0, r1 = 3584, 4096
    kv_map = torch.arange(bh, device=DEVICE, dtype=torch.int32) // (bh // bkv)
    for name, s_pad in (("F", 4608), ("G", 4224)):
        n_blk = s_pad // block
        q = torch.randn(bh, s_pad, 128, device=DEVICE, generator=gen).bfloat16()
        k = torch.randn(bkv, s_pad, 128, device=DEVICE, generator=gen).bfloat16()
        v = torch.randn(bkv, s_pad, 128, device=DEVICE, generator=gen).bfloat16()
        diag = (torch.rand(bh, n_blk, device=DEVICE, generator=gen) < 0.3).int()
        diag[:, 0] = 1
        kw = dict(block=block, scale=128**-0.5, seq_len=s)
        if name == "F":
            v_idx = torch.randint(0, s_pad, (bh, 1024), device=DEVICE,
                                  generator=gen, dtype=torch.int32)
            v_idx[:, 100:200] = v_idx[:, :100]
            v_idx[:, -64:] = 2 * s_pad
            ref = vs_tile.vs_tok_attention_reference(q, k, v, v_idx, diag,
                                                     kv_map, **kw)
            out = vs_tile.vs_tile_attention(q, k, v, v_idx, diag, kv_map, **kw)
            masks = vs_tile.tile_masks(v_idx, diag, block, s_pad, s, r1 - r0)
        else:
            col = (torch.rand(bh, n_blk, device=DEVICE, generator=gen) < 0.3).int()
            meta = mi.meta_from_flags(col, diag)
            ref = mi.vs_attention_reference(q, k, v, meta, kv_map, **kw)
            out = vs_sparse.vs_sparse_attention(
                q, k, v, meta.col_ids, meta.col_cnt, meta.col_flag,
                meta.diag_ids, meta.diag_cnt, kv_map, **kw)
            masks = mi.walk_masks(meta, block, s_pad, s, r1 - r0)
        torch.cuda.synchronize()
        _check_rows(torch, f"vs {name} ragged, S {s} in {s_pad}", out, ref, s)
        mask = next(m for q0, m in masks if q0 == r0)
        per_tile = mask.reshape(bh, r1 - r0, -1, 128).sum((0, 1, 3))
        t = int(per_tile[:r0 // 128].argmax())
        bad = _skip_tile_fault(torch, q, k, v, ref, (r0, r1),
                               (128 * t, 128 * t + 128), mask=mask,
                               kv_map=kv_map)
        bad_rel = row_rel_err(torch, bad[:, :s], ref[:, :s])
        log(f"[vs {name} fault: key tile {128 * t}-{128 * t + 127} "
            f"({int(per_tile[t])} active pairs) skipped for rows "
            f"{r0}-{r1 - 1}] per-row relative {bad_rel:.3e} (rejected: "
            f"{bad_rel > ATTN_ROW_TOL})")
        if not bad_rel > ATTN_ROW_TOL:
            raise AssertionError(f"vs {name}: the per-row check misses a "
                                 "skipped tile")
        del q, k, v, ref, out, bad, mask


# ---------------------------------------------------------------------------
# head_dim 96 (Phi-3): the attention kernels through their padding wrappers
# ---------------------------------------------------------------------------


HEAD_DIM_96 = 96
# The toy engines of the head_dim-96 phase: dense prefill (kernel B), then
# the XLA-gather decode branch (kernel A serves head_dim 128 only, as the
# JAX kernel does) or the full cache. The shadow cache selects all 20
# landmark chunks of the toy prompt: with 8 of 20, the card's and the CPU's
# selections part at near-ties of the chunk scores at this head_dim with
# the plain prefill attention on the card as well (cuSOLVER and the CPU's
# eigen-solver give other low-rank bases, bf16 rounds in another order),
# and the decode logits then compare different caches.
TOY_96_SETTINGS = (("shadow xla-gather, every chunk selected", "shadow",
                    dict(use_pallas=None)),
                   ("full", "full", dict()))
TOY_96_BUDGET = 320  # 20 landmark chunks of 16 tokens


def check_head_dim_96(torch) -> None:
    """B, C, F and G at head_dim 96 against their plain versions: the
    wrappers zero-pad q, k and v to the kernels' 128 lanes, keep the
    softmax scale of the true head_dim and slice the output back. B 1, S
    4096, 8 query heads on 2 KV heads (B, C; window 1024, sink 64); F and G
    on the same rows as [B*H, S, 96] with random band, column and vertical
    flags. Per-row tolerance as at 128. Then the toy engine at head_dim 96
    on the card against the CPU."""
    from shadowkv_tpu_torch.core.attention import (
        causal_prefill_attention, sparse_prefill_attention,
    )
    from shadowkv_tpu_torch.core.minference import (
        flat_heads, kv_map_of, meta_from_flags, vs_attention_reference,
    )
    from shadowkv_tpu_torch.kernels.prefill_attention import (
        causal_prefill_splash, sparse_prefill_splash,
    )
    from shadowkv_tpu_torch.kernels.vs_sparse import vs_sparse_attention
    from shadowkv_tpu_torch.kernels.vs_tile import (
        vs_tile_attention, vs_tok_attention_reference,
    )

    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 6)
    b, s, h, kh, dh, block = 1, 4096, 8, 2, HEAD_DIM_96, 128
    q, k, v = (torch.randn(b, s, n, dh, device=DEVICE, generator=gen,
                           dtype=torch.bfloat16) for n in (h, kh, kh))
    outs = {
        "B": (causal_prefill_splash(q, k, v),
              causal_prefill_attention(q, k, v)),
        "C": (sparse_prefill_splash(q, k, v, 1024, 64),
              sparse_prefill_attention(q, k, v, 1024, 64)),
    }
    q_f, k_f, v_f = (flat_heads(t, s) for t in (q, k, v))
    kv_map = kv_map_of(b, kh, range(h), h // kh, DEVICE)
    n_blk = s // block
    col = (torch.rand(b * h, n_blk, device=DEVICE, generator=gen)
           < 0.3).int()
    diag = (torch.rand(b * h, n_blk, device=DEVICE, generator=gen)
            < 0.3).int()
    diag[:, 0] = 1
    v_idx = torch.randint(0, s, (b * h, 300), device=DEVICE, generator=gen,
                          dtype=torch.int32)
    kw = dict(block=block, scale=dh**-0.5, seq_len=s)
    outs["F"] = (vs_tile_attention(q_f, k_f, v_f, v_idx, diag, kv_map, **kw),
                 vs_tok_attention_reference(q_f, k_f, v_f, v_idx, diag,
                                            kv_map, **kw))
    meta = meta_from_flags(col, diag)
    outs["G"] = (vs_sparse_attention(
        q_f, k_f, v_f, meta.col_ids, meta.col_cnt, meta.col_flag,
        meta.diag_ids, meta.diag_cnt, kv_map, **kw),
                 vs_attention_reference(q_f, k_f, v_f, meta, kv_map, **kw))
    torch.cuda.synchronize()
    for name, (out, ref) in outs.items():
        if out.shape != ref.shape:
            raise AssertionError(f"head_dim 96 {name}: shape {out.shape}, "
                                 f"expected {ref.shape}")
        _check_rows(torch, f"head_dim 96 kernel {name}", out, ref, s)
    del q, k, v, q_f, k_f, v_f, outs
    torch.cuda.empty_cache()
    check_toy_engine(torch, head_dim=HEAD_DIM_96, settings=TOY_96_SETTINGS,
                     sparse_budget=TOY_96_BUDGET)


# ---------------------------------------------------------------------------
# The engine: a toy model against the CPU, then the slice at full width
# ---------------------------------------------------------------------------


TOY_VS = dict(prefill_pattern="vs", vs_vertical_size=64, vs_slash_size=50,
              vs_block=64, stream_sink=32, stream_window=128)
TOY_ROW = (("vertical_and_slash", 64, 50), "stream_llm", "dense",
           ("vertical_and_slash", 100, 120))
TOY_SETTINGS = (  # (label, cache mode, runtime settings)
    ("shadow fused", "shadow", dict(use_pallas=True)),
    ("shadow xla-gather", "shadow", dict(use_pallas=None)),
    ("offload fused", "shadow_offload", dict(use_pallas=True)),
    ("offload ring", "shadow_offload", dict(ring_gather=True)),
    ("full", "full", dict()),
    # The sparse prefills run the full cache: a shadow cache turns a
    # rounding difference of the prefill into a flipped chunk choice at a
    # near-tie (the slice runs drive them in shadow mode).
    ("stream prefill", "full", dict(prefill_pattern="stream",
                                    stream_window=128, stream_sink=32)),
    ("vs tile prefill", "full", dict(TOY_VS)),
    ("vs walk prefill", "full", dict(TOY_VS, vs_impl="walk",
                                     minference_patterns=TOY_ROW)),
    ("vs per-layer prefill", "full", dict(
        TOY_VS, minference_layer_patterns=(
            TOY_ROW, ("dense", "stream_llm", ("vertical_and_slash", 30, 50),
                      "stream_llm")))),
)
TOY_STEPS = 8


def _greedy_logits(torch, eng, ids, forced=None):
    """Last-position logits [B, 1 + TOY_STEPS, V] (f32, on the CPU) of the
    prefill and of TOY_STEPS decode steps, and the tokens fed [B,
    TOY_STEPS]: the greedy token of the previous logits (eager steps,
    ``_decode``), or ``forced`` (steps through the compiled step,
    ``decode_step``: on the card one eager step, its capture, then
    replays of the graph)."""
    logits, cache = eng.prefill(ids)
    out, fed = [logits[:, -1].float().cpu()], []
    for i in range(TOY_STEPS):
        tok = out[-1].argmax(-1) if forced is None else forced[:, i]
        fed.append(tok)
        if forced is None:
            logits = eng._decode(cache, tok.to(eng.device)[:, None])[:, -1]
        else:
            _, logits = eng.decode_step(cache, tok.to(eng.device))
        out.append(logits.float().cpu())
    return torch.stack(out, 1), torch.stack(fed, 1)


def check_toy_engine(torch, head_dim: int = 128, settings=TOY_SETTINGS,
                     sparse_budget: int = 128) -> None:
    """The port's engine on the card (kernels) against the same engine on
    the CPU (plain versions), same bf16 weights, prompt and sketch, for
    each decode strategy of ``settings``. The CPU decodes greedily; the card
    is fed the CPU's tokens, so every step compares logits of the same
    history, and the final cached chunk ids must be equal: slot by slot,
    or, when ``sparse_budget`` selects every landmark chunk, as one set per
    (layer, b, kv head), since the slot order then follows score near-ties
    and attention over the slots does not depend on it."""
    import numpy as np

    from shadowkv_tpu_torch.config import CacheConfig, RuntimeConfig
    from shadowkv_tpu_torch.core.lowrank import sketch
    from shadowkv_tpu_torch.models.engine import Engine
    from shadowkv_tpu_torch.models.params import init_synthetic_params
    from shadowkv_tpu_torch.models.registry import toy_config

    cfg = toy_config(dtype=torch.bfloat16, head_dim=head_dim,
                     hidden_size=4 * head_dim, num_heads=4, num_kv_heads=2,
                     intermediate_size=1024)
    params = init_synthetic_params(
        cfg, torch.Generator(device="cpu").manual_seed(SEED), scale=0.2,
        device="cpu")
    omega = sketch(cfg.num_kv_heads * cfg.head_dim, 64 + 32)
    ids = np.random.RandomState(SEED).randint(1, cfg.vocab_size, (2, 512))
    for label, mode, rt_kw in settings:
        if head_dim != 128:
            label = f"head_dim {head_dim}, {label}"
        cc = CacheConfig(mode=mode, max_length=544,
                         sparse_budget=sparse_budget, rank=64, chunk_size=16,
                         kv_quant="int8", outlier_chunks=4, gen_capacity=32)
        rt = RuntimeConfig(**{"prefill_pattern": "dense-splash", **rt_kw})
        engines = {dev: Engine(cfg, cc, rt, params, device=dev, sketch=omega)
                   for dev in ("cpu", DEVICE)}
        l_ref, fed = _greedy_logits(torch, engines["cpu"], ids)
        l_dev, _ = _greedy_logits(torch, engines[DEVICE], ids, forced=fed)
        n_graphs = len(engines[DEVICE]._steps._graphs)
        if n_graphs != 1:
            raise AssertionError(f"toy engine {label}: {n_graphs} captured "
                                 "decode graphs, expected 1")
        err = (l_dev - l_ref).abs().amax(dim=(0, 2))  # [1 + TOY_STEPS]
        # Prefill: two layers of bf16 activations rounded in another order
        # on each side (bf16 keeps 8 bits) plus the kernels' bf16 attention
        # probabilities: 2 % of the largest logit. Decode steps: 5 % of the
        # step's largest logit. The decode steps add up more roundings, and
        # cuSOLVER and the CPU's eigen-solver give different low-rank bases
        # (only U @ SV is unique), so most int8 U values and with them the
        # rebuilt keys differ; the log line shows both, and the full
        # baseline's decode steps, which have no low-rank factors.
        tol = torch.full_like(err, 0.05) * l_ref.abs().amax(dim=(0, 2))
        tol[0] = 0.02 * l_ref[:, 0].abs().max()
        # Where the CPU's top two logits are more than 2 * tol apart, logits
        # within tol give the same greedy token; closer ones are near-ties
        # (bf16 logits of this toy are 0.0625 apart, and its CPU greedy
        # run has margins of 0 and 1 ulp), which rounding may break either
        # way, so there only the logit bound holds.
        top2 = l_ref.topk(2, dim=-1).values
        margin = top2[..., 0] - top2[..., 1]
        decisive = margin > 2 * tol
        same = l_dev.argmax(-1) == l_ref.argmax(-1)
        c_ref, c_dev = engines["cpu"]._cache, engines[DEVICE]._cache
        same_ids, u_same = True, None
        if mode != "full":
            ids_ref, ids_dev = c_ref.cached_ids, c_dev.cached_ids.cpu()
            if c_ref.layout.select_sets == c_ref.layout.num_landmarks:
                ids_ref, ids_dev = ids_ref.sort(-1).values, ids_dev.sort(-1).values
            same_ids = torch.equal(ids_ref, ids_dev)
            u_same = float((c_ref.u == c_dev.u.cpu()).float().mean())
        ratio = err / tol
        log(f"[toy engine, {label}] max_abs_err / tol: prefill "
            f"{float(ratio[0]):.3f} ({float(err[0]):.3e} of "
            f"{float(tol[0]):.3e}), decode steps "
            f"{[round(float(r), 3) for r in ratio[1:]]}; greedy tokens agree "
            f"on {int(same.sum())} of {same.numel()}, on "
            f"{int(same[decisive].sum())} of {int(decisive.sum())} decisive "
            f"steps (smallest CPU top-2 margin {float(margin.min()):.4f}); "
            f"cached ids equal {same_ids}; int8 U values equal on "
            f"{u_same if u_same is None else round(u_same, 4)} of entries")
        if not ((err <= tol).all() and torch.isfinite(l_dev).all()):
            raise AssertionError(f"toy engine {label}: the card's logits "
                                 "disagree with the CPU's")
        if not (same[decisive].all() and same_ids):
            raise AssertionError(f"toy engine {label}: greedy tokens at a "
                                 "decisive step or cached ids differ from "
                                 "the CPU's")
        del engines


# (label, cache mode, decode runtime settings) of the slice runs; each
# offload run has an HBM twin with the same strategy.
SLICE_RUNS = (
    ("shadow", "shadow", dict(use_pallas=True)),
    ("shadow-ring", "shadow", dict(ring_gather=True)),
    ("offload-fused", "shadow_offload", dict(use_pallas=True)),
    ("offload-ring", "shadow_offload", dict(ring_gather=True)),
    ("full", "full", dict()),
    ("stream", "shadow", dict(use_pallas=True, prefill_pattern="stream",
                              **STREAM)),
    ("vs-tile", "shadow", dict(use_pallas=True, prefill_pattern="vs",
                               vs_impl="tile", **VS)),
    ("vs-walk", "shadow", dict(use_pallas=True, prefill_pattern="vs",
                               vs_impl="walk", **VS)),
)
# the prefill kernel of each prefill_pattern
PREFILL_KERNEL = {"stream": "sparse_prefill_attention",
                  "tile": "vs_tile_attention", "walk": "vs_sparse_attention"}
OFFLOAD_TWINS = {"offload-fused": "shadow", "offload-ring": "shadow-ring"}


def _counters():
    from shadowkv_tpu_torch.kernels.gather import gather_chunks, gather_v_rows
    from shadowkv_tpu_torch.kernels.prefill_attention import (
        causal_prefill_offset,
        causal_prefill_splash,
        sparse_prefill_splash,
    )
    from shadowkv_tpu_torch.kernels.reconstruct import sparse_refresh
    from shadowkv_tpu_torch.kernels.vs_sparse import vs_sparse_attention
    from shadowkv_tpu_torch.kernels.vs_tile import vs_tile_attention

    return {
        "prefill_attention_offset": (causal_prefill_offset, "launches"),
        "sparse_refresh": (sparse_refresh, "launches"),
        "sparse_refresh_host_v": (sparse_refresh, "host_launches"),
        "prefill_attention": (causal_prefill_splash, "launches"),
        "sparse_prefill_attention": (sparse_prefill_splash, "launches"),
        "gather_chunks": (gather_chunks, "launches"),
        "gather_chunks_host_v": (gather_chunks, "host_launches"),
        "vs_tile_attention": (vs_tile_attention, "launches"),
        "vs_sparse_attention": (vs_sparse_attention, "launches"),
        "gather_v_rows": (gather_v_rows, "launches"),
    }


EAGER_STEPS = 8  # the eager window and the graph window after the run


def _mutable_copy(cache):
    """A copy of the state a decode step writes (the stores it only reads
    are shared)."""
    import dataclasses

    if hasattr(cache, "k_buf"):
        return dataclasses.replace(
            cache, k_buf=cache.k_buf.clone(), v_buf=cache.v_buf.clone(),
            cached_ids=cache.cached_ids.clone(), gen_len=cache.gen_len.clone())
    return dataclasses.replace(cache, k=cache.k.clone(), v=cache.v.clone(),
                               length=cache.length.clone())


def _eager_window(torch, eng, cache, tok):
    """EAGER_STEPS greedy steps through ``_decode`` (one Python-issued op
    at a time, as before the compiled step); returns (tokens [n, B], ms per
    step)."""
    from shadowkv_tpu_torch.core.sampling import sample_token

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = []
    for _ in range(EAGER_STEPS):
        tok = sample_token(eng._decode(cache, tok[:, None])[:, -1])
        out.append(tok)
    torch.cuda.synchronize()
    return torch.stack(out).cpu(), (time.perf_counter() - t0) / EAGER_STEPS * 1e3


def decode_kernel(mode: str, rt_kw: dict):
    """The kernel a decode step of this path launches once per layer
    (None: the XLA-gather branch by tensor indexing, or the full cache)."""
    if mode == "full":
        return None
    if rt_kw.get("use_pallas"):
        return "sparse_refresh"
    if rt_kw.get("ring_gather"):
        return "gather_chunks"
    return "gather_v_rows" if mode == "shadow_offload" else None


def run_slice(torch, cfg, params, label: str, mode: str, rt_kw: dict,
              prompt_len: int, cache_kw: dict | None = None) -> dict:
    """One Engine run at full width through batch_generate (every decode
    step after the first replays the captured step); returns its numbers,
    the kernel launch counts of the run (counted through the replays), its
    tokens and its final cached chunk ids. Then, from the state the run
    left: EAGER_STEPS eager steps on a copy of the cache (the eager tok/s)
    and as many steps through the same graph on the cache itself
    (``decode_chunk``), which must give the eager steps' tokens and cached
    ids and launch the decode kernel once per layer and step; the full
    cache runs its eager window on the cache itself. ``cache_kw``
    overrides fields of the headline cache config."""
    import numpy as np

    from shadowkv_tpu_torch.config import CacheConfig, RuntimeConfig
    from shadowkv_tpu_torch.kernels.decode_attention import decode_attention
    from shadowkv_tpu_torch.kernels.select import select_slots
    from shadowkv_tpu_torch.models.engine import Engine

    cc = CacheConfig(**{**dict(mode=mode, max_length=prompt_len + 256,
                               sparse_budget=2048, rank=160, chunk_size=16,
                               kv_quant="int8", gen_capacity=256),
                        **(cache_kw or {})})
    rt = RuntimeConfig(**{"prefill_pattern": "dense-splash", **rt_kw},
                       track_hit_rate=True, pallas_auto_interval=4)
    eng = Engine(cfg, cc, rt, params, device=DEVICE)
    ids = np.random.RandomState(SEED).randint(1, cfg.vocab_size,
                                              (BATCH, prompt_len))
    counters = _counters()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn, attr in counters.values():
        setattr(fn, attr, 0)
    attn_before = decode_attention.launches
    select_before = select_slots.launches
    toks, stats = eng.batch_generate(ids, gen_len=GEN_LEN, temperature=0.0,
                                     warmup_steps=WARMUP_STEPS)
    launches = {name: getattr(fn, attr)
                for name, (fn, attr) in counters.items()}
    attn_launches = decode_attention.launches - attn_before
    select_launches = select_slots.launches - select_before
    peak = torch.cuda.max_memory_allocated()
    kv = eng.kv_stats()
    steps = cfg.num_layers * (GEN_LEN + WARMUP_STEPS)
    sub_batches = math.ceil(BATCH / min(rt.prefill_sub_batch, BATCH))
    want = dict.fromkeys(counters, 0)
    pattern = rt.prefill_pattern
    prefill_kernel = PREFILL_KERNEL.get(
        rt.vs_impl if pattern == "vs" else pattern, "prefill_attention")
    want[prefill_kernel] = cfg.num_layers * sub_batches
    kernel = decode_kernel(mode, rt_kw)
    if kernel is not None:
        want[kernel] = steps
        if mode == "shadow_offload" and kernel != "gather_v_rows":
            want[kernel + "_host_v"] = steps
    if launches != want:
        raise AssertionError(f"slice {label}: kernel launches {launches}, "
                             f"expected {want}")
    # decode attention: the kernel at every layer and step, but on the
    # segmented path (tensor code)
    want_attn = 0 if rt_kw.get("decode_segmented") else steps
    if attn_launches != want_attn:
        raise AssertionError(f"slice {label}: {attn_launches} decode "
                             f"attention launches, expected {want_attn}")
    launches["decode_attention"] = attn_launches
    # selection: the kernel at every ShadowKV layer and step
    want_select = 0 if mode == "full" else steps
    if select_launches != want_select:
        raise AssertionError(f"slice {label}: {select_launches} selection "
                             f"launches, expected {want_select}")
    launches["select_slots"] = select_launches
    cache = eng._cache
    tok = eng._steps.tok.clone()
    res = dict(
        run=label, mode=mode, settings=rt_kw, prompt_len=prompt_len,
        batch=BATCH, gen_len=GEN_LEN,
        prefill_s=stats.prefill_seconds,
        decode_tok_s=stats.decode_tokens_per_second,
        decode_ms_per_step=stats.decode_seconds / GEN_LEN * 1e3,
        peak_gib=peak / 2**30, launches=launches,
        hit_rate_mean=kv.get("hit_rate_mean"),
        hit_samples=kv.get("hit_samples"),
        cache_gib=kv["device_bytes"] / 2**30,
        host_gib=kv["host_bytes"] / 2**30,
        graphs=len(eng._steps._graphs),
    )
    res["tokens"] = toks
    res["cached_ids"] = cache.cached_ids.cpu() if mode != "full" else None
    if mode == "full":
        _, eager_ms = _eager_window(torch, eng, cache, tok)
    else:
        copy = _mutable_copy(cache)
        eager_toks, eager_ms = _eager_window(torch, eng, copy, tok)
        fn, attr = counters[kernel] if kernel else (None, None)
        before = getattr(fn, attr) if kernel else 0
        zeros = torch.zeros(EAGER_STEPS, BATCH, dtype=torch.int32,
                            device=DEVICE)
        _, graph_toks = eng.decode_chunk(cache, tok, zeros, zeros.bool())
        replayed = getattr(fn, attr) - before if kernel else None
        same_toks = torch.equal(graph_toks, eager_toks)
        same_ids = torch.equal(cache.cached_ids, copy.cached_ids)
        res.update(graph_eq_eager_tokens=same_toks,
                   graph_eq_eager_cached_ids=same_ids,
                   graph_window_launches=replayed)
        del copy
        if not (same_toks and same_ids):
            raise AssertionError(f"slice {label}: {EAGER_STEPS} graph steps "
                                 "and eager steps from one state differ")
        if kernel and replayed != cfg.num_layers * EAGER_STEPS:
            raise AssertionError(f"slice {label}: {replayed} {kernel} "
                                 "launches counted through the replays of "
                                 f"{EAGER_STEPS} steps")
    res.update(eager_ms_per_step=eager_ms,
               eager_tok_s=BATCH / eager_ms * 1e3)
    log(f"[slice {label}] " + json.dumps(
        {k: v for k, v in res.items() if k not in ("tokens", "cached_ids")}))
    if toks.shape != (BATCH, GEN_LEN) or toks.min() < 0 \
            or toks.max() >= cfg.vocab_size:
        raise AssertionError(f"slice {label}: bad tokens {toks.shape}")
    if label == "shadow":
        check_sampling(torch, eng, cache, tok)
    del eng, cache
    torch.cuda.empty_cache()
    return res


def check_sampling(torch, eng, cache, tok) -> None:
    """Temperature sampling through the graph: EAGER_STEPS steps at
    temperature 0.6 (one eager step, its capture, then replays, each of
    which must advance the generator): some step's tokens differ from the
    previous step's, all within the vocabulary."""
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    zeros = torch.zeros(EAGER_STEPS, BATCH, dtype=torch.int32, device=DEVICE)
    _, toks = eng.decode_chunk(cache, tok, zeros, zeros.bool(), generator=gen,
                               temperature=0.6)
    changed = int((toks[2:] != toks[1:-1]).any(dim=1).sum())
    log(f"[sampling] temperature 0.6 through the graph: tokens "
        f"{toks.T.tolist()}; {changed} of {EAGER_STEPS - 2} replayed steps "
        "differ from the step before")
    if changed == 0 or toks.min() < 0 or toks.max() >= eng.model.vocab_size:
        raise AssertionError("sampled tokens are frozen across replays or "
                             "out of range")


SWEEP_RATES = (0.0, 0.25, 0.5, 0.75, 0.9)
SWEEP_STEPS = 16  # timed replays per (rate, branch)
SWEEP_CHUNKS = (16, 8)


def _shadow_engine(torch, cfg, params, chunk_size: int, **rt_kw):
    from shadowkv_tpu_torch.config import CacheConfig, RuntimeConfig
    from shadowkv_tpu_torch.models.engine import Engine

    cc = CacheConfig(mode="shadow", max_length=PROMPT_LEN + 256,
                     sparse_budget=2048, rank=160, chunk_size=chunk_size,
                     kv_quant="int8", gen_capacity=256)
    rt = RuntimeConfig(prefill_pattern="dense-splash", **rt_kw)
    return Engine(cfg, cc, rt, params, device=DEVICE)


def _crossover(rows) -> float:
    """The lowest forced hit rate from which the fused refresh is faster at
    every swept rate above (linear between the two rates around the last
    sign change); 0.0 when it wins at every rate, 1.0 when it never wins
    at the highest."""
    wins = [r["fused"] < r["xla-gather"] for r in rows]
    if all(wins):
        return 0.0
    if not wins[-1]:
        return 1.0
    i = max(j for j, w in enumerate(wins) if not w) + 1
    a, b = rows[i - 1], rows[i]
    da = a["fused"] - a["xla-gather"]
    db = b["fused"] - b["xla-gather"]
    return a["rate"] + (b["rate"] - a["rate"]) * da / (da - db)


def crossover_sweep(torch, cfg, params, chunk_size: int) -> float:
    """The fused refresh (kernel A) against the XLA-gather branch (tensor
    indexing, no ring) at forced slot hit rates (``debug_hit_rate``,
    scatter layout) on one prefill at full width: for each rate and branch
    two warm steps (one eager step and the capture of the new rate's
    graph, one replay), then SWEEP_STEPS timed replays (one host sync).
    Prints ms per step for each (rate, branch); returns the crossover."""
    import numpy as np

    eng = _shadow_engine(torch, cfg, params, chunk_size, use_pallas=True)
    ids = np.random.RandomState(SEED).randint(1, cfg.vocab_size,
                                              (BATCH, PROMPT_LEN))
    logits, cache = eng.prefill(ids)
    tok = logits[:, -1].argmax(-1).int()
    warm = torch.zeros(2, BATCH, dtype=torch.int32, device=DEVICE)
    timed = torch.zeros(SWEEP_STEPS, BATCH, dtype=torch.int32, device=DEVICE)
    rows = []
    for rate in SWEEP_RATES:
        eng.set_debug_hit_rate(rate)
        row = {"rate": rate}
        for branch in ("xla-gather", "fused"):
            eng._kernel_now = branch == "fused"  # the live path
            tok, _ = eng.decode_chunk(cache, tok, warm, warm.bool())
            t0 = time.perf_counter()
            tok, _ = eng.decode_chunk(cache, tok, timed, timed.bool())
            row[branch] = (time.perf_counter() - t0) / SWEEP_STEPS * 1e3
        rows.append(row)
    cross = _crossover(rows)
    log(f"[crossover chunk {chunk_size}] ms/step by forced hit rate (graph "
        f"replay, {PROMPT_LEN} x {BATCH}): {json.dumps(rows)}; the fused "
        f"refresh is faster from hit rate {cross:.3f}")
    del eng, cache
    torch.cuda.empty_cache()
    return cross


def run_auto(torch, cfg, params) -> None:
    """``use_pallas="auto"`` on the shadow path at full width with the
    default threshold: batch_generate (the warmup captures both paths),
    then the switch count and the split of the step's decode kernel
    launches (kernel A on the fused path; the XLA-gather branch without
    ring launches none of the port's kernels)."""
    import numpy as np

    from shadowkv_tpu_torch.kernels.reconstruct import sparse_refresh

    eng = _shadow_engine(torch, cfg, params, 16, use_pallas="auto")
    ids = np.random.RandomState(SEED).randint(1, cfg.vocab_size,
                                              (BATCH, PROMPT_LEN))
    sparse_refresh.launches = 0
    toks, stats = eng.batch_generate(ids, gen_len=GEN_LEN, temperature=0.0,
                                     warmup_steps=WARMUP_STEPS)
    kv = eng.kv_stats()
    fused_steps = sparse_refresh.launches / cfg.num_layers
    res = dict(threshold=eng._hit_threshold,
               auto_switches=kv["auto_switches"],
               auto_kernel_now=kv["auto_kernel_now"],
               auto_hit_ema=kv["auto_hit_ema"], graphs=len(eng._steps._graphs),
               fused_steps=fused_steps,
               xla_gather_steps=GEN_LEN + WARMUP_STEPS - fused_steps,
               decode_tok_s=stats.decode_tokens_per_second)
    log(f"[auto] {json.dumps(res)}")
    if res["graphs"] != 2 or fused_steps != int(fused_steps) \
            or not 1 <= fused_steps <= GEN_LEN + WARMUP_STEPS \
            or toks.shape != (BATCH, GEN_LEN):
        raise AssertionError(f"auto run: {res}")
    del eng
    torch.cuda.empty_cache()


# --- continuous batching (serving.py) ------------------------------------

SERVE_STEPS = 64  # run_serve's steps: gen lengths staggered up to it
                 # (profile_slice.serve_requests)
SERVE_SUFFIX = 16  # serve-ctx: random suffix after the shared context
SERVE_CTX_GEN = 32
SERVE_DISPATCH = 16  # max_dispatch: the fixed decode chunk
SERVE_RUNS = (  # (label, cache mode, shared context)
    ("serve-plain", "shadow", False),
    ("serve-ctx", "shadow", True),
    ("serve-offload", "shadow_offload", False),
)
# (label, request uid) held to an oracle run with the serve run's shapes
SERVE_ORACLES = {"serve-plain": (0, 2), "serve-ctx": (2,)}


def _serve_engine(cfg, params, mode: str, prompt_len: int, **cache_kw):
    from shadowkv_tpu_torch.config import CacheConfig, RuntimeConfig
    from shadowkv_tpu_torch.models.engine import Engine

    kw = dict(mode=mode, max_length=prompt_len + 128, sparse_budget=2048,
              rank=160, chunk_size=16, kv_quant="int8", gen_capacity=256)
    cc = CacheConfig(**{**kw, **cache_kw})
    rt = RuntimeConfig(use_pallas=True, prefill_pattern="dense-splash",
                       prefill_sub_batch=1)
    return Engine(cfg, cc, rt, params, device=DEVICE)


def serve_oracle(eng, r, cont_chunk: int = 1):
    """Request ``r`` on its own with the serve run's shapes: the request
    duplicated over the engine's two slots (one-sequence prefills), slot
    0's greedy tokens; a context request as its prefix through
    ``generate`` and its suffix through ``generate(cont=True)``."""
    import numpy as np

    if r.context_id is None:
        toks, _ = eng.generate(np.stack([r.input_ids] * 2), gen_len=r.gen_len)
        return toks[0]
    p, suf = r.input_ids[:r.context_len], r.input_ids[r.context_len:]
    eng.generate(np.stack([p] * 2), gen_len=1)
    toks, _ = eng.generate(np.stack([suf] * 2), gen_len=r.gen_len, cont=True,
                           cont_chunk=cont_chunk)
    return toks[0]


def check_serve_run(torch, eng, reqs, label: str, offload: bool,
                    layers: int) -> tuple[dict, object]:
    """One ContinuousBatcher run on 2 slots (greedy, chunk SERVE_DISPATCH)
    with every kernel count set to 0 just before and read just after:
    counters, exact launches (B once per layer and one-sequence prefill, A
    once per layer and decode step, counted through the replays), one
    captured decode graph across every admission, and the per-slot depth
    vector still the tensor the graph reads. Returns (numbers, results)."""
    import dataclasses

    from shadowkv_tpu_torch.serving import ContinuousBatcher

    counters = _counters()
    cb = ContinuousBatcher(eng, slots=BATCH, steps_per_dispatch="auto",
                           max_dispatch=SERVE_DISPATCH)
    torch.cuda.synchronize()
    for fn, attr in counters.values():
        setattr(fn, attr, 0)
    results, st = cb.run(reqs)
    launches = {name: getattr(fn, attr)
                for name, (fn, attr) in counters.items()}
    steps = eng._steps
    shared = reqs[0].context_id is not None
    prefills = BATCH + st.admissions - st.context_hits
    want = dict.fromkeys(counters, 0)
    want["prefill_attention"] = layers * prefills
    want["sparse_refresh"] = layers * st.decode_steps
    if offload:
        want["sparse_refresh_host_v"] = layers * st.decode_steps
    res = dict(run=label, **dataclasses.asdict(st),
               served_tok_s=st.tokens_per_second,
               decode_tok_s=st.decode_tokens_per_second,
               decode_s=st.decode_seconds,
               ms_per_admission=st.admission_seconds / max(1, st.admissions)
               * 1e3,
               captures=steps.captures, graphs=len(steps._graphs),
               launches=launches,
               gen_lens=[r.gen_len for r in reqs])
    log(f"[{label}] " + json.dumps(res))
    gen_len = eng._cache.gen_len
    checks = {
        "completed_requests": st.completed_requests == len(reqs),
        "admissions": st.admissions == len(reqs) - BATCH,
        "completed_tokens": st.completed_tokens == sum(r.gen_len for r in reqs),
        "launches": launches == want,
        # one path, captured plain and as its marked twin
        "one capture": steps.captures == 2 and len(steps._graphs) == 1,
        "depth vector": gen_len is steps.position
        and tuple(gen_len.shape) == (BATCH,),
    }
    if shared:
        checks["context_hits"] = st.context_hits == len(reqs) - BATCH
        checks["forced_tokens"] = st.forced_tokens == sum(
            len(r.input_ids) - r.context_len for r in reqs)
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        raise AssertionError(f"{label}: {bad} failed (launches {launches}, "
                             f"expected {want})")
    return res, results


def static_baseline(torch, eng, reqs, label: str) -> dict:
    """``bench.py`` ``run_serve``'s static baseline: the stream in fixed
    batches of 2 through ``batch_generate`` at each batch's longest gen
    length (no warmup steps; prefix only for context requests), useful
    tokens over the wall time of the whole loop, prefills included."""
    import numpy as np

    useful = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for r0 in range(0, len(reqs), BATCH):
        batch = reqs[r0:r0 + BATCH]
        ids = np.stack([r.input_ids[:r.context_len or len(r.input_ids)]
                        for r in batch])
        eng.batch_generate(ids, gen_len=max(r.gen_len for r in batch),
                           temperature=0.0, warmup_steps=0)
        useful += sum(r.gen_len for r in batch)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    res = dict(run=label, static_wall_s=wall, useful_tokens=useful,
               static_tok_s=useful / wall)
    log(f"[{label} static] " + json.dumps(res))
    return res


def run_serving(torch, cfg, params) -> dict:
    """The three serve runs at full width (32768-token prompts, 2 slots, 4
    requests): for each the static baseline on a fresh engine, then the
    serve run on another (its checks in ``check_serve_run``), then the
    oracle runs of SERVE_ORACLES on a third, whose greedy tokens must
    equal the served ones. Returns the numbers of each run."""
    import numpy as np

    from shadowkv_tpu_torch.tools.profile_slice import serve_requests

    out = {}
    for label, mode, shared in SERVE_RUNS:
        reqs = serve_requests(
            cfg.vocab_size, shared, 2 * BATCH, PROMPT_LEN,
            SERVE_CTX_GEN if shared else SERVE_STEPS, SERVE_SUFFIX, SEED)
        eng = _serve_engine(cfg, params, mode, PROMPT_LEN)
        static = static_baseline(torch, eng, reqs, label)
        del eng
        torch.cuda.empty_cache()
        eng = _serve_engine(cfg, params, mode, PROMPT_LEN)
        res, results = check_serve_run(torch, eng, reqs, label,
                                       mode == "shadow_offload",
                                       cfg.num_layers)
        del eng
        torch.cuda.empty_cache()
        res.update(static, served_over_static=res["served_tok_s"]
                   / static["static_tok_s"])
        for uid in SERVE_ORACLES.get(label, ()):
            eng = _serve_engine(cfg, params, mode, PROMPT_LEN)
            want = serve_oracle(eng, reqs[uid])
            del eng
            torch.cuda.empty_cache()
            same = np.array_equal(results[uid], want)
            log(f"[{label} oracle] request {uid}: served "
                f"{results[uid].tolist()}, oracle {want.tolist()}, equal "
                f"{same}")
            if not same:
                raise AssertionError(f"{label}: request {uid}'s served tokens "
                                     "differ from its oracle run")
        log(f"[{label}] served {res['served_tok_s']:.2f} tok/s, decode-only "
            f"{res['decode_tok_s']:.2f} tok/s, static "
            f"{static['static_tok_s']:.2f} tok/s, served/static "
            f"{res['served_over_static']:.3f}")
        out[label] = res
    return out


TOY_SERVE_GEN = [6, 9, 4, 7, 5]  # tests/test_torch_serving.py's stream


def check_toy_serving(torch) -> None:
    """The CPU serving tests' shapes on the card (``tests/torch_toy.py``'s
    model: head_dim 128, 2 layers; bf16, since kernels A and B serve bf16
    only): the 5-request stream at chunk 3 and a 4-request shared-prefix
    stream, each request's greedy tokens equal to its oracle run on the
    card with the serve run's shapes (``serve_oracle``)."""
    import numpy as np

    from shadowkv_tpu_torch.models.params import init_synthetic_params
    from shadowkv_tpu_torch.models.registry import toy_config
    from shadowkv_tpu_torch.serving import ContinuousBatcher, Request

    cfg = toy_config(dtype=torch.bfloat16, head_dim=128, hidden_size=512,
                     num_heads=4, num_kv_heads=2, intermediate_size=1024)
    params = init_synthetic_params(
        cfg, torch.Generator(device="cpu").manual_seed(SEED), scale=0.2,
        device="cpu")
    kw = dict(max_length=544, sparse_budget=128, outlier_chunks=4,
              gen_capacity=32)

    def engine():
        return _serve_engine(cfg, params, "shadow", 512, **kw)

    rng = np.random.RandomState(SEED)
    prompts = rng.randint(1, cfg.vocab_size, (len(TOY_SERVE_GEN), 512))
    plain = [Request(uid=i, input_ids=prompts[i], gen_len=g)
             for i, g in enumerate(TOY_SERVE_GEN)]
    prefix = rng.randint(1, cfg.vocab_size, 512)
    ctx = [Request(uid=i, input_ids=np.concatenate(
        [prefix, rng.randint(1, cfg.vocab_size, 3)]), gen_len=6,
        context_id=0, context_len=512) for i in range(4)]
    for label, reqs, chunk in (("plain", plain, 3), ("prefix", ctx, "auto")):
        results, st = ContinuousBatcher(
            engine(), slots=2, steps_per_dispatch=chunk).run(reqs)
        same = {r.uid: bool(np.array_equal(results[r.uid],
                                           serve_oracle(engine(), r, 16)))
                for r in reqs}
        log(f"[toy serving, {label}] {st}; tokens equal to the oracle "
            f"{same}")
        if not all(same.values()) or st.completed_requests != len(reqs):
            raise AssertionError(f"toy serving {label}: served tokens differ "
                                 "from the oracle runs")


# --- entry points (models/llm.py, entry/e2e.py, context checkpoints, HF) ---

ENTRY_NAME = "meta-llama/Llama-3.1-8B-Instruct"  # registry: llama31_8b
ENTRY_CONT = 32  # greedy tokens continued from a loaded context
LOGITS_LEN = 4096  # the one-sequence prompt of the logit comparisons
# int8 against bf16 weights: the relative RMS error of the last-token
# prefill logits. On synthetic N(0, 0.02) weights it grows with the width
# at a fixed depth: 0.039 / 0.058 / 0.110 at widths 512 / 1024 / 2048 and
# 32 layers (tools/wquant_error.py on the CPU), 1.5-1.9x a doubling, so
# ~0.16-0.21 at 4096 (the card, later: 0.049 / 0.061 / 0.118 / 0.262 at
# 512-4096, vocab 4096). The bound leaves room above that and stays far
# below the ~1.4 of unrelated logits (a wrong scale axis or layout).
INT8_LOGIT_RMS_BOUND = 0.30
HF_LAYERS = 2  # the HF file's depth (full width; 32 layers would be 16 GB)


def _entry_dir():
    """A scratch directory inside the checkout's gitignored build dir."""
    d = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                     "shadowkv_tpu_torch", "build", "entry")
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    return d


def _reset_counts(counters) -> None:
    for fn, attr in counters.values():
        setattr(fn, attr, 0)


def _read_counts(counters) -> dict:
    return {name: getattr(fn, attr) for name, (fn, attr) in counters.items()}


def _expect(label: str, got: dict, **want) -> None:
    full = dict.fromkeys(got, 0)
    full.update(want)
    if got != full:
        raise AssertionError(f"{label}: kernel launches {got}, expected {full}")


def _release(torch) -> None:
    """Return the memory of objects the caller has just deleted."""
    import gc

    gc.collect()
    torch.cuda.empty_cache()


def _rel_rms(torch, a, b) -> float:
    return float(torch.linalg.vector_norm((a - b).float())
                 / torch.linalg.vector_norm(b.float()))


def run_e2e(torch, cfg, counters) -> tuple[dict, object]:
    """``entry/e2e.py::measure`` through ``LLM`` on synthetic weights (no
    model_dir): full baseline then shadow (chunk 8, the XLA-gather branch:
    e2e's defaults, budget 2048), batch 2 each, PROMPT_LEN seeded token
    rows, GEN_LEN tokens at temperature 0.6. Then an ``Engine`` built
    directly from the same seed's params and the shadow LLM's configs must
    give the LLM's tokens. Returns (numbers, that engine's bf16 prefill
    logits of a LOGITS_LEN prompt)."""
    import numpy as np

    from shadowkv_tpu_torch.entry import e2e
    from shadowkv_tpu_torch.models.engine import Engine
    from shadowkv_tpu_torch.models.llm import SYNTHETIC_SEED
    from shadowkv_tpu_torch.models.params import init_synthetic_params

    rows = np.random.RandomState(SEED).randint(1, cfg.vocab_size,
                                               (BATCH, PROMPT_LEN))
    runs = {}
    _reset_counts(counters)
    res = e2e.measure(ENTRY_NAME, rows, rows, sparse_budget=2048,
                      gen_len=GEN_LEN, temperature=0.6, device=DEVICE,
                      datalen=f"{PROMPT_LEN // 1024}k", runs=runs)
    launches = _read_counts(counters)
    # B once per layer in each of the two prefills; the XLA-gather branch
    # and the full decode launch none of the port's kernels.
    _expect("e2e", launches, prefill_attention=2 * cfg.num_layers)
    sh = runs["shadowkv"]
    res.update(prefill_s={k: r["stats"].prefill_seconds
                          for k, r in runs.items()}, launches=launches)
    gen = torch.Generator(device=DEVICE).manual_seed(SYNTHETIC_SEED)
    params = init_synthetic_params(cfg, gen, device=DEVICE)
    eng = Engine(sh["model"], sh["cache"], sh["rt"], params, device=DEVICE)
    toks, _ = eng.batch_generate(rows, gen_len=GEN_LEN, temperature=0.6)
    same = np.array_equal(toks, sh["out"])
    res["llm_eq_engine_tokens"] = same
    log(f"[entry e2e] {json.dumps(res)}")
    if not same:
        raise AssertionError("e2e: the shadow LLM's tokens differ from an "
                             "Engine's on the same params, configs and seed")
    logits = eng.prefill(rows[:1, :LOGITS_LEN])[0]
    del eng, params
    _release(torch)
    return res, logits


def _headline_llm(mode: str = "shadow"):
    from shadowkv_tpu_torch.models.llm import LLM

    return LLM(ENTRY_NAME, batch_size=BATCH, max_length=PROMPT_LEN + 256,
               attn_mode=mode, sparse_budget=2048, rank=160, chunk_size=16,
               kv_quant="int8", use_pallas=True, weight_quant="int8",
               device=DEVICE)


def run_int8_and_context(torch, cfg, counters, bf16_logits,
                         shadow_run: dict) -> dict:
    """The headline cache with int8 weights through ``LLM``: batch_generate
    (A and B launches exact), decode tok/s and peak GiB beside the slice's
    bf16-weight shadow run, prefill logits held to the bf16-weight ones.
    Then context checkpoints at PROMPT_LEN x BATCH: prefill + 1 greedy
    step, ``save_context``, ENTRY_CONT tokens continued on the same LLM
    (the uninterrupted run); a fresh LLM loads the file and continues
    (A), and a ``shadow_offload`` LLM loads it, V going to the pinned host
    store, and continues (A reading host V): both give the uninterrupted
    tokens."""
    import numpy as np

    rows = np.random.RandomState(SEED).randint(1, cfg.vocab_size,
                                               (BATCH, PROMPT_LEN))
    llm = _headline_llm()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts(counters)
    toks, tok_s = llm.batch_generate(rows, gen_len=GEN_LEN, temperature=0.0)
    launches = _read_counts(counters)
    _expect("int8 weights", launches, prefill_attention=cfg.num_layers,
            sparse_refresh=cfg.num_layers * (GEN_LEN + WARMUP_STEPS))
    res = dict(decode_tok_s=tok_s, peak_gib=torch.cuda.max_memory_allocated()
               / 2**30, prefill_s=llm.stats.prefill_seconds,
               launches=launches,
               bf16_decode_tok_s=shadow_run["decode_tok_s"],
               bf16_peak_gib=shadow_run["peak_gib"])
    if toks.shape != (BATCH, GEN_LEN):
        raise AssertionError(f"int8 weights: tokens {toks.shape}")
    lq = llm.engine.prefill(rows[:1, :LOGITS_LEN])[0]
    res["logit_rel_rms"] = _rel_rms(torch, lq, bf16_logits)
    res["logit_argmax_equal"] = bool(
        (lq.argmax(-1) == bf16_logits.argmax(-1)).all())
    log(f"[entry int8 weights] {json.dumps(res)}")
    if not res["logit_rel_rms"] < INT8_LOGIT_RMS_BOUND:
        raise AssertionError(f"int8 weights: prefill logits {res['logit_rel_rms']:.4f}"
                             f" relative RMS from bf16 weights, bound "
                             f"{INT8_LOGIT_RMS_BOUND}")

    path = os.path.join(_entry_dir(), "ctx.npz")
    head = llm.generate(rows, gen_len=2)
    prefill_s = llm.stats.prefill_seconds
    t0 = time.perf_counter()
    llm.save_context(path)
    save_s = time.perf_counter() - t0
    want = llm.generate(head[:, 1:], gen_len=ENTRY_CONT, cont=True)
    ctx = dict(file_gib=os.path.getsize(path) / 2**30, save_s=save_s,
               prefill_s=prefill_s)
    del llm
    _release(torch)
    for label, mode, kernel in (("shadow", "shadow", "sparse_refresh"),
                                ("offload", "shadow_offload",
                                 "sparse_refresh_host_v")):
        llm = _headline_llm(mode)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        llm.load_context(path)
        torch.cuda.synchronize()
        ctx[f"load_s_{label}"] = time.perf_counter() - t0
        _reset_counts(counters)
        got = llm.generate(head[:, 1:], gen_len=ENTRY_CONT, cont=True)
        launches = _read_counts(counters)
        want_counts = {kernel: cfg.num_layers * ENTRY_CONT}
        if mode == "shadow_offload":
            want_counts["sparse_refresh"] = cfg.num_layers * ENTRY_CONT
        _expect(f"context {label}", launches, **want_counts)
        ctx[f"equal_{label}"] = bool(np.array_equal(got, want))
        del llm
        _release(torch)
        if not ctx[f"equal_{label}"]:
            raise AssertionError(f"context {label}: the resumed tokens "
                                 f"{got.tolist()} differ from the "
                                 f"uninterrupted {want.tolist()}")
    os.remove(path)
    log(f"[entry context] {json.dumps(ctx)}")
    res["context"] = ctx
    return res


def run_hf_load(torch, cfg) -> dict:
    """HF checkpoint loading at full width, depth cut to HF_LAYERS: this
    script writes ``config.json`` (LlamaForCausalLM, llama3 rope scaling)
    and two bf16 safetensors shards in HF's [out, in] layout with an index;
    ``LLM(model_dir=...)`` loads them through the port's reader. Checks: the
    config equals the registry's at that depth, every param bit-equal to
    the written arrays (transposed and fused), the prefill logits equal to
    an ``Engine``'s over params built from the arrays, and the int8 load
    equal to ``quantize_params`` of the bf16 load."""
    import dataclasses

    import numpy as np

    from shadowkv_tpu_torch.config import CacheConfig, RuntimeConfig
    from shadowkv_tpu_torch.core.layers import LayerParams, ModelParams
    from shadowkv_tpu_torch.core.wquant import QTensor, quantize_params
    from shadowkv_tpu_torch.models.engine import Engine
    from shadowkv_tpu_torch.models.llm import LLM, load_tokenizer
    from shadowkv_tpu_torch.models.params import write_safetensors
    from shadowkv_tpu_torch.models.registry import llama31_8b

    want_cfg = dataclasses.replace(llama31_8b(ENTRY_NAME),
                                   num_layers=HF_LAYERS)
    d, kv, i = cfg.hidden_size, cfg.kv_size, cfg.intermediate_size
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 1)

    def rnd(*shape, mean=0.0):
        t = torch.empty(shape, dtype=torch.bfloat16, device=DEVICE)
        return t.normal_(mean, 0.02, generator=gen)

    hf = {"model.embed_tokens.weight": rnd(cfg.vocab_size, d)}
    for layer in range(HF_LAYERS):
        p = f"model.layers.{layer}."
        hf.update({
            p + "input_layernorm.weight": rnd(d, mean=1.0),
            p + "self_attn.q_proj.weight": rnd(cfg.q_size, d),
            p + "self_attn.k_proj.weight": rnd(kv, d),
            p + "self_attn.v_proj.weight": rnd(kv, d),
            p + "self_attn.o_proj.weight": rnd(d, cfg.q_size),
            p + "post_attention_layernorm.weight": rnd(d, mean=1.0),
            p + "mlp.gate_proj.weight": rnd(i, d),
            p + "mlp.up_proj.weight": rnd(i, d),
            p + "mlp.down_proj.weight": rnd(d, i),
        })
    hf["model.norm.weight"] = rnd(d, mean=1.0)
    hf["lm_head.weight"] = rnd(cfg.vocab_size, d)
    out_dir = _entry_dir()
    t0 = time.perf_counter()
    names = list(hf)
    shards = {"model-00001-of-00002.safetensors": names[:len(names) // 2],
              "model-00002-of-00002.safetensors": names[len(names) // 2:]}
    total = 0
    for shard, keys in shards.items():
        total += write_safetensors(os.path.join(out_dir, shard),
                                   {k: hf[k] for k in keys})
    with open(os.path.join(out_dir, "model.safetensors.index.json"), "w") as f:
        json.dump({"metadata": {"total_size": total}, "weight_map": {
            k: shard for shard, keys in shards.items() for k in keys}}, f)
    with open(os.path.join(out_dir, "config.json"), "w") as f:
        json.dump({
            "architectures": ["LlamaForCausalLM"],
            "hidden_size": d, "intermediate_size": i,
            "num_hidden_layers": HF_LAYERS,
            "num_attention_heads": cfg.num_heads,
            "num_key_value_heads": cfg.num_kv_heads,
            "head_dim": cfg.head_dim, "vocab_size": cfg.vocab_size,
            "rope_theta": cfg.rope_theta, "rms_norm_eps": cfg.rms_norm_eps,
            "max_position_embeddings": cfg.max_position_embeddings,
            "rope_scaling": cfg.rope_scaling_dict,
            "tie_word_embeddings": False, "torch_dtype": "bfloat16"}, f)
    write_s = time.perf_counter() - t0

    def stack(fn):
        return torch.stack([fn(f"model.layers.{n}.") for n in
                            range(HF_LAYERS)])

    want = ModelParams(
        embed=hf["model.embed_tokens.weight"],
        layers=LayerParams(
            attn_norm=stack(lambda p: hf[p + "input_layernorm.weight"]),
            wqkv=stack(lambda p: torch.cat(
                [hf[p + f"self_attn.{x}_proj.weight"].T for x in "qkv"], 1)),
            bqkv=None,
            wo=stack(lambda p: hf[p + "self_attn.o_proj.weight"].T),
            mlp_norm=stack(
                lambda p: hf[p + "post_attention_layernorm.weight"]),
            w_gate_up=stack(lambda p: torch.cat(
                [hf[p + "mlp.gate_proj.weight"].T,
                 hf[p + "mlp.up_proj.weight"].T], 1)),
            w_down=stack(lambda p: hf[p + "mlp.down_proj.weight"].T)),
        final_norm=hf["model.norm.weight"],
        lm_head=hf["lm_head.weight"].T.contiguous(),
    )
    del hf
    res = dict(layers=HF_LAYERS, file_gib=total / 2**30, write_s=write_s)
    load_tokenizer(out_dir, ENTRY_NAME)  # pay any transformers import here
    llms = {}
    for quant in ("none", "int8"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        llms[quant] = LLM(ENTRY_NAME, max_length=LOGITS_LEN + 64,
                          model_dir=out_dir, weight_quant=quant,
                          device=DEVICE)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        res[f"load_s_{quant}"] = sec
        res[f"load_gb_s_{quant}"] = total / sec / 1e9
    llm = llms["none"]
    got_cfg = dataclasses.asdict(llm.config)
    res["config_eq_registry"] = got_cfg == dataclasses.asdict(want_cfg)

    def leaves(p):
        out = []
        for x in (p.embed, *p.layers, p.final_norm, p.lm_head):
            if isinstance(x, QTensor):
                out += [x.q, x.s]
            elif x is not None:
                out.append(x)
        return out

    got = llm.engine.params
    res["params_bit_equal"] = all(
        a.dtype == b.dtype and torch.equal(a, b)
        for a, b in zip(leaves(got), leaves(want)))
    res["int8_eq_quantize_params"] = all(
        torch.equal(a, b) for a, b in zip(
            leaves(llms["int8"].engine.params), leaves(quantize_params(got))))
    eng = Engine(want_cfg, llm.cache_cfg, RuntimeConfig(), want,
                 device=DEVICE)
    ids = np.random.RandomState(SEED).randint(1, cfg.vocab_size,
                                              (1, LOGITS_LEN))
    res["logits_eq_engine"] = bool(torch.equal(
        llm.engine.prefill(ids)[0], eng.prefill(ids)[0]))
    log(f"[entry hf] {json.dumps(res)}")
    del llm, llms, eng, want, got
    _release(torch)
    shutil.rmtree(out_dir)
    bad = [k for k in ("config_eq_registry", "params_bit_equal",
                       "int8_eq_quantize_params", "logits_eq_engine")
           if not res[k]]
    if bad:
        raise AssertionError(f"HF loading: {bad} failed")
    return res


def run_entry_points(torch, cfg, shadow_run: dict) -> dict:
    """The entry-points phase at full width; each LLM holds its own
    weights and is freed before the next."""
    counters = _counters()
    t0 = time.perf_counter()
    e2e_res, bf16_logits = run_e2e(torch, cfg, counters)
    int8_res = run_int8_and_context(torch, cfg, counters, bf16_logits,
                                    shadow_run)
    del bf16_logits
    hf_res = run_hf_load(torch, cfg)
    out = dict(e2e=e2e_res, int8=int8_res, hf=hf_res,
               seconds=time.perf_counter() - t0)
    log(f"[entry] phase {out['seconds']:.1f} s")
    return out


TRAIN_TINY_STEPS = 200  # dense-phase steps of the tiny oracle's curriculum
TRAIN_LOSS_MARGIN = 1.0  # nats the last 20 steps' mean loss must fall by
TRAIN_LOSS_RTOL = 1e-5  # step 0 on the card against the CPU: the loss
TRAIN_GRAD_RMS = 1e-4  # and each leaf's gradient (relative RMS)
TRAIN_PARITY_CTX, TRAIN_PARITY_CHUNK = 96, 32
BENCH_TRAIN_STEPS = 3
BENCH_TRAIN_CTX, BENCH_TRAIN_BATCH = 2048, 2
TEXT_MODEL = "tiny-llama-trained"  # the JAX archive's model name ("base")
TEXT_CTX = 4096
TEXT_BUCKET = 1024  # eval_acc's default prompt bucket
TEXT_SHADOW = dict(sparse_budget=512, rank=64, chunk_size=8)  # the archive's
TEXT_HIT_STEPS = 64  # greedy steps of the hit-rate run


def _train_dir():
    d = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                     "shadowkv_tpu_torch", "build", "train")
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    return d


def check_train_step_parity(torch) -> dict:
    """Step 0 of the tiny trainer on the card against the same step on the
    CPU at a 2-layer narrow config (hidden 128, 4 / 2 heads of 32, vocab
    512, f32, N(0, 0.1) weights), ctx 96 at query chunks of 32: the loss
    within TRAIN_LOSS_RTOL relative, every leaf's gradient within
    TRAIN_GRAD_RMS relative RMS. A planted control runs the card's step
    again with TF32 products (``set_float32_matmul_precision("high")``):
    its largest gradient gap must exceed TRAIN_GRAD_RMS, else the bound
    could not see the device rounding it is there for."""
    import numpy as np

    from shadowkv_tpu_torch.models.params import init_synthetic_params
    from shadowkv_tpu_torch.models.registry import toy_config
    from shadowkv_tpu_torch.tools import train_tiny_model as tt

    cfg = toy_config(dtype=torch.float32)
    rng = np.random.RandomState(SEED)
    ids = rng.randint(0, cfg.vocab_size, (2, TRAIN_PARITY_CTX))
    mask = rng.choice([0, 1, 1, 1, 2], (2, TRAIN_PARITY_CTX))
    prec = torch.get_float32_matmul_precision()
    got = {}
    for run, dev in (("cpu", "cpu"), ("card", DEVICE), ("tf32", DEVICE)):
        params = init_synthetic_params(
            cfg, torch.Generator().manual_seed(SEED), scale=0.1,
            device="cpu").to(dev)
        tr = tt.tiny_trainer(cfg, params, 7e-4, 1500, TRAIN_PARITY_CTX,
                             chunk=TRAIN_PARITY_CHUNK)
        torch.set_float32_matmul_precision("high" if run == "tf32" else prec)
        try:
            loss, _, _, grads = tr.grads(ids, mask)
        finally:
            torch.set_float32_matmul_precision(prec)
        got[run] = (float(loss), [g.cpu() for g in grads])
    names = [n for n, _ in tt.named_leaves(params)]
    l_cpu, g_cpu = got["cpu"]
    res = dict(f32_matmul_precision=prec)
    for run in ("card", "tf32"):
        l_dev, g_dev = got[run]
        rms = {n: _rel_rms(torch, a, b)
               for n, a, b in zip(names, g_dev, g_cpu)}
        res[run] = dict(loss_rel=abs(l_dev - l_cpu) / abs(l_cpu),
                        grad_rel_rms_max=max(rms.values()),
                        grad_rel_rms=rms)
    log(f"[train parity] {json.dumps(res)}")
    card, tf32 = res["card"], res["tf32"]
    if card["loss_rel"] > TRAIN_LOSS_RTOL or (
            card["grad_rel_rms_max"] > TRAIN_GRAD_RMS):
        raise AssertionError(
            f"train parity: the card's step 0 is off the CPU's beyond "
            f"{TRAIN_LOSS_RTOL} / {TRAIN_GRAD_RMS}: {res}")
    if tf32["grad_rel_rms_max"] <= TRAIN_GRAD_RMS:
        raise AssertionError(
            f"train parity: TF32 products read {tf32['grad_rel_rms_max']}, "
            f"within the {TRAIN_GRAD_RMS} gradient bound: {res}")
    return res


def run_train_tiny(torch) -> tuple[dict, str]:
    """``train-tiny``: the tokenizer and the initial checkpoint
    (``tools/make_tiny_checkpoint.py``) in the gitignored build directory,
    the card-against-CPU step check, then the first TRAIN_TINY_STEPS steps
    of ``tools/train_tiny_model.py``'s curriculum at its defaults (dense
    recall at ctx 256, batch 32, AdamW at lr 7e-4 over the 1500-step
    schedule) on the full-width 6 x 1024 oracle; every loss finite, the
    mean of the last 20 at least TRAIN_LOSS_MARGIN below the first 20's;
    steps/s, peak GiB and the dense-recall probe. The trained weights are
    written back for the text phase; returns (numbers, the checkpoint)."""
    import numpy as np

    from shadowkv_tpu_torch.models.params import save_hf_checkpoint
    from shadowkv_tpu_torch.tools import train_tiny_model as tt
    from shadowkv_tpu_torch.tools.make_tiny_checkpoint import (
        build_tiny_checkpoint,
    )

    t0 = time.perf_counter()
    tiny = build_tiny_checkpoint(os.path.join(_train_dir(), "tiny"))
    res = dict(build_s=time.perf_counter() - t0,
               parity=check_train_step_parity(torch))
    tokenizer, cfg, params = tt.load_for_training(tiny, DEVICE)
    tr = tt.tiny_trainer(cfg, params, 7e-4, 1500, 4096)
    kind, ctx, batch, _ = tt.curriculum(1500, 4096, 2)[0]
    rng = np.random.RandomState(SEED)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, data_s = [], 0.0
    t0 = time.perf_counter()
    for _ in range(TRAIN_TINY_STEPS):
        t1 = time.perf_counter()
        ids, mask = tt.make_samples_dense(tokenizer, batch, ctx,
                                          seed=int(rng.randint(0, 2**31)))
        data_s += time.perf_counter() - t1
        losses.append(tr.step(ids, mask)[0])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    losses = torch.stack(losses).cpu().numpy()
    res.update(kind=kind, ctx=ctx, batch=batch, steps=TRAIN_TINY_STEPS,
               wall_s=wall, steps_per_s=TRAIN_TINY_STEPS / wall,
               data_s=data_s,
               peak_gib=torch.cuda.max_memory_allocated() / 2**30,
               loss_first20=float(losses[:20].mean()),
               loss_last20=float(losses[-20:].mean()),
               loss_every20=[float(x) for x in losses[::20]])
    res["dense_acc"] = tt.retrieval_acc(tr, tokenizer, 16, ctx,
                                        seed=7_000_000, kind=kind)
    log(f"[train-tiny] {json.dumps(res)}")
    if not np.isfinite(losses).all():
        raise AssertionError(f"train-tiny: non-finite loss {losses}")
    if res["loss_last20"] > res["loss_first20"] - TRAIN_LOSS_MARGIN:
        raise AssertionError(
            f"train-tiny: the loss fell from {res['loss_first20']:.4f} to "
            f"{res['loss_last20']:.4f}, less than {TRAIN_LOSS_MARGIN}")
    save_hf_checkpoint(params, cfg, tiny)
    del tr, params
    _release(torch)
    return res, tiny


def run_train_bench(torch, tokenizer) -> dict:
    """``train-bench``: BENCH_TRAIN_STEPS Adafactor steps of
    ``tools/train_bench_weights.py`` on the full-width 1.4B bf16 model
    (16 layers, d 2048) at ctx 2048, batch 2, alternating dense recall and
    the heterogeneous stream as the tool does; ms per step (each ending in
    a synchronize), peak GiB, every loss finite."""
    import numpy as np

    from shadowkv_tpu_torch.models.params import init_synthetic_params
    from shadowkv_tpu_torch.tools import train_bench_weights as tb
    from shadowkv_tpu_torch.tools.train_tiny_model import make_samples_dense

    cfg = tb.bench_model_config()
    params = init_synthetic_params(
        cfg, torch.Generator(device=DEVICE).manual_seed(SEED), device=DEVICE)
    tr = tb.bench_trainer(cfg, params, 3e-4, 400, BENCH_TRAIN_CTX)
    het = tb.build_prompt_stream(tokenizer, 8 * BENCH_TRAIN_CTX, SEED + 17)
    rng = np.random.RandomState(SEED)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_ms, losses = [], []
    for step in range(BENCH_TRAIN_STEPS):
        if step % 2:
            ids, mask = tb.het_batch(het, rng, BENCH_TRAIN_BATCH,
                                     BENCH_TRAIN_CTX)
        else:
            ids, mask = make_samples_dense(tokenizer, BENCH_TRAIN_BATCH,
                                           BENCH_TRAIN_CTX,
                                           seed=int(rng.randint(0, 2**31)))
        t0 = time.perf_counter()
        loss, _, _ = tr.step(ids, mask)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss))
    res = dict(params_b=sum(t.numel() for t in tr.leaves) / 1e9,
               step_ms=step_ms, losses=losses,
               peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    log(f"[train-bench] {json.dumps(res)}")
    del tr, params
    _release(torch)
    if not np.isfinite(losses).all():
        raise AssertionError(f"train-bench: non-finite loss {losses}")
    return res


def run_text(torch, model_dir: str) -> dict:
    """``text``: the train-tiny checkpoint and its tokenizer through
    ``LLM(model_dir=...)`` on the card (bf16), one RULER niah_single_1
    sample at TEXT_CTX built by ``data/dataset.py`` with the port's
    template and eval_acc's prompt bucket, greedy ``generate`` with the eval harness's gen_len and stop
    tokens: shadow at the archive's settings (fused refresh) and full.
    Kernel launches counted around each ``generate`` (B once per layer;
    under shadow A once per layer and decode step); the decoded string and
    its score; then TEXT_HIT_STEPS greedy steps without stops on the shadow
    LLM give the organic slot hit rate."""
    from shadowkv_tpu_torch.data.dataset import Dataset
    from shadowkv_tpu_torch.models.llm import LLM

    counters = _counters()
    res = {}
    for mode in ("shadow", "full"):
        kw = dict(TEXT_SHADOW, use_pallas=True, track_hit_rate=True) \
            if mode == "shadow" else {}
        llm = LLM(TEXT_MODEL, model_dir=model_dir,
                  max_length=TEXT_CTX + 2048, attn_mode=mode, device=DEVICE,
                  **kw)
        if llm.tokenizer is None:
            raise AssertionError("text: the checkpoint's tokenizer did not "
                                 "load")
        ds = Dataset("ruler/niah_single_1", llm.tokenizer, TEXT_CTX, 1,
                     bucket=TEXT_BUCKET)
        ids = ds.tokenized_prompts[0][None]
        layers = llm.config.num_layers
        _reset_counts(counters)
        text = llm.generate(ids, gen_len=ds.gen_len)[0]
        launches = _read_counts(counters)
        steps = llm.stats.decode_tokens
        want = dict(prefill_attention=layers)
        if mode == "shadow":
            want["sparse_refresh"] = layers * steps
        _expect(f"text {mode}", launches, **want)
        truth = ds.gt[0][0] if len(ds.gt[0]) == 1 else ds.gt[0]
        r = dict(prompt_tokens=int(ids.shape[1]), text=text,
                 truth=truth, score=ds.metric(text, truth),
                 decode_steps=steps, launches=launches,
                 prefill_s=llm.stats.prefill_seconds)
        if mode == "shadow":
            llm.engine.batch_generate(ids, gen_len=TEXT_HIT_STEPS,
                                      temperature=0.0)
            st = llm.engine.kv_stats()
            r.update(hit_rate_mean=st.get("hit_rate_mean"),
                     hit_samples=st.get("hit_samples"))
        log(f"[text {mode}] {json.dumps(r)}")
        if not isinstance(text, str) or not text.strip():
            raise AssertionError(f"text {mode}: nothing decoded ({text!r})")
        res[mode] = r
        del llm
        _release(torch)
    return res


def run_training_phases(torch) -> dict:
    """train-tiny, train-bench and text, on the card."""
    from transformers import AutoTokenizer

    t0 = time.perf_counter()
    tiny, tiny_dir = run_train_tiny(torch)
    tokenizer = AutoTokenizer.from_pretrained(tiny_dir, local_files_only=True)
    bench = run_train_bench(torch, tokenizer)
    text = run_text(torch, tiny_dir)
    shutil.rmtree(os.path.dirname(tiny_dir), ignore_errors=True)
    out = dict(tiny=tiny, bench=bench, text=text,
               seconds=time.perf_counter() - t0)
    log(f"[training] phases {out['seconds']:.1f} s")
    return out


def check_offload_twins(torch, runs: dict) -> None:
    """Each offload run against its HBM twin: the same V bytes in another
    place, so the same tokens and cached ids; a device cache smaller by
    the V store and a host store of its size."""
    for off, twin in OFFLOAD_TWINS.items():
        a, b = runs[off], runs[twin]
        same_toks = bool((a["tokens"] == b["tokens"]).all())
        same_ids = torch.equal(a["cached_ids"], b["cached_ids"])
        saved = b["cache_gib"] - a["cache_gib"]
        log(f"[offload {off} vs {twin}] tokens equal {same_toks}, cached ids "
            f"equal {same_ids}; device cache {a['cache_gib']:.3f} vs "
            f"{b['cache_gib']:.3f} GiB (-{saved:.3f}); host store "
            f"{a['host_gib']:.4f} GiB")
        if not (same_toks and same_ids):
            raise AssertionError(f"{off}: tokens or cached ids differ from "
                                 f"{twin}")
        if not (saved >= 1.9 and abs(a["host_gib"] / 1.99 - 1) <= 0.01):
            raise AssertionError(f"{off}: device cache not 1.9 GiB smaller or "
                                 "host store not 1.99 GiB")


# ---------------------------------------------------------------------------
# The last single-device settings: the HostVStore path, the segmented
# offload prefill, segmented decode attention, vs_sim
# ---------------------------------------------------------------------------


def check_gather_v_rows(torch, cfg, lay, link: float, layers: int = 32) -> dict:
    """``gather_v_rows`` (the HostVStore path's miss-only V gather) against
    its plain version at the slice's per-layer shapes (B 2, 8 KV heads,
    128 of 2040 chunks of 16 rows, bf16 V pinned on the host) with a forced
    stay mask that skips about half of the slots: bit-equal on the missed
    slots. Timed cycling over ``layers`` stacked layers (32: one pass reads
    136 MB of missed rows, 2.7x the L2, so none is found there and every
    row comes over the link); bound: the missed rows' bytes over the link rate
    this run measured (written once to the card)."""
    from shadowkv_tpu_torch.kernels.gather import (
        gather_v_rows,
        gather_v_rows_plain,
    )
    from shadowkv_tpu_torch.tools.time_refresh import cycle_layers, device_ms

    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 9)
    kh, dh, cs, s, c = (cfg.num_kv_heads, cfg.head_dim, lay.chunk_size,
                        lay.select_sets, lay.chunks)
    v = torch.randn(layers, BATCH, kh, c * cs, dh, device=DEVICE,
                    generator=gen, dtype=torch.bfloat16)
    ids = torch.stack([torch.randperm(c, device=DEVICE, generator=gen)[:s]
                       for _ in range(BATCH * kh)]).reshape(
                           BATCH, kh, s).to(torch.int32)
    stay = torch.rand(BATCH, kh, s, device=DEVICE, generator=gen) < 0.5
    v_host = pinned_copy(torch, v)
    layer = layers - 1
    ref = gather_v_rows_plain(layer, ids, stay, v, chunk_size=cs)
    out = gather_v_rows(layer, ids, stay, v_host, chunk_size=cs)
    torch.cuda.synchronize()
    miss = ~stay
    same = torch.equal(out[miss], ref[miss])
    err = float((out[miss].float() - ref[miss].float()).abs().max())
    n_miss = int(miss.sum())
    log(f"[gather_v_rows, V on host] {n_miss} of {stay.numel()} slots missed;"
        f" bit-equal to the plain version on them: {same}")
    if not same:
        raise AssertionError("gather_v_rows: kernel disagrees with its plain "
                             "version")
    ms = device_ms(cycle_layers(lambda lyr: gather_v_rows(
        lyr, ids, stay, v_host, chunk_size=cs), layers), reps=64)
    plain_ms = device_ms(cycle_layers(lambda lyr: gather_v_rows_plain(
        lyr, ids, stay, v, chunk_size=cs), layers), reps=16)
    miss_bytes = n_miss * cs * dh * 2
    b_ms, b_by = bound(miss_bytes, 0, miss_bytes, link)
    log(f"[gather_v_rows, V on host] kernel_ms {ms:.4f} plain_ms (V on the "
        f"card) {plain_ms:.4f} bound_ms {b_ms:.4f} ({b_by}: {miss_bytes} "
        f"missed bytes over {link / 1e9:.2f} GB/s; cycling over {layers} "
        f"layers) = {b_ms / ms:.0%} of bound")
    del v, v_host, ref, out
    torch.cuda.empty_cache()
    return dict(
        name="gather_v_rows", route="cuda",
        source="shadowkv_tpu_torch/csrc/gather.cu",
        replaces="port-own: shadowkv_tpu/cache/offload.py:77 (io_callback + "
                 "native/host_gather.cpp; no Pallas kernel)",
        launches=0, max_abs_err=err, ms=ms, plain_ms=plain_ms,
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
    )


def check_vs_sim_flags(torch, cfg) -> dict:
    """The MInference flags of one layer at the slice's shape (B*H 64, S
    32768, random q/k/v): estimated, and simulated from the same estimate
    (``sim_vs_scores``, salt 31, the port's draws). Mean diagonal blocks per
    head of each, and kernel F's ms on each."""
    from shadowkv_tpu_torch.core import minference as mi
    from shadowkv_tpu_torch.kernels import vs_tile

    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 10)
    b, s, h, kh, dh = BATCH, PROMPT_LEN, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = torch.randn(b, s, h, dh, device=DEVICE, generator=gen, dtype=torch.bfloat16)
    k = torch.randn(b, s, kh, dh, device=DEVICE, generator=gen, dtype=torch.bfloat16)
    v = torch.randn(b, s, kh, dh, device=DEVICE, generator=gen, dtype=torch.bfloat16)
    vert, sl = mi.estimate_vertical_slash(q, k)
    sets = {"estimated": (vert, sl),
            "clustered-sim": mi.sim_vs_scores("clustered", vert, sl, salt=31)}
    q_f, k_f, v_f = mi.flat_heads(q, s), mi.flat_heads(k, s), mi.flat_heads(v, s)
    del q, k, v
    kv_map = mi.kv_map_of(b, kh, range(h), h // kh, DEVICE)
    out = {}
    for label, (vt, st) in sets.items():
        v_idx, dflag, _, _ = _vs_inputs(torch, vt.reshape(b * h, s),
                                        st.reshape(b * h, s), s)
        diag = float(dflag.float().sum(-1).mean())
        ms = time_ms(torch, lambda: vs_tile.vs_tile_attention(
            q_f, k_f, v_f, v_idx, dflag, kv_map, block=VS["vs_block"],
            scale=dh**-0.5, seq_len=s), reps=3, warmup=1)
        log(f"[vs-sim flags {label}] mean diagonal blocks per head "
            f"{diag:.1f} of {s // VS['vs_block']}; F kernel_ms {ms:.4f}")
        out[label] = dict(diag_blocks=diag, f_ms=ms)
    del q_f, k_f, v_f, sets, vert, sl
    torch.cuda.empty_cache()
    return out


# The segmented check's bounds: the two attentions in f32 (relative to the
# largest output: f32 sums in another order), on one layer's buffers and
# inside the engine's segmented steps at every layer, and the engine's
# logits (of the step's largest |logit|: a last-bit difference in one
# layer's bf16 attention output grows through 32 layers of random weights;
# the toy engine check's decode-step bound). The same run reads the logit
# bound's noise floor (the stacked path with one layer's bf16 attention
# output moved by one ulp) and two planted faults of the segments, which
# must fail both bounds.
SEG_ATTN_TOL = 1e-5
SEG_STEP_TOL = 0.05
SEG_FAULTS = ("gen-mask-short", "sparse-dropped")


def _ulp_noise(torch, fn, num_layers: int, seed: int):
    """``fn`` (the stacked decode attention) with layer 0's bf16 output
    moved by one ulp, up or down at random, on every nonzero entry."""
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    calls = [0]

    def noisy(q, *args):
        out = fn(q, *args)
        first = calls[0] % num_layers == 0
        calls[0] += 1
        if not first:
            return out
        step = torch.randint(0, 2, out.shape, generator=gen, device=out.device,
                             dtype=torch.int16) * 2 - 1
        moved = (out.view(torch.int16) + step).view(out.dtype)
        return torch.where(out == 0, out, moved)

    return noisy


def _planted_fault(fn, fault: str):
    """``fn`` (the segmented decode attention) with a planted fault of the
    segments it is handed: the gen region's mask one row short (the newest
    token unseen), or the sparse segment dropped."""
    def faulty(q, segs, kv_len):
        if fault == "gen-mask-short":
            return fn(q, segs, kv_len - 1)
        return fn(q, (segs[0], segs[2]), kv_len)

    return faulty


def check_segmented_steps(torch, cfg, params) -> dict:
    """Segmented against stacked decode attention at full width (the
    headline cache, ring path, the slice's prompt), from one prefilled
    state:

    - the two functions in f32 on layer 0's compact buffers with random
      f32 queries and per-slot lengths that mask part of the gen region:
      equal within SEG_ATTN_TOL of the largest output (the segmented one
      sums P @ V per segment, then across segments);
    - EAGER_STEPS eager engine steps of each on copies of the state, both
      fed the stacked path's greedy tokens. The stacked steps run the
      plain version (``decode_attention_plain``), so both sides are the
      same f32 math summed in another order, as the segmented form is
      held to (the decode-attention kernel's own sums, checked in phase 8,
      move the bf16 outputs by about the noise floor below). At every
      layer of the
      segmented steps, the segments the engine hands the attention are
      held in f32 against the stacked attention over that layer's whole
      buffer, with the engine's query and lengths: within SEG_ATTN_TOL.
      The bf16 model rounds the two sums' last-bit differences otherwise,
      so on synthetic weights a free greedy run parts at the first
      near-tie; the logits must agree within SEG_STEP_TOL of the step's
      largest |logit| and the greedy token on every row whose top-two
      margin exceeds twice the difference;
    - the same teacher-forced steps of the controls: the stacked path with
      one ulp of noise on layer 0's attention output (the logit bound's
      noise floor; reported), and the segmented path with each planted
      fault of ``_planted_fault``, which must fail both the in-engine f32
      check and the logit bound."""
    import numpy as np

    from shadowkv_tpu_torch.config import CacheConfig, RuntimeConfig
    from shadowkv_tpu_torch.core.attention import (
        decode_attention_hm,
        decode_attention_segments,
    )
    from shadowkv_tpu_torch.kernels.decode_attention import (
        decode_attention_plain,
    )
    from shadowkv_tpu_torch.models import forward
    from shadowkv_tpu_torch.models.engine import Engine

    cc = CacheConfig(mode="shadow", max_length=PROMPT_LEN + 256,
                     sparse_budget=2048, rank=160, chunk_size=16,
                     kv_quant="int8", gen_capacity=256)
    eng = Engine(cfg, cc, RuntimeConfig(prefill_pattern="dense-splash",
                                        ring_gather=True), params,
                 device=DEVICE)
    ids = np.random.RandomState(SEED).randint(1, cfg.vocab_size,
                                              (BATCH, PROMPT_LEN))
    logits, cache = eng.prefill(ids)

    lo = cache.layout
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 11)
    q = torch.randn(BATCH, 1, cfg.num_heads, cfg.head_dim, device=DEVICE,
                    generator=gen)
    valid = torch.tensor([lo.sparse_end + 1, lo.sparse_end + 40],
                         device=DEVICE)
    k_l, v_l = cache.k_buf[0], cache.v_buf[0]
    ss, se = lo.sparse_start, lo.sparse_end
    segs = ((k_l[:, :, :ss], v_l[:, :, :ss], 0, False),
            (k_l[:, :, ss:se], v_l[:, :, ss:se], ss, False),
            (k_l[:, :, se:], v_l[:, :, se:], se, True))
    hm = decode_attention_plain(q, k_l, v_l, valid)
    attn_rel = float((decode_attention_segments(q, segs, valid) - hm).abs()
                     .max() / hm.abs().max())

    tok = logits[:, -1].argmax(-1).int()
    feeds = []

    def steps(seg: bool, fault: str | None = None, noise: bool = False):
        """EAGER_STEPS eager steps on a copy of the state, fed ``feeds``
        (the first run, stacked and plain, makes them). Returns (logits
        [steps, B, V], the in-engine f32 check's largest relative gap, or
        None on the stacked path)."""
        eng.decode_segmented = seg
        copy = _mutable_copy(cache)
        seg_fn = (decode_attention_segments if fault is None
                  else _planted_fault(decode_attention_segments, fault))
        calls, gaps = [0], []

        def witnessed(q, segs, kv_len):
            layer = calls[0] % cfg.num_layers
            calls[0] += 1
            whole = decode_attention_plain(q.float(), copy.k_buf[layer],
                                           copy.v_buf[layer], kv_len)
            gaps.append((seg_fn(q.float(), segs, kv_len) - whole).abs().max()
                        / whole.abs().max())
            return seg_fn(q, segs, kv_len)

        forward.decode_attention_segments = witnessed
        forward.decode_attention_hm = (
            _ulp_noise(torch, decode_attention_plain, cfg.num_layers,
                       SEED + 12) if noise else decode_attention_plain)
        try:
            t, rows = tok, []
            for i in range(EAGER_STEPS):
                lg = eng._decode(copy, t[:, None])[:, -1].float()
                rows.append(lg)
                if len(feeds) < EAGER_STEPS:
                    feeds.append(lg.argmax(-1).int())
                t = feeds[i]
        finally:
            forward.decode_attention_segments = decode_attention_segments
            forward.decode_attention_hm = decode_attention_hm
            eng.decode_segmented = False
        gap = float(torch.stack(gaps).max()) if gaps else None
        return torch.stack(rows), gap

    ref, _ = steps(False)
    got, gap = steps(True)

    def rel_of(x):  # [steps]
        return ((x - ref).abs().amax(-1) / ref.abs().amax(-1)).amax(-1)

    err = (got - ref).abs().amax(-1)  # [steps, B]
    rel = rel_of(got)
    top2 = ref.topk(2, dim=-1).values
    decisive = (top2[..., 0] - top2[..., 1]) > 2 * err
    agree = got.argmax(-1) == ref.argmax(-1)
    noise = rel_of(steps(False, noise=True)[0])
    faults = {}
    for f in SEG_FAULTS:
        lg, f_gap = steps(True, fault=f)
        faults[f] = dict(attn_gap=f_gap, rel_by_step=rel_of(lg).tolist())
    res = dict(attn_rel=attn_rel, engine_attn_gap=gap,
               max_err=float(err.max()), rel_by_step=rel.tolist(),
               decisive=int(decisive.sum()), rows=int(err.numel()),
               agree=int(agree.sum()),
               decisive_agree=bool(agree[decisive].all()),
               noise_by_step=noise.tolist(), faults=faults)
    def fmt(xs):
        return [f"{x:.2e}" for x in xs]

    log(f"[segmented decode] f32 attention on layer 0's buffers: max |diff| "
        f"{attn_rel:.3e} of the largest output; in the engine's segmented "
        f"steps, every layer: {gap:.3e} (tol {SEG_ATTN_TOL:.0e}); "
        f"{EAGER_STEPS} teacher-forced engine steps from one state: logits "
        f"max |diff| {res['max_err']:.4e}, by step of the largest |logit| "
        f"{fmt(res['rel_by_step'])} (tol {SEG_STEP_TOL}); greedy tokens "
        f"agree on {res['agree']} of {res['rows']} rows, on every one of "
        f"the {res['decisive']} decisive rows: {res['decisive_agree']}")
    log(f"[segmented decode] logit noise floor, stacked with one ulp on "
        f"layer 0's attention output: {fmt(res['noise_by_step'])}; "
        + "; ".join(f"planted fault {f}: in-engine f32 gap "
                    f"{v['attn_gap']:.3e}, logits {fmt(v['rel_by_step'])}"
                    for f, v in faults.items()))
    if not (attn_rel <= SEG_ATTN_TOL and gap <= SEG_ATTN_TOL
            and bool((rel <= SEG_STEP_TOL).all()) and res["decisive_agree"]):
        raise AssertionError("segmented decode attention disagrees with the "
                             "stacked view")
    for f, v in faults.items():
        if not (v["attn_gap"] > SEG_ATTN_TOL
                and max(v["rel_by_step"]) > SEG_STEP_TOL):
            raise AssertionError(f"the planted fault {f} passes a bound of "
                                 "the segmented check")
    del eng, cache
    torch.cuda.empty_cache()
    return res


# (label, cache mode, runtime settings, cache settings, the earlier run it
# is held against, whether its tokens and cached ids must be equal)
SETTING_RUNS = (
    ("offload-host", "shadow_offload", dict(), dict(kv_quant="none"),
     "shadow-bf16-gather", True),
    ("shadow-bf16-gather", "shadow", dict(), dict(kv_quant="none"), None,
     False),
    # offload-ring again, in the place before offload-seg4: the two run
    # the same prefill, so this pair reads what the order alone moves
    ("offload-ring-2", "shadow_offload", dict(ring_gather=True), {},
     "offload-ring", True),
    ("offload-seg4", "shadow_offload",
     dict(ring_gather=True, offload_prefill_segments=4), {}, "offload-ring-2",
     True),
    # another rounding order: held by check_segmented_steps instead
    ("ring-segmented", "shadow", dict(ring_gather=True, decode_segmented=True),
     {}, "shadow-ring", False),
    ("vs-sim", "shadow", dict(use_pallas=True, prefill_pattern="vs",
                              vs_impl="tile", vs_sim="clustered", **VS),
     {}, "vs-tile", False),
)
# 32 layers x 2 x 8 heads x 32640 rows x 128 x 2 bytes (bf16)
HOST_STORE_GIB = 32 * 2 * 8 * 32640 * 128 * 2 / 2**30


def run_settings(torch, cfg, params, runs: dict) -> dict:
    """The four settings at full width, each run as the slice's runs are
    (``run_slice``: launches exact through the replays, graph = eager
    tokens and cached ids), then held against an earlier run of this call:

    - offload-host: the bf16 V store pinned on the host, neither kernel:
      its tokens and cached ids bit-equal to the bf16 XLA-gather engine's
      on the card (the same V bytes in another place), its host store the
      3.98 GiB bf16 store;
    - offload-seg4: the segmented offload prefill (4 segments: the
      ordinary prefill over the whole batch, the store marked
      layer-sharded) against offload-ring (1), run again just before it
      (offload-ring-2, itself held against the slice's offload-ring): the
      same tokens and cached ids; prefill_s and peak GiB beside;
    - ring-segmented: segmented decode attention against shadow-ring's
      stacked view, ms per step beside; the two round otherwise, so the
      free-running tokens are compared for the record and the check is
      ``check_segmented_steps`` (f32 attention in the engine's steps,
      teacher-forced logits from one state, the controls);
    - vs-sim: vs_sim='clustered' against the estimated-flag vs-tile run:
      prefill_s and F's launches beside, the flags' diagonal blocks and
      F's ms from ``check_vs_sim_flags``."""
    t0 = time.perf_counter()
    new = {label: run_slice(torch, cfg, params, label, mode, rt_kw,
                            PROMPT_LEN, cache_kw)
           for label, mode, rt_kw, cache_kw, _, _ in SETTING_RUNS}
    both = {**runs, **new}
    for label, _, _, _, twin, exact in SETTING_RUNS:
        if twin is None:
            continue
        a, b = both[label], both[twin]
        same_toks = bool((a["tokens"] == b["tokens"]).all())
        same_ids = torch.equal(a["cached_ids"], b["cached_ids"])
        differ = (a["tokens"] != b["tokens"]).any(0).nonzero()[0]
        a["first_token_diff"] = int(differ[0]) if differ.size else None
        log(f"[setting {label} vs {twin}] tokens equal {same_toks} (first "
            f"differing step {a['first_token_diff']}), cached "
            f"ids equal {same_ids}; prefill_s {a['prefill_s']:.3f} vs "
            f"{b['prefill_s']:.3f}; peak {a['peak_gib']:.3f} vs "
            f"{b['peak_gib']:.3f} GiB; graph ms/step "
            f"{a['decode_ms_per_step']:.3f} vs {b['decode_ms_per_step']:.3f}; "
            f"tok/s {a['decode_tok_s']:.2f} (eager {a['eager_tok_s']:.2f}) vs "
            f"{b['decode_tok_s']:.2f}")
        if exact and not (same_toks and same_ids):
            raise AssertionError(f"{label}: tokens or cached ids differ from "
                                 f"{twin}")
    host = new["offload-host"]
    if abs(host["host_gib"] / HOST_STORE_GIB - 1) > 0.01 \
            or host["cache_gib"] > new["shadow-bf16-gather"]["cache_gib"] \
            - HOST_STORE_GIB + 0.01:
        raise AssertionError(f"offload-host: host store {host['host_gib']} "
                             f"GiB, device cache {host['cache_gib']} GiB")
    new["ring-segmented"]["teacher_forced"] = check_segmented_steps(
        torch, cfg, params)
    flags = check_vs_sim_flags(torch, cfg)
    new["vs-sim"]["flags"] = flags
    log(f"[settings] offload-host {host['decode_tok_s']:.2f} tok/s graph "
        f"({host['eager_tok_s']:.2f} eager), host {host['host_gib']:.3f} GiB,"
        f" peak {host['peak_gib']:.3f} GiB, gather_v_rows launches "
        f"{host['launches']['gather_v_rows']}; vs-sim diag blocks per head "
        f"{flags['clustered-sim']['diag_blocks']:.1f} (estimated "
        f"{flags['estimated']['diag_blocks']:.1f}), F ms "
        f"{flags['clustered-sim']['f_ms']:.3f} (estimated "
        f"{flags['estimated']['f_ms']:.3f}); phase "
        f"{time.perf_counter() - t0:.1f} s")
    return new


# ---------------------------------------------------------------------------
# Parallelism (parallel/): kernel B's offset form, tp1-nccl, 2-rank gloo
# ---------------------------------------------------------------------------


OFFSET_SQ, OFFSET_TK = 16384, 32768  # one sp rank's rows of a 32K prompt


def check_prefill_offset(torch, cfg) -> dict:
    """Kernel B's query-offset form (the sequence-parallel prefill's
    attention) against its plain version at S_q 16384 rows at key positions
    [16384, 32768) of T_k 32768, B 2, H 32 / KV 8, per row as B; timed,
    with SDPA under the explicit [S_q, T_k] offset mask as the library
    yardstick. The bound counts the active pairs only."""
    import torch.nn.functional as F

    from shadowkv_tpu_torch.core.attention import causal_prefill_attention
    from shadowkv_tpu_torch.kernels.prefill_attention import (
        causal_prefill_offset,
        prefill_tile_plan,
    )

    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 11)
    h, kh, dh, b = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, BATCH
    s_q, t_k = OFFSET_SQ, OFFSET_TK
    off = t_k - s_q
    q = torch.randn(b, s_q, h, dh, device=DEVICE, generator=gen,
                    dtype=torch.bfloat16)
    k = torch.randn(b, t_k, kh, dh, device=DEVICE, generator=gen,
                    dtype=torch.bfloat16)
    v = torch.randn(b, t_k, kh, dh, device=DEVICE, generator=gen,
                    dtype=torch.bfloat16)
    ref, plain_ms = _timed(
        torch, lambda: causal_prefill_attention(q, k, v, offset=off))
    out = causal_prefill_offset(q, k, v, off)
    torch.cuda.synchronize()
    err = float((out.float() - ref.float()).abs().max())
    rel = row_rel_err(torch, out, ref)
    # the same bound must reject the rows attended 128 keys early
    early = causal_prefill_attention(q[:, :512], k, v, offset=off - 128)
    bad = row_rel_err(torch, out[:, :512], early)
    log(f"[prefill-attn offset B={b} S_q={s_q} T_k={t_k} offset={off}] "
        f"max_abs_err {err:.3e}; per-row relative {rel:.3e} (tol "
        f"{ATTN_ROW_TOL:.3e}); the rows 128 keys early read {bad:.3e} "
        f"(rejected: {bad > ATTN_ROW_TOL})")
    if not (rel <= ATTN_ROW_TOL < bad):
        raise AssertionError("prefill attention offset: kernel disagrees "
                             "with its plain version, or the bound misses "
                             "a wrong offset")
    del ref, early
    ms = time_ms(torch, lambda: causal_prefill_offset(q, k, v, off), reps=3,
                 warmup=1)
    mask = (torch.arange(t_k, device=DEVICE)[None, :]
            <= off + torch.arange(s_q, device=DEVICE)[:, None])
    qh = q.transpose(1, 2)
    kr = k.transpose(1, 2).repeat_interleave(h // kh, dim=1)
    vr = v.transpose(1, 2).repeat_interleave(h // kh, dim=1)
    lib_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
        qh, kr, vr, attn_mask=mask), reps=3, warmup=1)
    del qh, kr, vr, mask
    pairs = b * h * (s_q * off + s_q * (s_q + 1) // 2)
    ops = 2 * 2 * dh * pairs
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * 2
    bnd, by = bound(nbytes, ops)
    plans = prefill_tile_plan(t_k, offset=off, q_len=s_q)
    visited = sum(len(p.full) + len(p.masked) for p in plans)
    log(f"[prefill-attn offset] kernel_ms {ms:.4f} plain_ms {plain_ms:.4f} "
        f"sdpa_mask_ms {lib_ms:.4f} bound_ms {bnd:.4f} ({by}; "
        f"{ops / ms / 1e9:.1f} TFLOP/s; {pairs} active pairs; {visited} "
        f"tiles visited per (b, h) of {len(plans) * (-(-t_k // 128))})")
    del q, k, v, out
    torch.cuda.empty_cache()
    return dict(
        name="prefill_attention_offset", route="cuda",
        source="shadowkv_tpu_torch/csrc/prefill_attention.cu",
        replaces="shadowkv_tpu/core/attention.py:501",
        launches=0, max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bnd,
        bound_by=by, library_ms=lib_ms)


PAR_PROMPT = 8192  # tp1-nccl
GLOO_PROMPT = 4096  # the 2-rank gloo phases: their prefill sums go by host
PAR_GEN = 32
PAR_CACHE = dict(mode="shadow", max_length=PAR_PROMPT, sparse_budget=2048,
                 rank=160, chunk_size=16, kv_quant="int8", gen_capacity=256)
# label -> (layers, mesh sizes, cache settings over PAR_CACHE, runtime
# settings). Each rank
# launches B (sp: its offset form) once per local layer per prefill, and
# its decode kernel (decode_kernel: A, D, A-host, E or gather_v_rows) once
# per local layer per decode step.
# The vs sizes of the gloo phases: the JAX defaults scaled to the 4096-token
# prompt (at 4096 the default 6144 slashes would keep every diagonal: a
# dense prefill)
VS_GLOO = dict(vs_vertical_size=128, vs_slash_size=768, vs_block=128)
PAR_PHASES = {
    "tp2-gloo": (16, dict(tp=2), {}, dict(use_pallas=True)),
    "dp2-gloo": (8, dict(dp=2), {}, dict(ring_gather=True)),
    "sp2-gloo": (8, dict(sp=2), {}, dict()),
    "pp2-gloo": (16, dict(pp=2), {}, dict()),
    "dp2-offload-ring-gloo": (8, dict(dp=2), dict(mode="shadow_offload"),
                              dict(ring_gather=True)),
    "tp2-offload-fused-gloo": (8, dict(tp=2), dict(mode="shadow_offload"),
                               dict(use_pallas=True)),
    # JAX's HostVStore path (offload-host in run_settings: bf16 V)
    "tp2-offload-host-gloo": (8, dict(tp=2), dict(mode="shadow_offload",
                                                  kv_quant="none"), dict()),
    # context checkpoints on a mesh (_context_phase)
    "tp2-context-gloo": (8, dict(tp=2), {}, dict(use_pallas=True)),
    "tp2-offload-fused-context-gloo": (8, dict(tp=2),
                                       dict(mode="shadow_offload"),
                                       dict(use_pallas=True)),
    # shared-prefix snapshots restored across dp shards (_serve_phase)
    "dp2-serve-ctx-gloo": (8, dict(dp=2), {}, dict(use_pallas=True,
                                                   prefill_sub_batch=1)),
    # the sparse prefills on a rank's 16 query heads: C, and F / G under
    # vs_sim (each rank its slice of one device's draws)
    "tp2-stream-gloo": (8, dict(tp=2), {}, dict(
        use_pallas=True, prefill_pattern="stream", stream_window=1024,
        stream_sink=64)),
    "tp2-vs-sim-gloo": (8, dict(tp=2), {}, dict(
        use_pallas=True, prefill_pattern="vs", vs_impl="tile",
        vs_sim="clustered", **VS_GLOO)),
    "tp2-vs-walk-sim-gloo": (8, dict(tp=2), {}, dict(
        use_pallas=True, prefill_pattern="vs", vs_impl="walk",
        vs_sim="clustered", **VS_GLOO)),
}
# phases that are not a greedy run against the single device's
# (_generate_phase): label -> (main-side function, rank-side function),
# filled in below their definitions
PAR_KIND: dict = {}
# Layer 0 of a rank's path in f32 (its shard of the weights cast to f32,
# the same seeded input rows, plain attention) against the single-device
# layer, relative to the largest |output|: f32 sums in another order. The
# planted fault (tp: the o_proj / MLP all-reduce left out; sp: the rows
# attended 64 keys early; dp: another shard's rows) must read above it.
# pp stages run whole layers of the single-device code: no such check.
PAR_F32_TOL = 1e-5
PAR_F32_ROWS = 1024
# Teacher-forced logits of the bf16 model against the single-device engine,
# relative to the largest |logit|: sums in another order round otherwise,
# and 32 layers of synthetic weights amplify one rounding into several
# percent (one ulp on layer 0's attention output moves them 5.95-7.61 %,
# check_segmented_steps' noise floor; tp phases read their own floor, the
# single device with each o_proj and MLP product taken as two bf16
# half-sums, _half_sums_tail), so this bound only catches a broken path;
# the f32 layer check and the tp cache checks below are the fine guards.
# The planted fault (one rank's wo and w_down zeroed in every local layer)
# must read above it. A tp phase is also held to the rank-shapes control,
# the single device with every GEMM at a tp=2 rank's shapes (column halves
# of wqkv, w_gate_up and the lm_head, row-half sums of wo and w_down:
# _rank_shapes_mat), which rounds as the ranks do: the ranks within
# PAR_CONTROL_RATIO times the half-sums floor of it, and every planted tp
# fault above that. (Against the single device itself a rounding of the
# column halves can flip a chunk selection that the half sums do not:
# tp2-stream-gloo read 0.1197 at step 4, the rank-shapes control 0.1195
# there, the half-sums floor 0.0388.)
PAR_LOGIT_TOL = 0.3
PAR_CONTROL_RATIO = 1.5
# tp cache checks: U (and its int8 scale) bit-equal across the tp ranks;
# with int8 stores, layer 0's V and landmark scales (computed from layer 0's K and V, whose
# inputs are the same on every rank) against the single device's head
# slice, relative to its largest value, within two bf16 ulps of a row's
# max; the same scales rolled by one head must read above it. The planted
# faults read against PAR_LOGIT_TOL over PAR_FAULT_STEPS teacher-forced
# steps: "svd-local" (the tp sketch SVD without its sums over tp: a rank's
# own factors, which the U check must reject) and "scales-rolled" (rank
# 1's V scales rolled by one head after the prefill).
PAR_SCALE_TOL = 2.0**-7
PAR_FAULT_STEPS = 8


def _par_config(cfg, layers: int):
    import dataclasses

    return dataclasses.replace(cfg, num_layers=layers)


def _par_params(torch, cfg, layers: int):
    """The slice's seeded weights, cut to their first ``layers`` layers."""
    from shadowkv_tpu_torch.core.layers import LayerParams
    from shadowkv_tpu_torch.models.params import init_synthetic_params

    p = init_synthetic_params(
        cfg, torch.Generator(device=DEVICE).manual_seed(SEED), device=DEVICE)
    if layers == cfg.num_layers:
        return p
    return p._replace(layers=LayerParams(*(
        None if x is None else x[:layers].clone() for x in p.layers)))


def _forced_logits(torch, eng, ids, tokens, steps: int = PAR_GEN - 1,
                   after_prefill=None):
    """Prefill logits [B, V] and the logits of ``steps`` decode steps fed
    ``tokens`` [B, PAR_GEN] (teacher forcing), f32 on the host, and the
    cache; ``after_prefill(cache)`` may change the cache first."""
    lg, cache = eng.prefill(ids)
    if after_prefill is not None:
        after_prefill(cache)
    out = [lg[:, -1].float().cpu()]
    for i in range(steps):
        tok = torch.as_tensor(tokens[:, i], dtype=torch.int32, device=DEVICE)
        _, step = eng.decode_step(cache, tok)
        out.append(step.float().cpu())
    return torch.stack(out), cache  # [steps + 1, B, V]


def _half_sums_tail(lp, model, x, ctx, tp=None, **_):
    """``forward._layer_tail`` on one device with the o_proj and MLP
    products each taken as two half-sums in the model dtype (the first and
    second halves of the heads and of the ffn) and added: the sums a tp=2
    all-reduce forms."""
    import torch
    import torch.nn.functional as F

    from shadowkv_tpu_torch.core.layers import rms_norm

    def halves(a, w):
        n = a.shape[-1] // 2
        return a[..., :n] @ w[:n] + a[..., n:] @ w[n:]

    b, s = ctx.shape[:2]
    x = x + halves(ctx.reshape(b, s, -1), lp.wo)
    h = rms_norm(x, lp.mlp_norm, model.rms_norm_eps)
    gate, up = torch.chunk(h @ lp.w_gate_up, 2, dim=-1)
    return x + halves(F.silu(gate.float()).to(x.dtype) * up, lp.w_down)


def _half_sums_control(torch, cfg, params, cache_kw, rt_kw, ids, tokens,
                       steps: int = PAR_GEN - 1):
    """The tp=2 noise floor of the teacher-forced logits: the single-device
    engine (eager steps) with ``_half_sums_tail``, [steps + 1, B, V]."""
    from shadowkv_tpu_torch.models import forward

    eng = _par_engine(torch, cfg, params, {}, rt_kw, cache_kw, eager=True)
    real = forward._layer_tail
    forward._layer_tail = _half_sums_tail
    try:
        logits, _ = _forced_logits(torch, eng, ids, tokens, steps)
    finally:
        forward._layer_tail = real
    del eng
    _release(torch)
    return logits.numpy()


def _rank_shapes_mat(cfg, real):
    """``wquant.mat`` with every product at a tp=2 rank's shapes: the
    column halves of wqkv, w_gate_up and the lm_head concatenated, the
    row-half products of wo and w_down summed in the model dtype (the
    tp=2 all-reduce)."""
    import torch

    cols = {(cfg.num_heads + 2 * cfg.num_kv_heads) * cfg.head_dim,
            2 * cfg.intermediate_size, cfg.vocab_size}
    rows = {(cfg.num_heads * cfg.head_dim, cfg.hidden_size),
            (cfg.intermediate_size, cfg.hidden_size)}

    def mat(x, w, out_dtype=None):
        k, n = w.shape[-2], w.shape[-1]
        if n in cols:
            return torch.cat([real(x, w[..., :n // 2].contiguous(), out_dtype),
                              real(x, w[..., n // 2:].contiguous(), out_dtype)],
                             dim=-1)
        if (k, n) in rows:
            y = (real(x[..., :k // 2].contiguous(), w[..., :k // 2, :].contiguous())
                 + real(x[..., k // 2:].contiguous(),
                        w[..., k // 2:, :].contiguous()))
            return y if out_dtype is None else y.to(out_dtype)
        return real(x, w, out_dtype)

    return mat


def _rank_shapes_control(torch, cfg, params, cache_kw, rt_kw, ids, tokens,
                         steps: int = PAR_GEN - 1):
    """The single-device engine (eager steps) with ``_rank_shapes_mat``:
    teacher-forced logits [steps + 1, B, V] rounded as a tp=2 mesh rounds
    them."""
    from shadowkv_tpu_torch.core import layers, wquant

    eng = _par_engine(torch, cfg, params, {}, rt_kw, cache_kw, eager=True)
    real = wquant.mat
    layers.mat = wquant.mat = _rank_shapes_mat(cfg, real)
    try:
        logits, _ = _forced_logits(torch, eng, ids, tokens, steps)
    finally:
        layers.mat = wquant.mat = real
    del eng
    _release(torch)
    return logits.numpy()


def _f32_attention(rt_kw: dict):
    """The phase's prefill attention in f32 through the plain versions of
    its kernels: ``attend(q, k, v, sim, offset)``, ``sim`` a rank's place
    in the ``vs_sim`` draws (None on one device)."""
    from shadowkv_tpu_torch.config import RuntimeConfig
    from shadowkv_tpu_torch.core import attention
    from shadowkv_tpu_torch.core import minference as mi
    from shadowkv_tpu_torch.kernels import vs_sparse, vs_tile
    from shadowkv_tpu_torch.models import forward as fw

    rt = RuntimeConfig(**rt_kw)
    if rt.prefill_pattern == "stream":
        return lambda q, k, v, sim, off: attention.sparse_prefill_attention(
            q, k, v, rt.stream_window, rt.stream_sink)
    if rt.prefill_pattern != "vs":
        return lambda q, k, v, sim, off: attention.causal_prefill_attention(
            q, k, v, offset=off)

    def walk(q, k, v, col_ids, col_cnt, col_flag, diag_ids, diag_cnt,
             kv_map, *, block, scale, seq_len):
        meta = mi.VSMeta(col_ids, col_cnt, col_flag, diag_ids, diag_cnt)
        return mi.vs_attention_reference(q, k, v, meta, kv_map, block,
                                         scale=scale, seq_len=seq_len)

    def attend(q, k, v, sim, off):
        real = vs_tile.vs_tile_attention, vs_sparse.vs_sparse_attention
        vs_tile.vs_tile_attention = vs_tile.vs_tok_attention_reference
        vs_sparse.vs_sparse_attention = walk
        try:
            return fw.prefill_attention(rt, 0, q, k, v, sim)
        finally:
            vs_tile.vs_tile_attention, vs_sparse.vs_sparse_attention = real

    return attend


def _f32_layer(torch, cfg, params, mesh, axes: dict, rt_kw: dict):
    """(relative error, planted fault's) of layer 0 of this rank's path in
    f32 against the single-device layer on the same input, with the
    phase's prefill attention (``_f32_attention``); see PAR_F32_TOL. pp
    stages: (None, None)."""
    import dataclasses

    from shadowkv_tpu_torch.core import minference as mi
    from shadowkv_tpu_torch.core.layers import Block, LayerParams
    from shadowkv_tpu_torch.core.rope import compute_cos_sin
    from shadowkv_tpu_torch.models import forward as fw
    from shadowkv_tpu_torch.parallel import mesh as mesh_lib

    if axes.get("pp"):
        return None, None
    one = params._replace(layers=LayerParams(*(
        None if t is None else t[:1] for t in params.layers)))
    cfg1 = dataclasses.replace(cfg, num_layers=1, dtype=torch.float32)
    local = mesh_lib.local_model(cfg1, mesh)
    sh = mesh_lib.shard_params(one, dataclasses.replace(cfg, num_layers=1),
                               mesh)

    def f32(p):
        return Block(*(None if t is None else t[0].float()
                       for t in p.layers))

    s = PAR_F32_ROWS
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 41)
    x = torch.randn(BATCH, s, cfg.hidden_size, device=DEVICE, generator=gen)
    cos, sin = compute_cos_sin(cfg1, s, dtype=torch.float32, device=DEVICE)

    attend = _f32_attention(rt_kw)

    def layer(model, lp, x, cos, sin, tp=None, sp=None, off=0, sim=None):
        q, k, _, v = fw._layer_qkv(model, lp, x, cos, sin)
        if sp is not None:
            k = mesh_lib.all_gather(k, sp, dim=1)
            v = mesh_lib.all_gather(v, sp, dim=1)
        ctx = attend(q.contiguous(), k.contiguous(), v.contiguous(), sim, off)
        return fw._layer_tail(lp, model, x, ctx, tp)

    ref = layer(cfg1, f32(one), x, cos, sin)
    lp = f32(sh)
    if axes.get("tp"):
        # the rank's heads of one device's vs_sim draws (one sub-batch)
        sim = mi.SimShard(batch=BATCH, sub=BATCH, row0=0,
                          heads=cfg.num_heads,
                          head0=mesh.head_slice(cfg.num_heads).start)
        got = layer(local, lp, x, cos, sin, tp=mesh.tp_group, sim=sim)
        bad = layer(local, lp, x, cos, sin, sim=sim)  # no all-reduces
    elif axes.get("sp"):
        n = s // mesh.sp
        off = mesh.coords["sp"] * n
        rows = slice(off, off + n)
        xl, c, sn = x[:, rows], cos[rows], sin[rows]
        sp_g = mesh.groups["sp"]
        got = layer(local, lp, xl, c, sn, sp=sp_g, off=off)
        # rank 0's rows cannot start earlier: they start 64 keys later
        bad = layer(local, lp, xl, c, sn, sp=sp_g,
                    off=off - 64 if off >= 64 else off + 64)
        ref = ref[:, rows]
    else:  # dp: this shard's rows
        rows = mesh.prefill_rows(BATCH)
        got = layer(local, lp, x[rows], cos, sin)
        other = slice((rows.stop % BATCH), (rows.stop % BATCH) + 1)
        bad = layer(local, lp, x[other], cos, sin)
        ref = ref[rows]
    scale = float(ref.abs().max())
    return (float((got - ref).abs().max()) / scale,
            float((bad - ref).abs().max()) / scale)


SCALES = ("v_scale", "lm_scale")


def _u_equal(torch, cache, mesh) -> bool:
    """Whether U and its scale are bit-equal on every tp rank."""
    from shadowkv_tpu_torch.parallel import mesh as mesh_lib

    same = True
    for t in (x for x in (cache.u, cache.u_scale) if x is not None):
        every = mesh_lib.all_gather(t[None].contiguous(), mesh.tp_group,
                                    dim=0)
        same &= all(torch.equal(every[0], x) for x in every[1:])
    return same


def _scale_errs(torch, cache, mesh, ref) -> tuple[dict, dict]:
    """Layer 0's V and landmark scales of this rank against the head slice
    of the single device's (``ref``), relative to its largest value; and
    the same with this rank's scales rolled by one head."""
    heads = mesh.head_slice(mesh.tp * cache.sv.shape[2])
    got, rolled = {}, {}
    for name in (n for n in SCALES if getattr(cache, n) is not None):
        want = torch.as_tensor(ref[name])[:, heads]
        mine = getattr(cache, name)[0].float().cpu()
        top = float(want.abs().max())
        got[name] = float((mine - want).abs().max()) / top
        rolled[name] = float((mine.roll(1, dims=1) - want).abs().max()) / top
    return got, rolled


def _tp_faults(torch, eng, ids, tokens, mesh, rank: int) -> dict:
    """The planted tp faults (PAR_SCALE_TOL's note): per fault, the
    teacher-forced logits [PAR_FAULT_STEPS + 1, B, V] and, for svd-local,
    whether U stayed bit-equal across the tp ranks."""
    import shadowkv_tpu_torch.cache.shadow as shadow_mod

    real = shadow_mod.lowrank_kv_factors
    t = mesh.coords["tp"]

    def svd_local(k, rank_, kh, dh, dtype=None, oversample=32, omega=None,
                  tp=None):
        d = kh * dh
        if omega is not None:  # this rank's rows of the global sketch
            omega = omega[t * d:(t + 1) * d]
        return real(k, rank_, kh, dh, dtype=dtype, oversample=oversample,
                    omega=omega)

    out = {}
    shadow_mod.lowrank_kv_factors = svd_local
    try:
        logits, cache = _forced_logits(torch, eng, ids, tokens,
                                       PAR_FAULT_STEPS)
    finally:
        shadow_mod.lowrank_kv_factors = real
    out["svd-local"] = (logits, _u_equal(torch, cache, mesh))

    def roll_scales(cache):
        if rank == 1:
            cache.v_scale.copy_(cache.v_scale.roll(1, dims=2))

    if eng.cache_cfg.kv_quant == "int8":  # bf16 stores have no scales
        logits, _ = _forced_logits(torch, eng, ids, tokens, PAR_FAULT_STEPS,
                                   roll_scales)
        out["scales-rolled"] = (logits, None)
    return out


def _par_engine(torch, cfg, params, axes: dict, rt_kw: dict,
                cache_kw: dict | None = None, mesh=None, eager: bool = False):
    from shadowkv_tpu_torch.config import CacheConfig, RuntimeConfig
    from shadowkv_tpu_torch.models.engine import Engine

    return Engine(cfg, CacheConfig(**dict(PAR_CACHE, **(cache_kw or {}))),
                  RuntimeConfig(**rt_kw, **axes, eager_decode=eager),
                  params, device=DEVICE, mesh=mesh)


def _run_generate(torch, eng, ids):
    out, st = eng.generate(ids, gen_len=PAR_GEN)
    return out, st.prefill_seconds, st.decode_tokens_per_second


def _diverge(a, b) -> int | None:
    """The first decode step whose greedy tokens differ, or None."""
    import numpy as np

    d = np.nonzero((np.asarray(a) != np.asarray(b)).any(axis=0))[0]
    return None if d.size == 0 else int(d[0])


def parallel_ranks(rank: int, port: int, root: str) -> int:
    """One of the two rank processes of the gloo phases on the card
    (``chip_smoke.py --parallel-rank``): one gloo group for every phase of
    PAR_PHASES in order, each with its mesh, its seeded weights and its
    work directory ``root/<label>``, its device memory freed after it."""
    import torch
    import torch.distributed as dist

    from shadowkv_tpu_torch.kernels import build
    from shadowkv_tpu_torch.models.registry import llama31_8b
    from shadowkv_tpu_torch.parallel import mesh as mesh_lib

    torch.cuda.set_device(0)
    build.library()  # built by the parent
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=2)
    full = llama31_8b("meta-llama/Llama-3.1-8B-Instruct", dtype=torch.bfloat16)
    try:
        for label, (layers, axes, cache_kw, rt_kw) in PAR_PHASES.items():
            t0 = time.perf_counter()
            torch.cuda.reset_peak_memory_stats()
            mesh = (mesh_lib.build_mesh_pp(axes["pp"]) if axes.get("pp")
                    else mesh_lib.build_mesh(axes.get("dp", 1),
                                             axes.get("tp", 1),
                                             axes.get("sp", 1)))
            run = PAR_KIND[label][1] if label in PAR_KIND else _rank_phase
            run(torch, rank, mesh, _par_config(full, layers),
                _par_params(torch, full, layers), axes, cache_kw, rt_kw,
                os.path.join(root, label))
            _release(torch)
            if rank == 0:
                log(f"[{label}] ranks {time.perf_counter() - t0:.1f} s")
    finally:
        dist.destroy_process_group()
    return 0


def _rank_phase(torch, rank, mesh, cfg, params, axes, cache_kw, rt_kw,
                work) -> None:
    """A rank of ``_generate_phase``: the phase's engine on this rank's
    shard with eager decode, a greedy run (counts reset just before it and
    read just after), teacher-forced logits on the single-device engine's
    tokens, under tp the cache checks and the planted tp faults, and the
    planted fault's prefill logits; rank 0 writes them."""
    import numpy as np
    import torch.distributed as dist

    f32_rel, f32_fault = _f32_layer(torch, cfg, params, mesh, axes,
                                    rt_kw)
    eng = _par_engine(torch, cfg, params, axes, rt_kw, cache_kw,
                      mesh=mesh, eager=True)
    del params
    _release(torch)
    ref = np.load(os.path.join(work, "ref.npz"))
    ids, ref_tokens = ref["ids"], ref["tokens"]
    counters = _counters()
    _reset_counts(counters)
    with _sim_draws_recorded() as draws:
        out, prefill_s, tok_s = _run_generate(torch, eng, ids)
    counts = _read_counts(counters)
    if draws:
        np.savez(os.path.join(work, f"draws{rank}.npz"), **draws)
    forced, cache = _forced_logits(torch, eng, ids, ref_tokens)
    info = dict(f32=f32_rel, f32_fault=f32_fault)
    arrays = {}
    if axes.get("tp"):
        info["u_equal"] = _u_equal(torch, cache, mesh)
        info["scales"], info["scales_rolled"] = _scale_errs(
            torch, cache, mesh, ref)
    del cache
    _release(torch)
    if axes.get("tp"):
        for name, (lg, u_eq) in _tp_faults(torch, eng, ids, ref_tokens,
                                           mesh, rank).items():
            arrays[name] = lg.numpy()
            info[f"{name} u_equal"] = u_eq
    # planted fault: one rank's o_proj and MLP outputs lost in every
    # local layer (dropped partial sums)
    if rank == (0 if axes.get("pp") else 1):
        eng.params.layers.wo.zero_()
        eng.params.layers.w_down.zero_()
    lg, _ = eng.prefill(ids)
    fault = lg[:, -1].float().cpu()
    info.update(counts=counts,
                peak=torch.cuda.max_memory_allocated() / 2**30)
    every = [None, None]
    dist.all_gather_object(every, info)
    if rank == 0:
        np.savez(os.path.join(work, "rank0.npz"), tokens=out,
                 forced=forced.numpy(), fault=fault.numpy(),
                 prefill_s=prefill_s, tok_s=tok_s,
                 info=json.dumps(every), **arrays)
    dist.barrier()


@contextlib.contextmanager
def _sim_draws_recorded():
    """A dict that gains the ``vs_sim`` draws of the first layer-0 call
    (salt 0) of ``minference.sim_vs_draws`` made inside the block (noise,
    hot, uniform as host arrays); empty without ``vs_sim``."""
    from shadowkv_tpu_torch.core import minference as mi

    real = mi.sim_vs_draws
    out: dict = {}

    def record(b, hm, s, salt=0, device=None, shard=None):
        got = real(b, hm, s, salt, device, shard=shard)
        if salt == 0 and not out:
            out.update(zip(("noise", "hot", "uniform"),
                           (t.cpu().numpy() for t in got)))
        return got

    mi.sim_vs_draws = record
    try:
        yield out
    finally:
        mi.sim_vs_draws = real


def _spawn_ranks(root: str, timeout: float = 900.0) -> None:
    """The two rank processes of this script (``parallel_ranks``), both on
    cuda:0, for every gloo phase; stopped before this returns."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--parallel-rank",
         str(r), str(port), root]) for r in range(2)]
    try:
        for p in procs:
            p.wait(timeout=timeout)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if any(p.returncode for p in procs):
        raise AssertionError(f"the gloo ranks failed "
                             f"({[p.returncode for p in procs]})")


def _rel_steps(a, b):
    """max |a - b| / max |b| per step ([steps, B, V] arrays)."""
    import numpy as np

    return [float(np.abs(x - y).max() / np.abs(y).max())
            for x, y in zip(a, b)]


def run_tp1_nccl(torch, cfg, params) -> dict:
    """``tp1-nccl``: a 1-rank NCCL group through the tensor-parallel code
    path (every o_proj / MLP all-reduce and the logits' all-gather run on
    the group), decode captured as one CUDA graph with the collectives
    inside, at full width and depth, prompt PAR_PROMPT x 2, PAR_GEN greedy
    tokens, fused refresh; its tokens must equal the single-device
    engine's, A counted through the replays."""
    import numpy as np
    import socket

    import torch.distributed as dist

    from shadowkv_tpu_torch.parallel import mesh as mesh_lib

    ids = np.random.default_rng(SEED + 21).integers(
        0, cfg.vocab_size, (BATCH, PAR_PROMPT))
    rt_kw = dict(use_pallas=True)
    counters = _counters()
    eng = _par_engine(torch, cfg, params, {}, rt_kw)
    ref, _, ref_tok_s = _run_generate(torch, eng, ids)
    ref2, _, ref_tok_s2 = _run_generate(torch, eng, ids)
    del eng
    _release(torch)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            rank=0, world_size=1,
                            device_id=torch.device("cuda", 0))
    try:
        mesh = mesh_lib.build_mesh(1, 1, 1)
        eng = _par_engine(torch, cfg, params, {}, rt_kw, mesh=mesh)
        assert eng.tp is not None  # the collectives run
        _reset_counts(counters)
        out, prefill_s, tok_s = _run_generate(torch, eng, ids)
        counts = _read_counts(counters)
        captures = eng._steps.captures
        out2, _, tok_s2 = _run_generate(torch, eng, ids)
        del eng
        _release(torch)
    finally:
        dist.destroy_process_group()
    n_steps = PAR_GEN - 1
    _expect("tp1-nccl", counts, prefill_attention=cfg.num_layers,
            sparse_refresh=cfg.num_layers * n_steps)
    log(f"[tp1-nccl] 1-rank NCCL group, {cfg.num_layers} layers, "
        f"{PAR_PROMPT} x {BATCH}: tokens equal single-device "
        f"{np.array_equal(out, ref) and np.array_equal(out2, ref2)}; graph "
        f"captures {captures}; decode tok/s {tok_s:.2f}, {tok_s2:.2f} "
        f"against single-device {ref_tok_s:.2f}, {ref_tok_s2:.2f}; "
        f"prefill_s {prefill_s:.3f}; launches {counts}")
    if not (np.array_equal(out, ref) and np.array_equal(out2, ref2)):
        raise AssertionError("tp1-nccl: tokens differ from the single-device "
                             "engine's")
    if captures < 1:
        raise AssertionError("tp1-nccl: the decode step was not captured")
    return dict(tok_s=[tok_s, tok_s2], ref_tok_s=[ref_tok_s, ref_tok_s2])


def run_parallel_phases(torch, cfg) -> dict:
    """The 2-rank gloo phases (two processes on this one card, eager
    decode): ``_generate_phase``, or the phase's own (``PAR_KIND``). Each
    phase is a generator whose first part (up to its ``yield``) runs the
    single-device side here and writes what the ranks read into its work
    directory; then one pair of rank processes runs every phase in order
    (``parallel_ranks``), and each phase's second part checks the ranks'
    results. Two ranks share one card: their tok/s says nothing of
    scaling."""
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "shadowkv_tpu_torch", "build", "parallel")
    shutil.rmtree(root, ignore_errors=True)
    phases = {}
    for label, (layers, axes, cache_kw, rt_kw) in PAR_PHASES.items():
        t0 = time.perf_counter()
        work = os.path.join(root, label)
        os.makedirs(work)
        run = PAR_KIND[label][0] if label in PAR_KIND else _generate_phase
        phases[label] = run(torch, cfg, label, layers, axes, cache_kw,
                            rt_kw, work)
        next(phases[label])
        log(f"[{label}] single-device side {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    _spawn_ranks(root)
    log(f"[gloo ranks] every phase in one pair of processes: "
        f"{time.perf_counter() - t0:.1f} s")
    out = {}
    for label, phase in phases.items():
        t0 = time.perf_counter()
        try:
            next(phase)
        except StopIteration as done:
            out[label] = done.value
        else:
            raise AssertionError(f"{label}: the phase yields once")
        log(f"[{label}] checks {time.perf_counter() - t0:.1f} s")
    shutil.rmtree(root, ignore_errors=True)
    return out


def _generate_phase(torch, cfg, label, layers, axes, cache_kw, rt_kw,
                    work) -> dict:
    """A greedy run on the mesh against the single-device engine: the
    single-device engine here first (greedy tokens, teacher-forced logits;
    under tp its layer-0 scales and the half-sums control; with vs_sim its
    layer-0 draws), then the ranks; their logits within PAR_LOGIT_TOL of
    the single device's, the planted fault above it, the f32 layer and the
    tp cache checks within their bounds with their faults above, a rank's
    vs_sim draws bit-equal to its slice of the single device's, the
    launches of each rank's kernels exact, the greedy tokens with the
    first divergence step."""
    import numpy as np

    lcfg = _par_config(cfg, layers)
    params = _par_params(torch, cfg, layers)
    eng = _par_engine(torch, lcfg, params, {}, rt_kw, cache_kw)
    ids = np.random.default_rng(SEED + 31).integers(
        0, cfg.vocab_size, (BATCH, GLOO_PROMPT))
    with _sim_draws_recorded() as global_draws:
        ref, _, ref_tok_s = _run_generate(torch, eng, ids)
    ref_logits, cache = _forced_logits(torch, eng, ids, ref)
    ref_logits = ref_logits.numpy()
    scales = {n: getattr(cache, n)[0].float().cpu().numpy()
              for n in SCALES if getattr(cache, n) is not None}
    del eng, cache
    _release(torch)
    control = shapes = None
    if axes.get("tp"):
        control = _half_sums_control(torch, lcfg, params, cache_kw,
                                     rt_kw, ids, ref)
        shapes = _rank_shapes_control(torch, lcfg, params, cache_kw, rt_kw,
                                      ids, ref)
    del params
    _release(torch)
    np.savez(os.path.join(work, "ref.npz"), ids=ids, tokens=ref,
             **scales)
    yield  # the ranks run here (run_parallel_phases)
    got = np.load(os.path.join(work, "rank0.npz"))
    info = json.loads(str(got["info"]))
    rel = _rel_steps(got["forced"], ref_logits)
    fault = float(np.abs(got["fault"] - ref_logits[0]).max()
                  / np.abs(ref_logits[0]).max())
    div = _diverge(got["tokens"], ref)
    per_rank = layers // axes.get("pp", 1)
    # the prefill kernel once per local layer per prefill (sp: B's offset
    # form; pp: per microbatch, two of one row each; the sparse prefills
    # their own); the decode kernel once per local layer per step
    pattern = rt_kw.get("prefill_pattern", "dense")
    prefill_name = ("prefill_attention_offset" if axes.get("sp")
                    else PREFILL_KERNEL[rt_kw.get("vs_impl", "tile")]
                    if pattern == "vs" else PREFILL_KERNEL.get(
                        pattern, "prefill_attention"))
    want = {prefill_name: per_rank * (2 if axes.get("pp") else 1)}
    mode = cache_kw.get("mode", PAR_CACHE["mode"])
    step_name = decode_kernel(mode, rt_kw)
    if step_name:
        want[step_name] = per_rank * (PAR_GEN - 1)
        if mode == "shadow_offload" and step_name != "gather_v_rows":
            want[step_name + "_host_v"] = want[step_name]
    for r, rinfo in enumerate(info):
        _expect(f"{label} rank {r}", rinfo["counts"], **want)
    launches = {k: sum(ri["counts"][k] for ri in info) for k in want}
    f32 = [ri["f32"] for ri in info]
    f32_fault = [ri["f32_fault"] for ri in info]
    f32_text = ("n/a (pp stages run whole single-device layers)"
                if axes.get("pp") else f"{f32} (tol {PAR_F32_TOL}; "
                f"planted fault {f32_fault})")
    draws_equal = None
    if global_draws:
        heads = cfg.num_heads // axes["tp"]
        draws_equal = []
        for r in range(2):
            mine = np.load(os.path.join(work, f"draws{r}.npz"))
            draws_equal.append(all(
                np.array_equal(mine[n], global_draws[n][:, r * heads:
                                                        (r + 1) * heads])
                for n in ("noise", "hot", "uniform")))
    tp_text = ""
    if axes.get("tp"):
        n_f = PAR_FAULT_STEPS + 1
        names = [n for n in ("svd-local", "scales-rolled")
                 if n in got.files]
        faults = {n: max(_rel_steps(got[n], ref_logits[:n_f]))
                  for n in names}
        near = {n: max(_rel_steps(got[n], shapes[:n_f])) for n in names}
        floor = max(_rel_steps(control, ref_logits))
        to_shapes = max(_rel_steps(got["forced"], shapes))
        tp_text = (
            f"; half-sums control (tp=2 noise floor) {floor:.4e} (bound "
            f"{PAR_CONTROL_RATIO} x: {PAR_CONTROL_RATIO * floor:.4e}); "
            f"rank-shapes control against the single device "
            f"{max(_rel_steps(shapes, ref_logits)):.4e}, the ranks against "
            f"it {to_shapes:.4e} (faults against it {near}), the ranks "
            f"against the half-sums control "
            f"{max(_rel_steps(got['forced'], control)):.4e}; U "
            f"bit-equal across the tp ranks "
            f"{[ri['u_equal'] for ri in info]} (svd-local fault: "
            f"{[ri['svd-local u_equal'] for ri in info]}); layer 0 "
            f"scales against the single device's head slice "
            f"{[ri['scales'] for ri in info]} (tol {PAR_SCALE_TOL}; rolled "
            f"by one head {[ri['scales_rolled'] for ri in info]}); planted "
            f"tp faults' logits over {PAR_FAULT_STEPS} steps "
            + ", ".join(f"{n} {v:.4e} (above {PAR_LOGIT_TOL}: "
                        f"{v > PAR_LOGIT_TOL}; against the rank-shapes "
                        f"control above the bound: "
                        f"{near[n] > PAR_CONTROL_RATIO * floor})"
                        for n, v in faults.items()))
    if draws_equal is not None:
        tp_text += (f"; layer-0 vs_sim draws of each rank bit-equal to its "
                    f"head slice of the single device's {draws_equal}")
    log(f"[{label}] {layers} layers, {cache_kw}, {rt_kw}, {GLOO_PROMPT} x "
        f"{BATCH}, mesh {axes}: f32 layer 0 rel err per rank {f32_text}; "
        f"teacher-forced logits rel err max {max(rel):.4e} (prefill "
        f"{rel[0]:.4e}; tol {PAR_LOGIT_TOL}); planted fault {fault:.4e} "
        f"(rejected: {fault > PAR_LOGIT_TOL}){tp_text}; greedy tokens "
        f"equal {div is None} (first divergence step {div}); launches "
        f"per rank {[ri['counts'] for ri in info]} (sum {launches}); "
        f"peak GiB per rank {[round(ri['peak'], 2) for ri in info]}; "
        f"2-rank prefill_s {float(got['prefill_s']):.3f} decode tok/s "
        f"{float(got['tok_s']):.2f} against single-device "
        f"{ref_tok_s:.2f} (both ranks on one card: no scaling claim)")
    if not (max(rel) <= PAR_LOGIT_TOL < fault):
        raise AssertionError(f"{label}: logits off the single-device "
                             "engine's, or the bound misses the fault")
    if not axes.get("pp") and not all(
            e <= PAR_F32_TOL < b for e, b in zip(f32, f32_fault)):
        raise AssertionError(f"{label}: the f32 layer is off the single "
                             "device's, or the bound misses the fault")
    if axes.get("tp") and not (
            to_shapes <= PAR_CONTROL_RATIO * floor < min(near.values())):
        raise AssertionError(
            f"{label}: logits off the rank-shapes control by more than "
            f"{PAR_CONTROL_RATIO} x the half-sums floor, or a planted tp "
            "fault within it")
    if axes.get("tp") and not all(
            ri["u_equal"] and not ri["svd-local u_equal"]
            and all(ri["scales"][n] <= PAR_SCALE_TOL
                    < ri["scales_rolled"][n] for n in ri["scales"])
            for ri in info):
        raise AssertionError(f"{label}: U differs across the tp ranks or "
                             "a rank's scales are off the single "
                             "device's head slice, or a check misses "
                             "its fault")
    if draws_equal is not None and not all(draws_equal):
        raise AssertionError(f"{label}: a rank's vs_sim draws are not its "
                             "slice of the single device's")
    return dict(rel=max(rel), fault=fault, diverge=div, f32=f32,
                launches=launches, tok_s=float(got["tok_s"]),
                ref_tok_s=ref_tok_s, summary=(
                    f"logits rel {max(rel):.4e} (fault {fault:.4e}), first "
                    f"divergence {div}, 2-rank tok/s "
                    f"{float(got['tok_s']):.2f} (single {ref_tok_s:.2f})"))


CTX_FIRST = 9  # greedy tokens before a save: the prefill's and 8 steps'
CTX_MORE = 8  # decode steps after the load


def _context_phase(torch, cfg, label, layers, axes, cache_kw, rt_kw,
                   work) -> dict:
    """Context checkpoints on a tp=2 mesh (``_context_rank`` for the
    ranks). Here first: the single-device engine's greedy run of
    CTX_FIRST + CTX_MORE tokens, its teacher-forced logits, a file saved
    after its first CTX_FIRST tokens (which the ranks load) and the
    half-sums control (the tp=2 noise floor). After the ranks: their resume
    from their own file gives their unbroken tokens, bit for bit; the
    single-device file resumed on the mesh and the mesh's file resumed on
    one device (here) give teacher-forced logits within PAR_LOGIT_TOL and
    PAR_CONTROL_RATIO x the control of the single device's on the same
    tokens, and the mesh's file with its two tp ranks' heads swapped (a
    file written in the wrong head order) reads above both bounds;
    launches exact, save and load seconds, the file's GiB. With V on the
    host the loaded store must be pinned host memory and the load's peak
    device memory no more than the other fields' bytes."""
    import numpy as np

    from shadowkv_tpu_torch.utils.checkpoint import HEAD_FIELDS

    lcfg = _par_config(cfg, layers)
    params = _par_params(torch, cfg, layers)
    n = CTX_FIRST + CTX_MORE
    ids = np.random.default_rng(SEED + 33).integers(
        0, cfg.vocab_size, (BATCH, GLOO_PROMPT))
    eng = _par_engine(torch, lcfg, params, {}, rt_kw, cache_kw, eager=True)
    ref, _ = eng.generate(ids, gen_len=n)
    ref_logits, _ = _forced_logits(torch, eng, ids, ref, n - 1)
    ref_logits = ref_logits.numpy()
    eng.generate(ids, gen_len=CTX_FIRST)
    eng.save_state(os.path.join(work, "single.npz"))
    del eng
    _release(torch)
    control = _half_sums_control(torch, lcfg, params, cache_kw, rt_kw, ids,
                                 ref, n - 1)
    floor = max(_rel_steps(control, ref_logits))
    np.savez(os.path.join(work, "ref.npz"), ids=ids, tokens=ref)
    del params
    _release(torch)
    yield  # the ranks run here (run_parallel_phases)
    got = np.load(os.path.join(work, "rank0.npz"))
    info = json.loads(str(got["info"]))
    on_mesh = _rel_steps(got["forced"], ref_logits[CTX_FIRST:])

    # the mesh's file on one device, on the mesh's own tokens
    eng = _par_engine(torch, lcfg, _par_params(torch, cfg, layers), {},
                      rt_kw, cache_kw, eager=True)
    _release(torch)
    mesh_tok = got["unbroken"]
    base, _ = _forced_logits(torch, eng, ids, mesh_tok, n - 1)
    base = base.numpy()[CTX_FIRST:]

    def resumed_logits(swap: bool):
        eng.load_state(os.path.join(work, "mesh.npz"))
        if swap:
            for name in HEAD_FIELDS:
                t = getattr(eng._cache, name)
                if t is not None:
                    t.copy_(t.roll(t.shape[2] // 2, dims=2))
        out = []
        for i in range(CTX_MORE):
            tok = torch.as_tensor(mesh_tok[:, CTX_FIRST - 1 + i],
                                  dtype=torch.int32, device=DEVICE)
            out.append(eng.decode_step(eng._cache, tok)[1].float().cpu())
        return torch.stack(out).numpy()

    on_one = _rel_steps(resumed_logits(False), base)
    swapped = max(_rel_steps(resumed_logits(True), base))
    del eng
    _release(torch)
    bound_ = min(PAR_LOGIT_TOL, PAR_CONTROL_RATIO * floor)
    per_rank = layers
    host = cache_kw.get("mode") == "shadow_offload"
    want = {"prefill_attention": per_rank,
            "sparse_refresh": per_rank * (n - 1)}
    want_resume = {"sparse_refresh": per_rank * CTX_MORE}
    if host:
        want["sparse_refresh_host_v"] = want["sparse_refresh"]
        want_resume["sparse_refresh_host_v"] = want_resume["sparse_refresh"]
    for r, ri in enumerate(info):
        _expect(f"{label} rank {r} unbroken", ri["counts"], **want)
        _expect(f"{label} rank {r} resume", ri["resume_counts"],
                **want_resume)
    equal = bool(np.array_equal(got["resumed"], got["unbroken"]))
    res = dict(save_s=info[0]["save_s"],
               load_s=[ri["load_s"] for ri in info],
               file_gib=info[0]["file_gib"], resume_equal=equal,
               single_on_mesh=max(on_mesh), mesh_on_single=max(on_one),
               swapped=swapped, floor=floor,
               load_peak_mib=[ri["load_peak"] / 2**20 for ri in info],
               other_fields_mib=[ri["dev_bytes"] / 2**20 for ri in info],
               v_mib=[ri["v_bytes"] / 2**20 for ri in info],
               v_pinned_host=[ri["host_v"] for ri in info])
    log(f"[{label}] {layers} layers, {cache_kw}, {rt_kw}, {GLOO_PROMPT} x "
        f"{BATCH}, tp=2: save {res['save_s']:.3f} s ({res['file_gib']:.4f} "
        f"GiB), load per rank {[round(x, 3) for x in res['load_s']]} s; "
        f"tp2 resume equals the unbroken tp2 run {equal}; single-device "
        f"file resumed on tp2: teacher-forced logits rel err "
        f"{max(on_mesh):.4e}; tp2 file resumed on one device "
        f"{max(on_one):.4e}; heads swapped (planted) {swapped:.4e}; bound "
        f"min({PAR_LOGIT_TOL}, {PAR_CONTROL_RATIO} x control {floor:.4e}) "
        f"= {bound_:.4e}; launches per rank {[ri['counts'] for ri in info]}"
        f", resumed {[ri['resume_counts'] for ri in info]}; load peak MiB "
        f"{res['load_peak_mib']} against the non-V fields' "
        f"{res['other_fields_mib']} (V {res['v_mib']} MiB, pinned on the "
        f"host {res['v_pinned_host']})")
    if not equal:
        raise AssertionError(f"{label}: the tp2 resume differs from the "
                             "unbroken tp2 run")
    if not (max(on_mesh) <= bound_ and max(on_one) <= bound_ < swapped):
        raise AssertionError(f"{label}: a resumed file's logits are off the "
                             "single device's, or the bound misses the "
                             "swapped heads")
    if host and not all(
            ri["host_v"] and ri["load_peak"] <= ri["dev_bytes"] + 2**20
            < ri["dev_bytes"] + ri["v_bytes"] for ri in info):
        raise AssertionError(f"{label}: the loaded V store is not pinned "
                             "host memory, or it passed through the card")
    res["summary"] = (f"save {res['save_s']:.3f} s, load "
                      f"{max(res['load_s']):.3f} s, {res['file_gib']:.4f} "
                      f"GiB, resume equal {equal}, logits rel "
                      f"{max(on_mesh):.4e} / {max(on_one):.4e} (swapped "
                      f"{swapped:.4e})")
    return res


def _context_rank(torch, rank, mesh, cfg, params, axes, cache_kw, rt_kw,
                  work) -> None:
    """A rank of ``_context_phase``: the unbroken greedy run (counts reset
    just before it and read just after); a run of CTX_FIRST tokens saved to
    one global file (timed); a fresh engine loads it (timed, with the
    load's peak device memory) and continues CTX_MORE tokens (counted);
    the single device's file loaded and fed the single device's tokens
    (teacher-forced logits); rank 0 writes the results."""
    import numpy as np
    import torch.distributed as dist

    from shadowkv_tpu_torch.cache.shadow import ShadowCache

    ref = np.load(os.path.join(work, "ref.npz"))
    ids, single = ref["ids"], ref["tokens"]
    eng = _par_engine(torch, cfg, params, axes, rt_kw, cache_kw, mesh=mesh,
                      eager=True)
    fresh = _par_engine(torch, cfg, params, axes, rt_kw, cache_kw,
                        mesh=mesh, eager=True)
    del params
    _release(torch)
    counters = _counters()
    _reset_counts(counters)
    unbroken, _ = eng.generate(ids, gen_len=CTX_FIRST + CTX_MORE)
    counts = _read_counts(counters)
    first, _ = eng.generate(ids, gen_len=CTX_FIRST)
    path = os.path.join(work, "mesh.npz")
    torch.cuda.synchronize()
    dist.barrier()
    t0 = time.perf_counter()
    eng.save_state(path)
    save_s = time.perf_counter() - t0
    del eng
    _release(torch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    fresh.load_state(path)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    load_peak = torch.cuda.max_memory_allocated() - before
    cache = fresh._cache
    dev_bytes = sum(t.numel() * t.element_size() for t in (
        getattr(cache, n) for n in ShadowCache.FIELDS if n != "v_full")
        if t is not None)
    v = cache.v_full
    host_v = (not v.is_cuda) and v.is_pinned()
    _reset_counts(counters)
    rest, _ = fresh.generate(first[:, -1:], gen_len=CTX_MORE, cont=True)
    resume_counts = _read_counts(counters)
    fresh.load_state(os.path.join(work, "single.npz"))
    forced = []
    for i in range(CTX_MORE):
        tok = torch.as_tensor(single[:, CTX_FIRST - 1 + i], dtype=torch.int32,
                              device=DEVICE)
        forced.append(fresh.decode_step(fresh._cache, tok)[1].float().cpu())
    info = dict(counts=counts, resume_counts=resume_counts, save_s=save_s,
                load_s=load_s, load_peak=load_peak, dev_bytes=dev_bytes,
                v_bytes=v.numel() * v.element_size(), host_v=host_v,
                file_gib=os.path.getsize(path) / 2**30)
    every = [None, None]
    dist.all_gather_object(every, info)
    if rank == 0:
        np.savez(os.path.join(work, "rank0.npz"), unbroken=unbroken,
                 resumed=np.concatenate([first, rest], axis=1),
                 forced=torch.stack(forced).numpy(), info=json.dumps(every))
    dist.barrier()


SERVE_CTX_SLOTS = 2  # per dp shard
SERVE_CTX_CONTEXTS = (0, 1, 2, 3, 2, 0, 1, 3)  # context of each request


def _ctx_requests(cfg) -> list:
    """The shared-context stream of ``dp2-serve-ctx-gloo``: four
    GLOO_PROMPT-token contexts, each request a SERVE_SUFFIX-token suffix
    and SERVE_SUFFIX greedy tokens. The first four fill the 2 x 2 slots
    and finish in the first chunk; at its end slot 0 (shard 0) restores
    context 2 (taken on slot 2, shard 1), slot 1 context 0 (slot 0), slot
    2 (shard 1) context 1 (slot 1, shard 0) and slot 3 context 3 (slot
    3): two restores across the shards, one each way, and two within."""
    import numpy as np

    from shadowkv_tpu_torch.serving import Request

    rng = np.random.default_rng(SEED + 35)
    ctx = rng.integers(0, cfg.vocab_size, (4, GLOO_PROMPT))
    return [Request(uid=i, input_ids=np.concatenate([
        ctx[c], rng.integers(0, cfg.vocab_size, SERVE_SUFFIX)]),
        gen_len=SERVE_SUFFIX, context_id=c, context_len=GLOO_PROMPT)
        for i, c in enumerate(SERVE_CTX_CONTEXTS)]


def _ctx_batcher(eng):
    from shadowkv_tpu_torch.serving import ContinuousBatcher

    return ContinuousBatcher(eng, slots=SERVE_CTX_SLOTS * eng.rt.dp,
                             max_contexts=4, max_dispatch=2 * SERVE_SUFFIX)


def _serve_phase(torch, cfg, label, layers, axes, cache_kw, rt_kw,
                 work) -> dict:
    """Shared-prefix snapshots over dp=2 (``_serve_rank`` for the ranks),
    every prefill one sequence (``prefill_sub_batch=1``): the batcher's
    greedy tokens of every request equal the single-device batcher's here,
    run at a rank's batch shape (SERVE_CTX_SLOTS slots: each request then
    sees the same kernels and GEMM shapes); at least two restores cross
    the shards, one each way; launches exact per rank (B once per layer
    and one-sequence prefill of the shard, A once per layer and decode
    step); ms per restore across and within a shard."""
    import numpy as np

    lcfg = _par_config(cfg, layers)
    params = _par_params(torch, cfg, layers)
    eng = _par_engine(torch, lcfg, params, {}, rt_kw, cache_kw)
    del params
    _release(torch)
    want, st1 = _ctx_batcher(eng).run(_ctx_requests(cfg))
    del eng
    _release(torch)
    yield  # the ranks run here (run_parallel_phases)
    got = np.load(os.path.join(work, "rank0.npz"), allow_pickle=True)
    info = json.loads(str(got["info"]))
    served = got["tokens"].item()
    equal = sorted(served) == sorted(want) and all(
        np.array_equal(served[u], want[u]) for u in want)
    st = info[0]["stats"]
    for r, ri in enumerate(info):
        _expect(f"{label} rank {r}", ri["counts"],
                prefill_attention=layers * SERVE_CTX_SLOTS,
                sparse_refresh=layers * st["decode_steps"])
    cross = [len(ri["ms"]["cross"]) for ri in info]
    ms = {k: float(np.mean([x for ri in info for x in ri["ms"][k]]))
          for k in ("cross", "same")}
    res = dict(equal=equal, cross=cross, ms_cross=ms["cross"],
               ms_same=ms["same"], stats=st,
               single_decode_steps=st1.decode_steps)
    log(f"[{label}] {layers} layers, {rt_kw}, dp=2 x {SERVE_CTX_SLOTS} "
        f"slots, {len(SERVE_CTX_CONTEXTS)} requests on 4 contexts of "
        f"{GLOO_PROMPT} tokens: tokens equal the single-device batcher's "
        f"{equal}; restores across shards per rank {cross} (owners "
        f"{info[0]['owners']}), ms per restore across "
        f"{ms['cross']:.3f} against within a shard {ms['same']:.3f}; "
        f"launches per rank {[ri['counts'] for ri in info]}; stats {st}; "
        f"served tok/s {st['completed_tokens'] / st['wall_seconds']:.2f}")
    if not equal:
        raise AssertionError(f"{label}: served tokens differ from the "
                             "single-device batcher's")
    if min(cross) < 2 or st["context_hits"] != 4 \
            or sorted(info[0]["owners"]) != [[0, 1], [1, 0]]:
        raise AssertionError(f"{label}: expected two restores across the "
                             "shards, one each way")
    res["summary"] = (f"tokens equal {equal}, {cross[0]} restores across "
                      f"shards at {ms['cross']:.3f} ms against "
                      f"{ms['same']:.3f} ms within")
    return res


def _serve_rank(torch, rank, mesh, cfg, params, axes, cache_kw, rt_kw,
                work) -> None:
    """A rank of ``_serve_phase``: the batcher run with every kernel count
    set to 0 just before it and read just after, each restore timed and
    classed by the shards it joins; rank 0 writes the results."""
    import dataclasses

    import numpy as np
    import torch.distributed as dist

    eng = _par_engine(torch, cfg, params, axes, rt_kw, cache_kw, mesh=mesh,
                      eager=True)
    del params
    _release(torch)
    ms: dict = {"cross": [], "same": []}
    owners = []
    real = eng._merge_slots

    def timed(cache, small, b0, with_v=False, src=None):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real(cache, small, b0, with_v, src)
        torch.cuda.synchronize()
        pair = [eng.mesh.batch_ranks.index(eng._slot_at(x)[0])
                for x in (src, b0)]
        if pair[0] != pair[1]:
            owners.append(pair)
        ms["cross" if pair[0] != pair[1] else "same"].append(
            (time.perf_counter() - t0) * 1e3)
        return out

    eng._merge_slots = timed
    counters = _counters()
    reqs = _ctx_requests(cfg)
    _reset_counts(counters)
    results, st = _ctx_batcher(eng).run(reqs)
    counts = _read_counts(counters)
    info = dict(counts=counts, ms=ms, owners=owners,
                stats=dataclasses.asdict(st))
    every = [None, None]
    dist.all_gather_object(every, info)
    if rank == 0:
        np.savez(os.path.join(work, "rank0.npz"),
                 tokens=np.array(results, dtype=object),
                 info=json.dumps(every))
    dist.barrier()


PAR_KIND.update({
    "tp2-context-gloo": (_context_phase, _context_rank),
    "tp2-offload-fused-context-gloo": (_context_phase, _context_rank),
    "dp2-serve-ctx-gloo": (_serve_phase, _serve_rank),
})


def check_shard_kernels(torch, cfg, lay, link: float) -> dict:
    """A, D, E, A-host and gather_v_rows against their plain versions at
    the shapes a 2-rank mesh gives them: the tp=2 head slice (B 2, 16 heads
    / 4 KV heads) for all five, and the dp=2 shard (B 1, 8 KV heads) for D
    and E, which the dp phases run; then C, F and G at the tp=2 head slice
    of the gloo phases' prefill (``check_shard_attention``), whose
    readings it returns."""
    import dataclasses

    half = dataclasses.replace(cfg, num_heads=cfg.num_heads // 2,
                               num_kv_heads=cfg.num_kv_heads // 2)
    log("[shard shapes: tp=2 head slice, B 2, 16 heads / 4 KV heads]")
    check_refresh(torch, half, lay)
    check_refresh_host(torch, half, lay, link, layers=128)  # 1.3 MB a layer
    check_gather(torch, half, lay, link, timed=False)
    check_gather_v_rows(torch, half, lay, link, layers=64)  # 2 MB a layer
    log("[shard shapes: dp=2 shard, B 1, 8 KV heads]")
    check_gather(torch, cfg, lay, link, batch=1, timed=False)
    return check_shard_attention(torch, half)


def check_shard_attention(torch, half) -> dict:
    """C (window 1024, sink 64, as tp2-stream-gloo), F and G (VS_GLOO's
    sizes on clustered flags, as the vs_sim phases) against their
    plain versions at a tp=2 rank's prefill shapes, B 2 / S GLOO_PROMPT /
    16 heads / 4 KV heads, per row as at full width; timed beside their
    bounds. Returns {kernel: (ms, bound_ms, bound_by)}."""
    from shadowkv_tpu_torch.core import minference as mi
    from shadowkv_tpu_torch.core.attention import sparse_prefill_attention
    from shadowkv_tpu_torch.kernels import vs_sparse, vs_tile
    from shadowkv_tpu_torch.kernels.prefill_attention import (
        sparse_prefill_splash,
    )

    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 7)
    b, s = BATCH, GLOO_PROMPT
    h, kh, dh = half.num_heads, half.num_kv_heads, half.head_dim
    q = torch.randn(b, s, h, dh, device=DEVICE, generator=gen,
                    dtype=torch.bfloat16)
    k = torch.randn(b, s, kh, dh, device=DEVICE, generator=gen,
                    dtype=torch.bfloat16)
    v = torch.randn(b, s, kh, dh, device=DEVICE, generator=gen,
                    dtype=torch.bfloat16)
    io_bytes = (2 * q.numel() + k.numel() + v.numel()) * 2
    out = {}
    window, sink = 1024, 64
    run = lambda: sparse_prefill_splash(q, k, v, window, sink)  # noqa: E731
    ref = sparse_prefill_attention(q, k, v, window, sink)
    _check_rows(torch, f"shard C, B {b} S {s} H {h}", run(), ref, s)
    pairs = _stream_pairs(torch, s, window, sink) * b * h
    out["C"] = (time_ms(torch, run, reps=10, warmup=2),
                *bound(io_bytes, 4 * dh * pairs))
    vert, sl = _vs_flag_sets(torch, gen, q, k, s)["clustered"]
    v_idx, dflag, meta, _ = _vs_inputs(torch, vert, sl, s, VS_GLOO)
    q_f, k_f, v_f = mi.flat_heads(q, s), mi.flat_heads(k, s), mi.flat_heads(v, s)
    kv_map = mi.kv_map_of(b, kh, range(h), h // kh, DEVICE)
    block = VS_GLOO["vs_block"]
    kw = dict(block=block, scale=dh**-0.5, seq_len=s)
    runs = {
        "F": (lambda: vs_tile.vs_tile_attention(
                  q_f, k_f, v_f, v_idx, dflag, kv_map, **kw),
              lambda: vs_tile.vs_tok_attention_reference(
                  q_f, k_f, v_f, v_idx, dflag, kv_map, **kw),
              vs_tile.tile_masks(v_idx, dflag, block, s, s, 256),
              (v_idx.numel() + dflag.numel()) * 4),
        "G": (lambda: vs_sparse.vs_sparse_attention(
                  q_f, k_f, v_f, meta.col_ids, meta.col_cnt, meta.col_flag,
                  meta.diag_ids, meta.diag_cnt, kv_map, **kw),
              lambda: mi.vs_attention_reference(q_f, k_f, v_f, meta, kv_map,
                                                **kw),
              mi.walk_masks(meta, block, s, s, 256),
              5 * meta.col_ids.numel() * 4),
    }
    for name, (run, plain, masks, extra) in runs.items():
        _check_rows(torch, f"shard {name}, BH {b * h} S {s}", run(), plain(),
                    s)
        pairs = mi.active_pairs(masks, s)
        out[name] = (time_ms(torch, run, reps=10, warmup=2),
                     *bound(io_bytes + extra, 4 * dh * pairs))
    for name, (ms, b_ms, by) in out.items():
        log(f"[shard {name}] B {b} S {s} {h} heads / {kh} KV heads: "
            f"kernel_ms {ms:.4f} bound_ms {b_ms:.4f} ({by}; "
            f"{b_ms / ms:.1%} of bound)")
    del q, k, v, q_f, k_f, v_f
    torch.cuda.empty_cache()
    return out


def main(mode: str = "all") -> int:
    # The flex_attention yardstick compiles in this process (no compile
    # workers to stop) into the checkout's gitignored build directory.
    build_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "shadowkv_tpu_torch", "build")
    os.environ.setdefault("TORCHINDUCTOR_COMPILE_THREADS", "1")
    os.environ.setdefault("TORCHINDUCTOR_CACHE_DIR",
                          os.path.join(build_dir, "inductor"))
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(build_dir, "triton"))
    # The LLM looks for a tokenizer; it must never ask the network.
    os.environ["HF_HUB_OFFLINE"] = "1"
    os.environ["TRANSFORMERS_OFFLINE"] = "1"
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from shadowkv_tpu_torch.cache.shadow import ShadowLayout
    from shadowkv_tpu_torch.config import H100_HIT_THRESHOLD, CacheConfig
    from shadowkv_tpu_torch.kernels import build
    from shadowkv_tpu_torch.models.params import init_synthetic_params
    from shadowkv_tpu_torch.models.registry import llama31_8b

    t_start = time.perf_counter()
    facts = device_facts(torch)
    t0 = time.perf_counter()
    so = build.build()
    log(f"[build] {so.name} in {time.perf_counter() - t0:.1f} s")
    log((build.BUILD_DIR / "nvcc.log").read_text())
    link = host_link_peak(torch)

    cfg = llama31_8b("meta-llama/Llama-3.1-8B-Instruct", dtype=torch.bfloat16)
    lay = ShadowLayout.build(
        CacheConfig(mode="shadow", max_length=PROMPT_LEN, sparse_budget=2048,
                    rank=160, chunk_size=16, kv_quant="int8",
                    gen_capacity=256),
        PROMPT_LEN,
    )
    evidence = kernel_evidence(so)
    for label, text in evidence.items():
        log(f"[kernel {label}] {text}")
    if mode == "select":
        check_select(torch, evidence["select"])
        print(facts["smi"])
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": facts["name"],
            "count": torch.cuda.device_count()}}))
        return 0
    entries = {"sparse_refresh": check_refresh(torch, cfg, lay)}
    if mode == "k-exaone":
        check_k_exaone_attention(torch)
        run_k_exaone_slice(torch)
        print(facts["smi"])
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": facts["name"],
            "count": torch.cuda.device_count()}}))
        return 0
    entries["sparse_refresh_host_v"] = check_refresh_host(torch, cfg, lay, link)
    entries["prefill_attention"] = check_prefill_attention(
        torch, cfg, evidence["B, C"])
    entries["prefill_attention_offset"] = check_prefill_offset(torch, cfg)
    entries["sparse_prefill_attention"] = check_sparse_prefill(
        torch, cfg, evidence["B, C"])
    entries["gather_chunks"], entries["gather_chunks_host_v"] = check_gather(
        torch, cfg, lay, link)
    entries["vs_tile_attention"], entries["vs_sparse_attention"] = \
        check_vs_kernels(torch, cfg, evidence)
    entries["decode_attention"] = check_decode_attention(
        torch, evidence["decode attention"])
    entries["select_slots"] = check_select(torch, evidence["select"])
    check_k_exaone_attention(torch)
    k_exaone = run_k_exaone_slice(torch)
    check_toy_engine(torch)
    check_head_dim_96(torch)

    t0 = time.perf_counter()
    params = init_synthetic_params(
        cfg, torch.Generator(device=DEVICE).manual_seed(SEED), device=DEVICE)
    torch.cuda.synchronize()
    log(f"[weights] synthetic bf16 {cfg.name} in "
        f"{time.perf_counter() - t0:.1f} s")
    runs = {label: run_slice(torch, cfg, params, label, mode, rt_kw,
                             PROMPT_LEN)
            for label, mode, rt_kw in SLICE_RUNS}
    check_offload_twins(torch, runs)
    entries["gather_v_rows"] = check_gather_v_rows(torch, cfg, lay, link)
    runs.update(run_settings(torch, cfg, params, runs))
    cross = {cs: crossover_sweep(torch, cfg, params, cs)
             for cs in SWEEP_CHUNKS}
    run_auto(torch, cfg, params)
    check_toy_serving(torch)
    serve = run_serving(torch, cfg, params)
    tp1 = run_tp1_nccl(torch, cfg, params)
    del params  # each LLM of the entry-points phase holds its own weights
    _release(torch)
    shard = check_shard_kernels(torch, cfg, lay, link)
    par = run_parallel_phases(torch, cfg)
    entry_points = run_entry_points(torch, cfg, runs["shadow"])
    training = run_training_phases(torch)
    # Each kernel's launches come from the run of the path that uses it.
    home = {"sparse_refresh": "shadow", "prefill_attention": "shadow",
            "sparse_refresh_host_v": "offload-fused",
            "gather_chunks": "shadow-ring",
            "gather_chunks_host_v": "offload-ring",
            "sparse_prefill_attention": "stream",
            "vs_tile_attention": "vs-tile", "vs_sparse_attention": "vs-walk",
            "gather_v_rows": "offload-host", "decode_attention": "shadow",
            "select_slots": "shadow"}
    for name, entry in entries.items():
        if name == "prefill_attention_offset":  # both ranks of sp2-gloo
            entry["launches"] = par["sp2-gloo"]["launches"][name]
            continue
        entry["launches"] = runs[home[name]]["launches"][name]
    log("[summary] prefill_s " + ", ".join(
        f"{k} {r['prefill_s']:.3f}" for k, r in runs.items())
        + f" (dense shadow {runs['shadow']['prefill_s']:.3f})")
    log("[summary] decode tok/s, graph (eager) " + ", ".join(
        f"{k} {r['decode_tok_s']:.1f} ({r['eager_tok_s']:.1f})"
        for k, r in runs.items())
        + f" at {PROMPT_LEN} x {BATCH}; crossover hit rate by chunk size "
        f"{cross} (config: {H100_HIT_THRESHOLD})")
    log("[summary] serving, served / decode-only / static tok/s: " + ", ".join(
        f"{k} {r['served_tok_s']:.2f} / {r['decode_tok_s']:.2f} / "
        f"{r['static_tok_s']:.2f} ({r['served_over_static']:.3f}x)"
        for k, r in serve.items())
        + f"; total {time.perf_counter() - t_start:.1f} s")
    e, q = entry_points["e2e"], entry_points["int8"]
    c, h = q["context"], entry_points["hf"]
    log(f"[summary] entry points: e2e at {PROMPT_LEN} x {BATCH} baseline "
        f"{e['baseline_tokens_per_sec']} / shadow "
        f"{e['shadowkv_tokens_per_sec']} tok/s = {e['speedup']}x (prefill_s "
        f"{e['prefill_s']}); int8 weights {q['decode_tok_s']:.2f} tok/s, peak "
        f"{q['peak_gib']:.2f} GiB against bf16 {q['bf16_decode_tok_s']:.2f} "
        f"tok/s, {q['bf16_peak_gib']:.2f} GiB; context {c['file_gib']:.3f} "
        f"GiB saved in {c['save_s']:.2f} s, loaded in {c['load_s_shadow']:.2f}"
        f" s (host V {c['load_s_offload']:.2f} s) against prefill_s "
        f"{c['prefill_s']:.2f}; HF load {h['load_s_none']:.2f} s "
        f"({h['load_gb_s_none']:.2f} GB/s); phase {entry_points['seconds']:.1f} s")
    tt, tb, tx = training["tiny"], training["bench"], training["text"]
    log(f"[summary] training: tiny oracle {tt['steps_per_s']:.3f} steps/s "
        f"(dense ctx {tt['ctx']} x {tt['batch']}), peak {tt['peak_gib']:.2f} "
        f"GiB, loss {tt['loss_first20']:.4f} -> {tt['loss_last20']:.4f}, "
        f"card vs CPU loss {tt['parity']['card']['loss_rel']:.2e} grads "
        f"{tt['parity']['card']['grad_rel_rms_max']:.2e} (TF32 control "
        f"{tt['parity']['tf32']['grad_rel_rms_max']:.2e}); bench 1.4B step ms "
        f"{[round(x, 1) for x in tb['step_ms']]}, peak {tb['peak_gib']:.2f} "
        f"GiB; text shadow {tx['shadow']['text']!r} (hit rate "
        f"{tx['shadow']['hit_rate_mean']}), full {tx['full']['text']!r}, "
        f"truth {tx['full']['truth']!r}; phases {training['seconds']:.1f} s")
    log(f"[summary] k-exaone slice: {k_exaone['layers']} layers at "
        f"{K_EXAONE['prompt']} x {K_EXAONE['batch']}, prefill_s "
        f"{k_exaone['prefill_s']:.3f}, {k_exaone['step_ms']:.3f} ms a "
        f"replayed step, launches {k_exaone['launches']}")
    log("[summary] C, F, G at the tp=2 head slice (B 2, S "
        f"{GLOO_PROMPT}): " + ", ".join(
            f"{k} {ms:.4f} ms against bound {b_ms:.4f} ({by})"
            for k, (ms, b_ms, by) in shard.items()))
    log("[summary] parallel: tp1-nccl decode tok/s "
        f"{tp1['tok_s']} against single-device {tp1['ref_tok_s']}; " + ", ".join(
            f"{k} {r['summary']}" for k, r in par.items())
        + f"; total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": list(entries.values())}))
    print(facts["smi"])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": facts["name"],
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 5 and sys.argv[1] == "--parallel-rank":
        sys.exit(parallel_ranks(int(sys.argv[2]), int(sys.argv[3]),
                                sys.argv[4]))
    modes = {(): "all", ("--k-exaone",): "k-exaone", ("--select",): "select"}
    sys.exit(main(modes[tuple(sys.argv[1:])]))
