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
   overlap; one bf16-store case and one glm partial-RoPE case; timed with a
   cold L2 (each launch refreshes the next of 32 stacked layers, as a
   decode step does), the warm-L2 time of one layer beside it. Then A with
   the V store pinned in host memory (``shadow_offload``), held to the same
   tolerances and timed, with the store on the card beside it, at that mix
   and at 40 % missed slots (``tools/time_refresh.py``'s inputs).
5. Kernel B (causal GQA prefill attention) against its plain version at
   B 1 / S 4104 (ragged tile) and at the main path's shape, B 2 / S 32768,
   H 32 / KV 8, with a per-row tolerance that is shown to reject a skipped
   KV tile; timed at the main path's shape, with SDPA as a yardstick only.
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
9. A toy bf16 engine on the card against the same engine on the CPU
   (plain kernel versions) for the four decode strategies (fused refresh,
   XLA-gather, and both over an offloaded V store), the full baseline and
   the sparse prefills on the full cache (stream with a window below the
   prompt, vs tile, vs walk, a per-layer vs table): the logits of the
   prefill and of eight decode steps fed the CPU's greedy tokens, the
   greedy tokens wherever the CPU's choice is not a near-tie, and the
   final cached chunk ids.
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
   Kernel launch counts are reset just before each run and asserted just
   after (C, F or G once per layer and prefill sub-batch, B none in those
   runs); each offload run's tokens and final cached ids equal its HBM
   twin's, its device cache is at least 1.9 GiB smaller and its host store
   is the int8 V store's 1.99 GiB.

The line before the card line is a JSON object with every kernel's
numbers; the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

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
    ]
    for label, case_cfg, quant in cases:
        rope_style, rope_dim, inv = "neox", cfg.head_dim, invf
        if case_cfg is None:  # GLM-4 style: interleaved RoPE on 64 lanes
            from shadowkv_tpu_torch.models.registry import glm4_9b

            glm = glm4_9b("glm-4-9b-chat-1m")
            rope_style, rope_dim = glm.rope_style, glm.rope_dim
            inv = inv_freq_full_neox(glm).to(DEVICE)
        layers = cfg.num_layers if label == "int8" else 2
        lyr = layer if label == "int8" else 1
        t = refresh_inputs(cfg, lay, BATCH, layers, quant, gen)
        kw = dict(chunk_size=lay.chunk_size, sparse_start=lay.sparse_start,
                  rope_dim=rope_dim, rope_style=rope_style,
                  u_scale=t["u_scale"], v_scale=t["v_scale"])
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
            f"{t['cnt'].numel() * lay.select_sets} slots; max_abs_err K "
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


def check_refresh_host(torch, cfg, lay, link: float, layer: int = 31) -> dict:
    """Kernel A with the V store pinned in host memory: the int8 inputs and
    miss mix of ``check_refresh``, held to A's tolerances against the plain version (which
    reads the same bytes from a device copy); timed at that mix and at
    40 % missed slots, cycling over the 32 layers so no launch finds its V
    rows in L2. The device store is timed the same way beside it."""
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
    t = refresh_inputs(cfg, lay, BATCH, cfg.num_layers, True, gen)
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
            f"{dev_b_ms:.4f}); both cold L2, cycling over {cfg.num_layers} "
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


def check_gather(torch, cfg, lay, link: float, layers: int = 8):
    """Kernel D against its plain version at the slice's per-layer shapes
    (B 2, 8 KV heads, 128 of 2040 chunks of 16 rows, rank 160) on int8
    stores, with V on the card and pinned in host memory, and on bf16
    stores; bit-equal. Timed on the int8 stores cycling over ``layers``
    stacked layers (cold L2), with two ``index_select`` calls that gather
    the same U and V rows as the yardstick of the device case. Returns
    (entry D, entry D with host V)."""
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
        u = torch.randn(layers, BATCH, n_rows, rank, device=DEVICE,
                        generator=gen, dtype=torch.bfloat16)
        v = torch.randn(layers, BATCH, kh, n_rows, dh, device=DEVICE,
                        generator=gen, dtype=torch.bfloat16)
        u_sc = v_sc = None
        if quant:
            u, u_sc = quantize_store(u)
            v, v_sc = quantize_store(v)
        ids = torch.stack([torch.randperm(c, device=DEVICE, generator=gen)[:s]
                           for _ in range(BATCH * kh)]).reshape(
                               BATCH, kh, s).to(torch.int32)
        v_host = pinned_copy(torch, v)
        layer = layers - 1
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
        if not quant:
            del u, v, v_host, ref, out
            continue
        plain_ms = device_ms(cycle_layers(lambda lyr: gather_chunks_plain(
            lyr, ids, u, v, u_sc, v_sc, chunk_size=cs), layers), reps=16)
        # The yardstick: index_select of the same U rows and V rows (not
        # their scales) from the flattened stores.
        rows = (ids.long()[..., None] * cs + torch.arange(cs, device=DEVICE))
        rows = rows.reshape(BATCH, kh, s * cs)
        bi = torch.arange(BATCH, device=DEVICE)[:, None, None]
        ki = torch.arange(kh, device=DEVICE)[None, :, None]
        u_idx = (bi * n_rows + rows).reshape(-1)
        v_idx = ((bi * kh + ki) * n_rows + rows).reshape(-1)
        u_flat, v_flat = u.reshape(layers, -1, rank), v.reshape(layers, -1, dh)
        lib_ms = device_ms(cycle_layers(lambda lyr: (
            torch.index_select(u_flat[lyr], 0, u_idx),
            torch.index_select(v_flat[lyr], 0, v_idx)), layers), reps=64)
        n_tok = BATCH * kh * s * cs
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
# the Hopper attention kernels (wgmma, TMA) and kernel A's main-path
# instance (int8 stores, 16-byte U rows: mma.sync, cp.async).
SASS_KERNELS = {
    "B, C": ("prefill_attention_kernel", "HGMMA", "UTMALDG"),
    "F": ("vs_tile_kernel", "HGMMA", "UTMALDG"),
    "G": ("vs_sparse_kernel", "HGMMA", "UTMALDG"),
    "A": ("refresh_kernelILb1ELi16E", "HMMA", "LDGSTS"),
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


def _vs_inputs(torch, vert, sl, s: int):
    """F's vertical ids [BH, 1000] and band flags, G's block metadata and
    column flags, from scores at the JAX default sizes (as
    minference_prefill(_tile) with every head vertical_and_slash)."""
    from shadowkv_tpu_torch.core import minference as mi

    vsz, ssz = mi.topk_sizes(VS["vs_vertical_size"], VS["vs_slash_size"], s)
    block = VS["vs_block"]
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
    TOY_STEPS]: the greedy token of the previous logits, or ``forced``."""
    logits, cache = eng.prefill(ids)
    out, fed = [logits[:, -1].float().cpu()], []
    for i in range(TOY_STEPS):
        tok = out[-1].argmax(-1) if forced is None else forced[:, i]
        fed.append(tok)
        logits = eng._decode(cache, tok.to(eng.device)[:, None])
        out.append(logits[:, -1].float().cpu())
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
    from shadowkv_tpu_torch.kernels.gather import gather_chunks
    from shadowkv_tpu_torch.kernels.prefill_attention import (
        causal_prefill_splash,
        sparse_prefill_splash,
    )
    from shadowkv_tpu_torch.kernels.reconstruct import sparse_refresh
    from shadowkv_tpu_torch.kernels.vs_sparse import vs_sparse_attention
    from shadowkv_tpu_torch.kernels.vs_tile import vs_tile_attention

    return {
        "sparse_refresh": (sparse_refresh, "launches"),
        "sparse_refresh_host_v": (sparse_refresh, "host_launches"),
        "prefill_attention": (causal_prefill_splash, "launches"),
        "sparse_prefill_attention": (sparse_prefill_splash, "launches"),
        "gather_chunks": (gather_chunks, "launches"),
        "gather_chunks_host_v": (gather_chunks, "host_launches"),
        "vs_tile_attention": (vs_tile_attention, "launches"),
        "vs_sparse_attention": (vs_sparse_attention, "launches"),
    }


def run_slice(torch, cfg, params, label: str, mode: str, rt_kw: dict,
              prompt_len: int) -> dict:
    """One Engine run at full width through batch_generate; returns its
    numbers, the kernel launch counts of the run, its tokens and its final
    cached chunk ids."""
    import numpy as np

    from shadowkv_tpu_torch.config import CacheConfig, RuntimeConfig
    from shadowkv_tpu_torch.models.engine import Engine

    cc = CacheConfig(mode=mode, max_length=prompt_len + 256,
                     sparse_budget=2048, rank=160, chunk_size=16,
                     kv_quant="int8", gen_capacity=256)
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
    toks, stats = eng.batch_generate(ids, gen_len=GEN_LEN, temperature=0.0,
                                     warmup_steps=WARMUP_STEPS)
    launches = {name: getattr(fn, attr)
                for name, (fn, attr) in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    kv = eng.kv_stats()
    steps = cfg.num_layers * (GEN_LEN + WARMUP_STEPS)
    sub_batches = math.ceil(BATCH / min(rt.prefill_sub_batch, BATCH))
    want = dict.fromkeys(counters, 0)
    pattern = rt.prefill_pattern
    prefill_kernel = PREFILL_KERNEL.get(
        rt.vs_impl if pattern == "vs" else pattern, "prefill_attention")
    want[prefill_kernel] = cfg.num_layers * sub_batches
    if mode != "full":
        kernel = "sparse_refresh" if rt_kw.get("use_pallas") else "gather_chunks"
        want[kernel] = steps
        if mode == "shadow_offload":
            want[kernel + "_host_v"] = steps
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
    )
    log(f"[slice {label}] {json.dumps(res)}")
    if launches != want:
        raise AssertionError(f"slice {label}: kernel launches {launches}, "
                             f"expected {want}")
    if toks.shape != (BATCH, GEN_LEN) or toks.min() < 0 \
            or toks.max() >= cfg.vocab_size:
        raise AssertionError(f"slice {label}: bad tokens {toks.shape}")
    res["tokens"] = toks
    res["cached_ids"] = (eng._cache.cached_ids.cpu()
                         if mode != "full" else None)
    del eng
    torch.cuda.empty_cache()
    return res


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


def main() -> int:
    # The flex_attention yardstick compiles in this process (no compile
    # workers to stop) into the checkout's gitignored build directory.
    build_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "shadowkv_tpu_torch", "build")
    os.environ.setdefault("TORCHINDUCTOR_COMPILE_THREADS", "1")
    os.environ.setdefault("TORCHINDUCTOR_CACHE_DIR",
                          os.path.join(build_dir, "inductor"))
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(build_dir, "triton"))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from shadowkv_tpu_torch.cache.shadow import ShadowLayout
    from shadowkv_tpu_torch.config import CacheConfig
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
    entries = {"sparse_refresh": check_refresh(torch, cfg, lay)}
    entries["sparse_refresh_host_v"] = check_refresh_host(torch, cfg, lay, link)
    entries["prefill_attention"] = check_prefill_attention(
        torch, cfg, evidence["B, C"])
    entries["sparse_prefill_attention"] = check_sparse_prefill(
        torch, cfg, evidence["B, C"])
    entries["gather_chunks"], entries["gather_chunks_host_v"] = check_gather(
        torch, cfg, lay, link)
    entries["vs_tile_attention"], entries["vs_sparse_attention"] = \
        check_vs_kernels(torch, cfg, evidence)
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
    # Each kernel's launches come from the run of the path that uses it.
    home = {"sparse_refresh": "shadow", "prefill_attention": "shadow",
            "sparse_refresh_host_v": "offload-fused",
            "gather_chunks": "shadow-ring",
            "gather_chunks_host_v": "offload-ring",
            "sparse_prefill_attention": "stream",
            "vs_tile_attention": "vs-tile", "vs_sparse_attention": "vs-walk"}
    for name, entry in entries.items():
        entry["launches"] = runs[home[name]]["launches"][name]
    log("[summary] prefill_s " + ", ".join(
        f"{k} {r['prefill_s']:.3f}" for k, r in runs.items())
        + f" (dense shadow {runs['shadow']['prefill_s']:.3f})")
    log("[summary] decode tok/s " + ", ".join(
        f"{k} {r['decode_tok_s']:.1f}" for k, r in runs.items())
        + f" at {PROMPT_LEN} x {BATCH}; total "
        f"{time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": list(entries.values())}))
    print(facts["smi"])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": facts["name"],
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
