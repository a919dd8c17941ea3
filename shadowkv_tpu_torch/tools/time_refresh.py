"""Time kernel A (``sparse_refresh``) at the slice's shapes with a cold L2.

Builds the kernels of the ``shadowkv_tpu_torch`` package on the import
path, then times on one GPU the refresh of the Llama-3.1-8B slice's layers
(B 2, 8 KV heads, head_dim 128, a 32768-token prompt in 2040 chunks of 16,
rank 160, int8 stores, 128 select sets: ``CacheConfig(sparse_budget=2048,
rank=160, chunk_size=16, kv_quant="int8")``):

- with the V store on the card and pinned in host memory;
- at two miss mixes: "mixed heads" (per (b, kv head) in turn all hits, all
  misses scattered, all misses in one contiguous run of chunk ids, half the
  slots kept) and "40% missed" (every head replaces 51 of its 128 chunks).

Each time is the profiler's device time per launch over ``--reps``
launches that cycle over the 32 layers of stacked stores (~2.5 GB), so no
launch finds its rows in the 50 MB L2, as in a decode step. The warm-L2
time of one layer over and over (the yardstick of the first versions) is
printed beside it. Inputs come from ``--seed``. Prints one JSON line: the
device, the package's path and the times in ms. Two checkouts are compared
in one call by running this file with each on ``PYTHONPATH`` in turns:

    PYTHONPATH=<checkout> python shadowkv_tpu_torch/tools/time_refresh.py
"""

from __future__ import annotations

import argparse
import json

import torch

import shadowkv_tpu_torch
from shadowkv_tpu_torch.cache.shadow import ShadowLayout
from shadowkv_tpu_torch.config import CacheConfig
from shadowkv_tpu_torch.core.quant import quantize_store
from shadowkv_tpu_torch.core.rope import inv_freq_full_neox
from shadowkv_tpu_torch.core.selection import assign_slots_stable, compact_misses
from shadowkv_tpu_torch.kernels.reconstruct import sparse_refresh
from shadowkv_tpu_torch.models.registry import llama31_8b

PROMPT_LEN = 32768
BATCH = 2


def slice_config():
    """(model config, shadow layout) of the slice."""
    cfg = llama31_8b("meta-llama/Llama-3.1-8B-Instruct", dtype=torch.bfloat16)
    lay = ShadowLayout.build(
        CacheConfig(mode="shadow", max_length=PROMPT_LEN, sparse_budget=2048,
                    rank=160, chunk_size=16, kv_quant="int8",
                    gen_capacity=256),
        PROMPT_LEN,
    )
    return cfg, lay


def refresh_inputs(cfg, lay, batch, layers, quant, gen, device="cuda"):
    """Stacked stores at the slice's per-layer shapes plus a miss list with
    all-hit heads, all-miss heads, contiguous runs and partial overlap (the
    "mixed heads" mix)."""
    kh, dh, cs = cfg.num_kv_heads, cfg.head_dim, lay.chunk_size
    n_rows, s = lay.chunks * cs, lay.select_sets
    rank = lay.rank
    u_f = torch.randn(layers, batch, n_rows, rank, device=device,
                      generator=gen, dtype=torch.bfloat16)
    v_f = torch.randn(layers, batch, kh, n_rows, dh, device=device,
                      generator=gen, dtype=torch.bfloat16)
    sv = (0.05 * torch.randn(layers, batch, kh, rank, dh, device=device,
                             generator=gen)).to(torch.bfloat16)
    if quant:
        u, u_sc = quantize_store(u_f)
        v, v_sc = quantize_store(v_f)
        del u_f, v_f
    else:
        u, v, u_sc, v_sc = u_f, v_f, None, None
    cap = lay.buffer_cap
    k_buf = torch.randn(layers, batch, kh, cap, dh, device=device,
                        generator=gen, dtype=torch.bfloat16)
    v_buf = torch.randn(layers, batch, kh, cap, dh, device=device,
                        generator=gen, dtype=torch.bfloat16)

    c = lay.chunks
    prev = torch.stack([
        torch.randperm(c, device=device, generator=gen)[:s]
        for _ in range(batch * kh)
    ]).reshape(batch, kh, s).to(torch.int32)
    new = prev.clone()
    for bk in range(batch * kh):
        b_, k_ = divmod(bk, kh)
        kind = bk % 4
        if kind == 0:  # all hits
            continue
        others = torch.randperm(c, device=device, generator=gen)
        others = others[~torch.isin(others, prev[b_, k_].long())]
        if kind == 1:  # all misses, scattered
            new[b_, k_] = others[:s].to(torch.int32)
        elif kind == 2:  # all misses, one contiguous run of chunk ids
            start = int(torch.randint(0, c - 2 * s, (1,), device=device,
                                      generator=gen))
            run = torch.arange(start, start + s, device=device)
            prev[b_, k_] = (run + s).to(torch.int32)
            new[b_, k_] = run.to(torch.int32)
        else:  # half the slots stay
            keep = prev[b_, k_][: s // 2]
            new[b_, k_] = torch.cat([keep, others[: s - s // 2].to(torch.int32)])
    asg = assign_slots_stable(prev, new)
    mc, ms, cnt = compact_misses(asg.slot_ids, asg.stay_mask)
    return dict(u=u, sv=sv, v_full=v, k_buf=k_buf, v_buf=v_buf,
                u_scale=u_sc, v_scale=v_sc, mc=mc, ms=ms, cnt=cnt)


def miss_fraction_lists(lay, batch, kh, frac, gen, device="cuda"):
    """Miss lists in which every (b, kv head) keeps S - round(frac * S) of
    its chunks and takes new ones in the other slots."""
    c, s = lay.chunks, lay.select_sets
    n_new = round(frac * s)
    prev, new = [], []
    for _ in range(batch * kh):
        perm = torch.randperm(c, device=device, generator=gen)
        prev.append(perm[:s])
        new.append(torch.cat([perm[:s - n_new], perm[s:s + n_new]]))
    shape = (batch, kh, s)
    asg = assign_slots_stable(torch.stack(prev).reshape(shape).to(torch.int32),
                              torch.stack(new).reshape(shape).to(torch.int32))
    return compact_misses(asg.slot_ids, asg.stay_mask)


def refresh_bytes_ops(t, lay, dh):
    """(bytes, operations, missed chunks) the refresh must move and do for
    this miss list: each missed chunk's V rows (+ scales) read once per head
    and its U rows (+ scales) once per batch row, its K and V rows written
    once, SV read once per head with misses, the miss lists."""
    cs, rank = lay.chunk_size, lay.rank
    cnt = t["cnt"].long()
    misses = int(cnt.sum())
    heads = int((cnt > 0).sum())
    quant = t["u_scale"] is not None
    store_b = 1 if quant else 2
    rows = misses * cs
    # U (and its scales) is shared by the KV heads of a batch row: a chunk
    # missed by several heads of one row needs its U rows read once.
    b, kh, s = t["mc"].shape
    valid = torch.arange(s, device=cnt.device) < cnt[..., None]
    row_of = torch.arange(b, device=cnt.device)[:, None, None].expand(b, kh, s)
    u_chunks = int(torch.unique(
        (row_of * lay.chunks + t["mc"].long())[valid]).numel())
    u_rows = u_chunks * cs
    nbytes = u_rows * rank * store_b + rows * dh * store_b
    if quant:
        nbytes += (u_rows + rows) * 2
    nbytes += rows * dh * 2 * 2  # K and V rows written, bf16
    nbytes += heads * rank * dh * 2
    nbytes += t["mc"].numel() * 4 * 2 + t["cnt"].numel() * 4 + dh * 4
    ops = 2 * rows * rank * dh
    return nbytes, ops, misses


def device_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of ``fn``: the summed durations of the CUDA kernels
    and copies it runs, from ``torch.profiler`` over ``reps`` calls (CUDA
    events around launches of a few microseconds measure the host's
    enqueue rate instead)."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.time_range.end - e.time_range.start for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA)
    if us <= 0:
        raise RuntimeError("the profiler recorded no device time")
    return us / reps / 1e3


def cycle_layers(fn, layers: int):
    """``fn(layer)`` over layers 0, 1, ... in turn: stacked layers of
    stores larger than the 50 MB L2 keep each launch's reads cold."""
    it = iter(range(10**9))
    return lambda: fn(next(it) % layers)


def time_mixes(cfg, lay, t, v_host, inv, mixes, reps: int = 64) -> dict:
    """{mix: {"device": ms, "host": ms}}: cold-L2 device time per launch of
    each miss list of ``mixes`` ({label: (mc, ms, cnt)}) with the V store
    ``t["v_full"]`` on the card and ``v_host`` pinned on the host."""
    kw = dict(chunk_size=lay.chunk_size, sparse_start=lay.sparse_start,
              rope_dim=cfg.head_dim, rope_style="neox",
              u_scale=t["u_scale"], v_scale=t["v_scale"])
    out = {}
    for label, (mc, ms_, cnt) in mixes.items():
        out[label] = {
            place: device_ms(cycle_layers(
                lambda lyr, v=v: sparse_refresh(
                    lyr, mc, ms_, cnt, t["u"], t["sv"], v, inv, t["k_buf"],
                    t["v_buf"], **kw),
                t["u"].shape[0]), reps=reps)
            for place, v in (("device", t["v_full"]), ("host", v_host))
        }
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("time_refresh needs a CUDA device")
    cfg, lay = slice_config()
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    t = refresh_inputs(cfg, lay, BATCH, cfg.num_layers, True, gen)
    v_host = torch.empty(t["v_full"].shape, dtype=t["v_full"].dtype,
                         pin_memory=True)
    v_host.copy_(t["v_full"])
    inv = inv_freq_full_neox(cfg).to("cuda")
    mixes = {"mixed heads": (t["mc"], t["ms"], t["cnt"]),
             "40% missed": miss_fraction_lists(lay, BATCH, cfg.num_kv_heads,
                                               0.4, gen)}
    ms = time_mixes(cfg, lay, t, v_host, inv, mixes, args.reps)
    mc, ms_, cnt = mixes["mixed heads"]
    ms["mixed heads"]["device, warm L2"] = device_ms(lambda: sparse_refresh(
        cfg.num_layers - 1, mc, ms_, cnt, t["u"], t["sv"], t["v_full"], inv,
        t["k_buf"], t["v_buf"], chunk_size=lay.chunk_size,
        sparse_start=lay.sparse_start, rope_dim=cfg.head_dim,
        u_scale=t["u_scale"], v_scale=t["v_scale"]), args.reps)
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "package": shadowkv_tpu_torch.__path__[0],
                      "ms": ms}), flush=True)


if __name__ == "__main__":
    main()
