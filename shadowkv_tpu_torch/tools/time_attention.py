"""Time the prefill attention kernels B, C, F and G at the slice's shapes.

Builds the kernels of the ``shadowkv_tpu_torch`` package on the import
path, then times on one GPU (CUDA events, the mean of ``--reps`` launches
after one warm-up):

- B: causal GQA prefill, q [2, 32768, 32, 128], k/v [2, 32768, 8, 128];
- C: the same under window 8192, sink 1024 (the JAX defaults);
- F and G: q [64, 32768, 128], k/v [16, 32768, 128] with flags estimated
  from the same random q/k at the JAX default sizes (1000 verticals, 6144
  slashes, block 128), as the slice's ``vs`` prefill makes them.

Inputs come from ``--seed``. Prints one JSON line: the device, the
package's path and each kernel's ms. Two checkouts are compared in one
call by running this file with each on ``PYTHONPATH`` in turns:

    PYTHONPATH=<checkout> python shadowkv_tpu_torch/tools/time_attention.py
"""

from __future__ import annotations

import argparse
import json

import torch

import shadowkv_tpu_torch
from shadowkv_tpu_torch.core import minference as mi
from shadowkv_tpu_torch.kernels import prefill_attention, vs_sparse, vs_tile


def _ms(fn, reps: int) -> float:
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("time_attention needs a CUDA device")
    b, s, h, kh, dh, block = 2, 32768, 32, 8, 128, 128
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    q, k, v = (torch.randn(b, s, n, dh, device="cuda", generator=gen,
                           dtype=torch.bfloat16) for n in (h, kh, kh))
    ms = {
        "B": _ms(lambda: prefill_attention.causal_prefill_splash(q, k, v),
                 args.reps),
        "C": _ms(lambda: prefill_attention.sparse_prefill_splash(
            q, k, v, 8192, 1024), args.reps),
    }
    vert, sl = mi.estimate_vertical_slash(q, k)
    v_idx = mi.top_k(vert.reshape(b * h, s), 1000)
    col, dflag = mi.vs_flags(v_idx, mi.top_k(sl.reshape(b * h, s), 6144),
                             s // block, block)
    meta = mi.meta_from_flags(col, dflag)
    del vert, sl
    q_f, k_f, v_f = (mi.flat_heads(t, s) for t in (q, k, v))
    del q, k, v
    kv_map = mi.kv_map_of(b, kh, range(h), h // kh, "cuda")
    kw = dict(block=block, scale=dh**-0.5, seq_len=s)
    ms["F"] = _ms(lambda: vs_tile.vs_tile_attention(
        q_f, k_f, v_f, v_idx, dflag, kv_map, **kw), args.reps)
    ms["G"] = _ms(lambda: vs_sparse.vs_sparse_attention(
        q_f, k_f, v_f, meta.col_ids, meta.col_cnt, meta.col_flag,
        meta.diag_ids, meta.diag_cnt, kv_map, **kw), args.reps)
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "package": shadowkv_tpu_torch.__path__[0],
                      "ms": ms}), flush=True)


if __name__ == "__main__":
    main()
