"""Probe the floating-point state of PyTorch's intra-op CPU threads.

A rare failure of ``tests/test_torch_refresh.py::test_refresh_matches_jax``
(ROADMAP.md §3) showed one intra-op thread's share of an f32 product about
2^-13 relative off. This probe looks, per thread share, for the causes
that live in a thread's state: flush-to-zero / denormals-are-zero (MXCSR
FTZ/DAZ: a denormal times 1.0 comes out 0), a rounding mode other than
round-to-nearest-even (MXCSR RC: 1 + 1.5 * 2^-24 rounds to 1 + 2^-23), and
a reduced-precision f32 product (the plain refresh's batched product
against float64, the error of each thread's share of the batch). It prints
the f32 matmul precision settings once and one JSON line per run.

    python -m shadowkv_tpu_torch.tools.fp_state_probe --iters 2000

Run several at once to load the machine as a test suite's workers do.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=1000)
    ap.add_argument("--seed", type=int, default=10)
    args = ap.parse_args()
    threads = torch.get_num_threads()
    n = threads * (1 << 16)  # one share of 64K elements per thread
    denorm = torch.full((n,), 1e-40)
    one = torch.ones(n)
    half_ulp = torch.full((n,), 1.5 * 2.0**-24)
    rng = np.random.default_rng(args.seed)
    m = 8 * threads  # batched products, 8 per thread share
    u = rng.standard_normal((m, 16, 32)).astype(np.float32)
    sv = (rng.standard_normal((m, 32, 128)) * 0.1).astype(np.float32)
    ref = np.einsum("mcr,mrd->mcd", u.astype(np.float64), sv.astype(np.float64))
    u_t, sv_t = torch.from_numpy(u), torch.from_numpy(sv)
    flushed = np.zeros(threads, np.int64)
    rounded = np.zeros(threads, np.int64)
    worst = np.zeros(threads)
    for _ in range(args.iters):
        f = ((denorm * 1.0) == 0).view(threads, -1).any(-1).numpy()
        r = ((one + half_ulp) != 1.0 + 2.0**-23).view(threads, -1).any(-1)
        flushed += f
        rounded += r.numpy()
        err = np.abs(torch.bmm(u_t, sv_t).numpy() - ref).max(axis=(1, 2))
        worst = np.maximum(worst, (err / np.abs(ref).max()).reshape(
            threads, -1).max(-1))
    mkldnn = getattr(torch.backends.mkldnn, "matmul", None)
    print(json.dumps({
        "pid": os.getpid(), "threads": threads, "iters": args.iters,
        "float32_matmul_precision": torch.get_float32_matmul_precision(),
        "mkldnn_matmul_fp32_precision": getattr(mkldnn, "fp32_precision",
                                                None),
        "ftz_daz_shares": flushed.tolist(),
        "non_rne_shares": rounded.tolist(),
        "worst_rel_err_by_share": worst.tolist(),
    }))


if __name__ == "__main__":
    main()
