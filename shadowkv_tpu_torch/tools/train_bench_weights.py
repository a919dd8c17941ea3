"""Train the bench-shape 1.4B Llama just far enough for organic decode-time
selection locality, on the card (counterpart of the JAX repo's
``scripts/train_bench_weights.py``).

Synthetic weights churn the shadow cache's chunk selection (a ~7 % slot
hit rate at 32K on the card); real attention is temporally stable, which is
what the slot-stable selection and kernel A's hit/miss split exist for.
Retrieval competence is not the bar, temporally stable attention is: a few
hundred steps at the exact bench geometry (16 layers, d 2048, 16 / 8
heads of 128, MLP 5632, vocab 32768, RoPE theta 5e5, bf16) on dense
associative recall (``tools/train_tiny_model.py``'s samples) alternating
with a heterogeneous topic-section stream, then an npz snapshot in the JAX
package's format (``params.npz``) and a long prompt stream from the same
distribution (``prompt.npy``), which ``tools/profile_slice.py --weights``
reads.

The optimizer is this module's ``Adafactor``: ``optax.chain(
clip_by_global_norm(1.0), adafactor(schedule, min_dim_size_to_factor=128,
multiply_by_parameter_scale=False, clipping_threshold=None))`` written
out, with f32 statistics (optax keeps them in the parameter dtype, bf16
here) and each update applied in the parameter dtype.

Usage (the card by default; ``--smoke`` is a 2-layer f32 model):

    python -m shadowkv_tpu_torch.tools.train_bench_weights \\
        [--out checkpoints/bench1p4b] [--steps 400] [--ctx 2048] [--batch 2]
    python -m shadowkv_tpu_torch.tools.train_bench_weights --smoke \\
        --device cpu --steps 2 --ctx 128 --batch 1 --out /tmp/x
"""

from __future__ import annotations

import argparse
import os
import random
import time

import numpy as np
import torch

from shadowkv_tpu_torch.data.wordlists import adjective_noun_words
from shadowkv_tpu_torch.models.registry import toy_config
from shadowkv_tpu_torch.tools.train_tiny_model import (
    Optimizer,
    Trainer,
    answer_accuracy,
    clip_by_global_norm,
    make_samples_dense,
    warmup_cosine_decay_schedule,
)


def bench_model_config(smoke: bool = False):
    """The bench's ``sbench-1.4b-llama`` shape exactly (its RoPE tables and
    head layout must match the trained weights), or a 2-layer f32 smoke
    model."""
    if smoke:
        return toy_config(
            name="sbench-smoke", num_layers=2, hidden_size=256, num_heads=4,
            num_kv_heads=2, head_dim=64, intermediate_size=512,
            vocab_size=32768, rope_theta=500000.0, dtype=torch.float32)
    return toy_config(
        name="sbench-1.4b-llama", num_layers=16, hidden_size=2048,
        num_heads=16, num_kv_heads=8, head_dim=128, intermediate_size=5632,
        vocab_size=32768, rope_theta=500000.0, dtype=torch.bfloat16)


def build_prompt_stream(tokenizer, n_tokens: int, seed: int) -> np.ndarray:
    """One long heterogeneous token stream [n_tokens] int32: sections that
    each draw from one of 16 disjoint word pools in one of five formats,
    with needle and query lines woven in. Chunks that differ systematically
    keep the top-k chunk set stable between decode steps; a homogeneous
    needle stream left every chunk alike in the JAX repo's first
    attempt."""
    words = adjective_noun_words()
    rng = random.Random(seed)
    n_pools = 16
    pools = [words[i::n_pools] for i in range(n_pools)]
    fmts = [
        "The {a} {b} considered the {c} near the {d}.\n",
        "- item {v}: {a} {b} ({c})\n",
        "{a}={v}; {b}={v2}; note: {c} {d}\n",
        "In chapter {v}, the {a} {b} travelled to the {c} {d}.\n",
        "One of the special magic numbers for {a}-{b} is: {v}.\n",
    ]
    toks: list[int] = []
    pairs: list[tuple[str, str]] = []
    while len(toks) < n_tokens:
        pool = pools[rng.randrange(n_pools)]
        fmt = fmts[rng.randrange(len(fmts))]
        section = []
        for _ in range(rng.randint(8, 20)):
            a, b, c, d = (rng.choice(pool) for _ in range(4))
            v, v2 = rng.randint(1000, 9999999), rng.randint(10, 999)
            line = fmt.format(a=a, b=b, c=c, d=d, v=v, v2=v2)
            if "magic" in line:
                pairs.append((f"{a}-{b}", str(v)))
            section.append(line)
        if pairs and rng.random() < 0.2:
            k, v = rng.choice(pairs)
            section.append(
                f"What is the special magic number for {k} mentioned "
                "in the provided text? The special magic number for "
                f"{k} mentioned in the provided text is {v}.\n"
            )
        toks.extend(tokenizer.encode("".join(section),
                                     add_special_tokens=False))
    return np.asarray(toks[:n_tokens], np.int32)


def het_batch(het: np.ndarray, rng: np.random.RandomState, batch: int,
              ctx: int):
    """``batch`` windows of ``ctx`` tokens at random starts of the stream,
    every token a filler target (mask 1)."""
    starts = rng.randint(0, len(het) - ctx, batch)
    ids = np.stack([het[s : s + ctx] for s in starts])
    return ids, np.ones_like(ids)


def _factored_dims(shape, min_dim_size_to_factor: int):
    """optax's: the two largest dims (second-largest, largest) when the
    smaller of them is at least ``min_dim_size_to_factor``, else None."""
    if len(shape) < 2:
        return None
    order = np.argsort(shape)
    if shape[order[-2]] < min_dim_size_to_factor:
        return None
    return int(order[-2]), int(order[-1])


class Adafactor(Optimizer):
    """``optax.chain(clip_by_global_norm(1.0), adafactor(schedule,
    min_dim_size_to_factor=128, multiply_by_parameter_scale=False,
    clipping_threshold=None))``: decay rate 0.8 (the second moment's decay
    1 - (t + 1)^-0.8), eps 1e-30 added to the squared gradient, no
    momentum, no weight decay. A leaf whose two largest dims are both >=
    128 keeps a row and a column mean of the squared gradient (over the
    largest dim and over the second largest), any other leaf a full
    second moment; statistics in f32, the update applied in the parameter
    dtype."""

    decay_rate, eps, min_dim_size_to_factor, max_norm = 0.8, 1e-30, 128, 1.0

    def __init__(self, params: list, schedule):
        self.params = list(params)
        self.schedule = schedule
        self.dims, self.stats = [], []
        for p in self.params:
            dims = _factored_dims(tuple(p.shape), self.min_dim_size_to_factor)
            self.dims.append(dims)
            z = dict(dtype=torch.float32, device=p.device)
            if dims is None:
                self.stats.append((torch.zeros(p.shape, **z),))
            else:
                d1, d0 = dims
                row = [n for i, n in enumerate(p.shape) if i != d0]
                col = [n for i, n in enumerate(p.shape) if i != d1]
                self.stats.append((torch.zeros(row, **z),
                                   torch.zeros(col, **z)))
        self.count = 0

    @torch.no_grad()
    def updates(self, grads: list) -> list:
        grads = clip_by_global_norm(grads, self.max_norm)
        t = float(np.float32(self.count + 1))
        rho = float(np.float32(1.0) - np.float32(t) ** np.float32(
            -self.decay_rate))
        lr = self.schedule(self.count)
        out = []
        for g, dims, st in zip(grads, self.dims, self.stats):
            g = g.float()
            gsq = g * g + self.eps
            if dims is None:
                (v,) = st
                v.copy_(rho * v + (1.0 - rho) * gsq)
                u = g * v**-0.5
            else:
                d1, d0 = dims
                vr, vc = st
                vr.copy_(rho * vr + (1.0 - rho) * gsq.mean(d0))
                vc.copy_(rho * vc + (1.0 - rho) * gsq.mean(d1))
                rd1 = d1 - 1 if d1 > d0 else d1
                row_factor = (vr / vr.mean(rd1, keepdim=True)) ** -0.5
                col_factor = vc**-0.5
                u = g * row_factor.unsqueeze(d0) * col_factor.unsqueeze(d1)
            out.append(-lr * u)
        self.count += 1
        return out


def bench_trainer(cfg, params, lr: float, steps: int, max_ctx: int,
                  chunk: int = 512) -> Trainer:
    """The bench trainer: Adafactor over a warmup of max(2, steps / 8) and
    a cosine decay over warmup + 4 x ``steps`` down to lr / 10; loss
    ``ans + 0.3 * fill``."""
    warm = max(2, steps // 8)
    sched = warmup_cosine_decay_schedule(0.0, lr, warm, warm + 4 * steps,
                                         end_value=lr * 0.1)
    return Trainer(cfg, params, lambda leaves: Adafactor(leaves, sched),
                   max_ctx, fill_weight=0.3, chunk=chunk)


def main(argv=None) -> dict:
    from transformers import AutoTokenizer

    from shadowkv_tpu_torch.models.params import (
        init_synthetic_params,
        save_params_npz,
    )
    from shadowkv_tpu_torch.tools.make_tiny_checkpoint import (
        build_tiny_checkpoint,
    )

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="checkpoints/bench1p4b")
    ap.add_argument("--steps", type=int, default=400,
                    help="max steps per phase (phases advance early on the "
                         "dense-recall probe)")
    ap.add_argument("--ctx", type=int, default=2048)
    ap.add_argument("--batch", type=int, default=2)
    # LR couples to width: 7e-4 never formed the circuit at width 1024 in
    # the JAX repo's runs, 3e-4 did; 1e-3 at 2048 plateaued.
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--prompt-tokens", type=int, default=262144)
    ap.add_argument("--smoke", action="store_true", default=False)
    ap.add_argument("--tokenizer", default="checkpoints/tiny-llama-trained",
                    help="the tiny checkpoint whose tokenizer is used "
                         "(built there if missing)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = torch.device(args.device)

    tokenizer = AutoTokenizer.from_pretrained(
        build_tiny_checkpoint(args.tokenizer), local_files_only=True)
    cfg = bench_model_config(args.smoke)
    params = init_synthetic_params(
        cfg, torch.Generator(device=device).manual_seed(args.seed),
        device=device)
    tr = bench_trainer(cfg, params, args.lr, args.steps, args.ctx)

    if args.smoke:
        phases = [(args.ctx, args.batch, args.steps, 0.5)]
    else:
        phases = [(512, args.batch * 4, args.steps * 2, 0.5),
                  (1024, args.batch * 2, args.steps, 0.45),
                  (args.ctx, args.batch, args.steps, 0.4)]
    rng = np.random.RandomState(args.seed)
    het = build_prompt_stream(tokenizer, 400_000, seed=args.seed + 17)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.time()
    step = 0
    for ctx, batch, n_steps, bar in phases:
        print(f"-- phase ctx={ctx} batch={batch} steps<={n_steps} "
              f"bar={bar}", flush=True)
        for i_phase in range(n_steps):
            if i_phase % 2 == 1:
                ids, mask = het_batch(het, rng, batch, ctx)
            else:
                ids, mask = make_samples_dense(
                    tokenizer, batch, ctx, seed=int(rng.randint(0, 2**31)))
            _, ans, fill = tr.step(ids, mask)
            if step % 20 == 0:
                print(f"step {step:5d} ans {float(ans):.4f} "
                      f"fill {float(fill):.4f} ({time.time() - t0:.0f}s)",
                      flush=True)
            step += 1
            if i_phase and i_phase % 50 == 0:
                ids, mask = make_samples_dense(tokenizer, 8, ctx,
                                               seed=9_000_000 + step)
                acc = answer_accuracy(tr.probe(ids), ids, mask, True)
                print(f"  dense-acc@{ctx}: {acc:.3f}", flush=True)
                if acc >= bar:
                    print(f"  phase {ctx} done early at {step}", flush=True)
                    break
    wall = time.time() - t0
    peak = (torch.cuda.max_memory_allocated(device) / 2**30
            if device.type == "cuda" else None)
    os.makedirs(args.out, exist_ok=True)
    del tr  # the optimizer state, before the host copy
    save_params_npz(params, os.path.join(args.out, "params.npz"))
    prompt = build_prompt_stream(tokenizer, args.prompt_tokens,
                                 seed=args.seed + 1)
    np.save(os.path.join(args.out, "prompt.npy"), prompt)
    print(f"saved {args.out}/params.npz + prompt.npy ({prompt.shape[0]} "
          f"toks): {step} steps in {wall:.1f} s ({step / wall:.3f} steps/s),"
          f" peak {peak} GiB, {time.time() - t0:.0f} s total", flush=True)
    return dict(out=args.out, steps=step, wall_s=wall, peak_gib=peak)


if __name__ == "__main__":
    main()
