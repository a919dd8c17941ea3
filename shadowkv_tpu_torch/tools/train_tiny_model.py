"""Train the tiny oracle to do retrieval on RULER niah-style data, on the
card (counterpart of the JAX repo's ``scripts/train_tiny_model.py``).

A random-weight model scores ~0 by design, so "shadow score == full score"
means something only for a model that can do the task. This tool trains
the 6 x 1024 Llama of ``tools/make_tiny_checkpoint.py`` to find
"One of the special magic numbers for <key> is: <digits>" and copy the
digits when <key> is queried, on data from the port's RULER generator
(``data/ruler/generate.py``) and its trained tokenizer, then saves it as
an HF checkpoint that ``LLM(model_dir=...)`` and ``entry/eval_acc.py``
load like any other.

The forward is the port's layer code (``models/forward.py``
``_layer_qkv`` / ``_layer_tail`` / ``_finalize(last_only=False)``) with a
plain causal attention that keeps the JAX trainer's roundings (f32 scores,
-1e30 mask, f32 softmax, P in V's dtype, f32 accumulation, query chunks of
512 under ``torch.utils.checkpoint``). No kernel of the port has a
backward; nor has any kernel of the JAX package. The optimizer is this
module's ``AdamW``: ``optax.chain(clip_by_global_norm(1.0),
adamw(warmup_cosine_decay_schedule(...)))`` at optax's defaults, written
out (torch's AdamW and ``clip_grad_norm_`` have other defaults). f32
matmuls run at torch's default precision (no TF32).

Usage (the card by default; ``--device cpu`` for a smoke run):

    python -m shadowkv_tpu_torch.tools.train_tiny_model \\
        [--out checkpoints/tiny-llama-trained] [--steps 1500] [--ctx 4096] \\
        [--batch 2] [--lr 7e-4]
    python -m shadowkv_tpu_torch.tools.train_tiny_model --device cpu \\
        --steps 2 --ctx 128 --out /tmp/x
"""

from __future__ import annotations

import argparse
import math
import random
import time

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from shadowkv_tpu_torch.config import ModelConfig
from shadowkv_tpu_torch.core import rope as rope_lib
from shadowkv_tpu_torch.core import wquant
from shadowkv_tpu_torch.core.layers import ModelParams
from shadowkv_tpu_torch.data.ruler.generate import generate_task
from shadowkv_tpu_torch.data.wordlists import adjective_noun_words
from shadowkv_tpu_torch.models.forward import (
    _finalize,
    _layer_qkv,
    _layer_tail,
)

# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------


def make_samples_dense(tokenizer, n: int, ctx: int, seed: int):
    """Dense associative recall in RULER's phrasing: needle lines, then a
    query over one of them teacher-forcing its value, repeated to ``ctx``.
    One niah sample carries ~4 answer tokens per 4K context, too sparse a
    gradient for the retrieval circuit to form; these carry dozens.

    Returns (ids [n, ctx], mask [n, ctx]) int32, mask 2 on query-answer
    tokens, 1 elsewhere, 0 on padding."""
    words = adjective_noun_words()
    rng = random.Random(seed)
    ids = np.zeros((n, ctx), np.int32)
    mask = np.zeros((n, ctx), np.int32)
    for i in range(n):
        pairs = []
        toks: list = []
        marks: list = []

        def put(text, answer=False):
            t = tokenizer.encode(text, add_special_tokens=False)
            toks.extend(t)
            marks.extend([2 if answer else 1] * len(t))

        while True:
            fresh = []
            for _ in range(rng.randint(2, 4)):
                k = rng.choice(words)
                v = str(rng.randint(1000000, 9999999))
                fresh.append((k, v))
                put(f"One of the special magic numbers for {k} is: {v}.\n")
            pairs.extend(fresh)
            k, v = rng.choice(pairs)
            put(
                f"What is the special magic number for {k} mentioned "
                "in the provided text? The special magic number for "
                f"{k} mentioned in the provided text is"
            )
            put(" " + v, answer=True)
            put(tokenizer.eos_token + "\n")
            if len(toks) > ctx - 40:
                break
        seq = toks[:ctx]
        ids[i, : len(seq)] = seq
        mask[i, : len(seq)] = marks[: len(seq)]
    return ids, mask


def make_samples(tokenizer, n: int, ctx: int, seed: int,
                 task: str = "niah_single_1"):
    """RULER samples packed to ``ctx`` tokens with the first reference
    answer and eos teacher-forced: (ids [n, ctx], mask [n, ctx]) int32,
    mask 2 on answer tokens, 1 on the prompt, 0 on padding."""
    rows = generate_task(task, tokenizer, num_samples=n,
                         max_seq_length=ctx - 8, seed=seed)
    ids = np.zeros((n, ctx), np.int32)
    mask = np.zeros((n, ctx), np.int32)
    for i, r in enumerate(rows):
        prompt = tokenizer.encode(r["input"], add_special_tokens=False)
        ans = tokenizer.encode(" " + r["outputs"][0] + tokenizer.eos_token,
                               add_special_tokens=False)
        seq = (prompt + ans)[:ctx]
        ids[i, : len(seq)] = seq
        a0 = min(len(prompt), ctx)
        mask[i, :a0] = 1
        mask[i, a0 : len(seq)] = 2
    return ids, mask


# ---------------------------------------------------------------------------
# differentiable forward
# ---------------------------------------------------------------------------


def _attend_chunk(qi, k, v, c0: int, scale: float):
    """One query chunk qi [B, c, K, G, Dh] at positions [c0, c0 + c) over
    k/v [B, S, K, Dh]: f32 scores, -1e30 past the diagonal, f32 softmax,
    P rounded to V's dtype, f32 accumulation, output in q's dtype."""
    c, s = qi.shape[1], k.shape[1]
    sc = torch.einsum("bqkgd,bskd->bkgqs", qi.float(), k.float()) * scale
    pos_q = c0 + torch.arange(c, device=qi.device)
    m = torch.arange(s, device=qi.device)[None, :] <= pos_q[:, None]
    sc = torch.where(m, sc, torch.full((), -1e30, device=sc.device))
    p = torch.softmax(sc, dim=-1).to(v.dtype)
    out = torch.einsum("bkgqs,bskd->bqkgd", p.float(), v.float())
    return out.to(qi.dtype)


def causal_attn(q, k, v, chunk: int = 512):
    """Differentiable causal GQA attention, q [B, S, H, Dh], k/v [B, S, K,
    Dh]: the queries padded to whole chunks of ``chunk`` rows, each chunk
    recomputed in the backward pass (the [B, H, chunk, S] scores are never
    kept)."""
    b, s, h, dh = q.shape
    kh = k.shape[2]
    qg = q.reshape(b, s, kh, h // kh, dh)
    nc = -(-s // chunk)
    if nc * chunk != s:
        qg = F.pad(qg, (0, 0, 0, 0, 0, 0, 0, nc * chunk - s))
    scale = dh**-0.5
    outs = []
    for c in range(nc):
        qi = qg[:, c * chunk:(c + 1) * chunk]
        if torch.is_grad_enabled():
            outs.append(checkpoint(_attend_chunk, qi, k, v, c * chunk, scale,
                                   use_reentrant=False))
        else:
            outs.append(_attend_chunk(qi, k, v, c * chunk, scale))
    return torch.cat(outs, dim=1)[:, :s].reshape(b, s, h, dh)


def full_logits(cfg: ModelConfig, params: ModelParams, ids, cos, sin,
                chunk: int = 512) -> torch.Tensor:
    """f32 logits at every position [B, S, V] of ids [B, S], through the
    port's layer code over the stacked [L, ...] leaves."""
    x = wquant.take_rows(params.embed, ids, cfg.dtype)
    for i in range(cfg.num_layers):
        lp = params.layer(i)
        q, k_r, _, v = _layer_qkv(cfg, lp, x, cos, sin)
        x = _layer_tail(lp, cfg, x, causal_attn(q, k_r, v, chunk))
    return _finalize(cfg, params, x, last_only=False)


def loss_terms(cfg: ModelConfig, params: ModelParams, ids, mask, cos_t,
               sin_t, fill_weight: float, chunk: int = 512):
    """(ans + fill_weight * fill, ans, fill): the next-token cross entropy
    averaged apart over answer tokens (mask 2) and the rest (mask 1), each
    over max(count, 1), so the few answer tokens are not drowned by the
    filler."""
    s = ids.shape[1]
    logits = full_logits(cfg, params, ids[:, : s - 1], cos_t[: s - 1],
                         sin_t[: s - 1], chunk)
    tgt = ids[:, 1:s].long()
    m = mask[:, 1:s]
    ll = F.cross_entropy(logits.flatten(0, 1), tgt.flatten(),
                         reduction="none").view(tgt.shape)
    w_ans = (m == 2).float()
    w_fill = (m == 1).float()
    ans = (ll * w_ans).sum() / w_ans.sum().clamp(min=1.0)
    fill = (ll * w_fill).sum() / w_fill.sum().clamp(min=1.0)
    return ans + fill_weight * fill, ans, fill


# ---------------------------------------------------------------------------
# optimizer (optax's, written out)
# ---------------------------------------------------------------------------


def named_leaves(params: ModelParams) -> list[tuple[str, torch.Tensor]]:
    """The trainable tensors by npz name (``models/params.py``)."""
    out = [("embed", params.embed)]
    out += [(f"layers.{f}", t) for f, t in params.layers._asdict().items()
            if t is not None]
    return out + [("final_norm", params.final_norm),
                  ("lm_head", params.lm_head)]


def warmup_cosine_decay_schedule(init_value: float, peak_value: float,
                                 warmup_steps: int, decay_steps: int,
                                 end_value: float = 0.0):
    """optax's: linear from ``init_value`` to ``peak_value`` over
    ``warmup_steps``, then a cosine to ``end_value`` at ``decay_steps``
    (which counts the warmup); the value at step ``count``, in f32
    arithmetic as optax computes it."""
    if decay_steps - warmup_steps <= 0:
        raise ValueError("decay_steps must exceed warmup_steps")
    f32 = np.float32
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    span = decay_steps - warmup_steps

    def schedule(count: int) -> float:
        if count < warmup_steps:
            frac = f32(1) - f32(min(max(count, 0), warmup_steps)) / f32(
                warmup_steps)
            return float(f32(init_value - peak_value) * frac + f32(peak_value))
        c = f32(min(count - warmup_steps, span))
        cosine = f32(0.5) * (f32(1) + np.cos(f32(np.pi) * c / f32(span)))
        return float(f32(peak_value) * (f32(1 - alpha) * cosine + f32(alpha)))

    return schedule


def clip_by_global_norm(grads: list, max_norm: float) -> list:
    """optax's ``clip_by_global_norm``: the gradients unchanged when their
    global norm is below ``max_norm``, else each divided by the norm and
    multiplied by ``max_norm`` (no epsilon, no host sync)."""
    norm = torch.stack([g.float().square().sum() for g in grads]).sum().sqrt()
    keep = norm < max_norm
    return [torch.where(keep, g, g / norm.to(g.dtype) * max_norm)
            for g in grads]


class Optimizer:
    """An optax-style transformation over a list of leaves: ``updates``
    gives each leaf's update and advances the state, ``step`` adds them to
    the leaves, the sum cast to each leaf's dtype (``optax.apply_updates``).
    """

    params: list

    @torch.no_grad()
    def step(self, grads: list) -> None:
        for p, u in zip(self.params, self.updates(grads)):
            p.copy_(p + u)


class AdamW(Optimizer):
    """``optax.chain(clip_by_global_norm(1.0), adamw(schedule))`` at optax's
    defaults (b1 0.9, b2 0.999, eps 1e-8, weight decay 1e-4 on every
    leaf): moments in the parameter dtype, bias correction by the
    incremented count, the schedule read at the count before the step."""

    b1, b2, eps, weight_decay, max_norm = 0.9, 0.999, 1e-8, 1e-4, 1.0

    def __init__(self, params: list, schedule):
        self.params = list(params)
        self.schedule = schedule
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = 0

    @torch.no_grad()
    def updates(self, grads: list) -> list:
        grads = clip_by_global_norm(grads, self.max_norm)
        c = np.float32(self.count + 1)
        bc1 = float(np.float32(1) - np.float32(self.b1) ** c)
        bc2 = float(np.float32(1) - np.float32(self.b2) ** c)
        lr = self.schedule(self.count)
        out = []
        for p, g, mu, nu in zip(self.params, grads, self.mu, self.nu):
            mu.copy_(self.b1 * mu + (1 - self.b1) * g)
            nu.copy_(self.b2 * nu + (1 - self.b2) * g * g)
            u = (mu / bc1) / ((nu / bc2).sqrt() + self.eps)
            out.append(-lr * (u + self.weight_decay * p))
        self.count += 1
        return out


# ---------------------------------------------------------------------------
# the training loop
# ---------------------------------------------------------------------------


class Trainer:
    """A model's params (leaf tensors that require grad), its optimizer and
    RoPE tables: ``step`` is one forward, backward and update."""

    def __init__(self, cfg: ModelConfig, params: ModelParams, make_opt,
                 max_ctx: int, fill_weight: float, chunk: int = 512):
        self.cfg, self.params = cfg, params
        self.fill_weight, self.chunk = fill_weight, chunk
        self.leaves = [t.requires_grad_(True) for _, t in named_leaves(params)]
        self.opt = make_opt(self.leaves)
        self.device = params.embed.device
        self.cos_t, self.sin_t = rope_lib.compute_cos_sin(
            cfg, max_ctx, device=self.device)

    def grads(self, ids, mask):
        """(loss, ans, fill, gradients) without an update."""
        loss, ans, fill = loss_terms(
            self.cfg, self.params,
            torch.as_tensor(ids, device=self.device).long(),
            torch.as_tensor(mask, device=self.device), self.cos_t,
            self.sin_t, self.fill_weight, self.chunk)
        grads = torch.autograd.grad(loss, self.leaves)
        return loss.detach(), ans.detach(), fill.detach(), list(grads)

    def step(self, ids, mask):
        """One optimizer step; returns (loss, ans, fill) on the device."""
        loss, ans, fill, grads = self.grads(ids, mask)
        self.opt.step(grads)
        return loss, ans, fill

    @torch.no_grad()
    def probe(self, ids) -> np.ndarray:
        """Teacher-forced greedy prediction at every position [n, S-1]."""
        ids = torch.as_tensor(ids, device=self.device).long()
        s = ids.shape[1]
        logits = full_logits(self.cfg, self.params, ids[:, : s - 1],
                             self.cos_t[: s - 1], self.sin_t[: s - 1],
                             self.chunk)
        return logits.argmax(-1).cpu().numpy()


def answer_accuracy(pred: np.ndarray, ids: np.ndarray, mask: np.ndarray,
                    per_token: bool) -> float:
    """Per answer token (``per_token``) or per sample (every answer token
    right) accuracy of teacher-forced predictions ``pred`` [n, S-1]."""
    ok = tot = 0
    for i in range(ids.shape[0]):
        hits = [pred[i, p - 1] == ids[i, p] for p in np.nonzero(mask[i] == 2)[0]]
        if per_token:
            ok += sum(hits)
            tot += len(hits)
        else:
            ok += int(all(hits))
            tot += 1
    return ok / max(tot, 1)


def retrieval_acc(trainer: Trainer, tokenizer, n: int, ctx: int, seed: int,
                  kind: str = "ruler") -> float:
    """'ruler': teacher-forced full-answer exact match per sample (a cheap
    proxy of the harness's greedy string score); 'dense': per-answer-token
    accuracy over the dense recall samples' queries."""
    mk = make_samples_dense if kind == "dense" else make_samples
    ids, mask = mk(tokenizer, n, ctx, seed=seed)
    return answer_accuracy(trainer.probe(ids), ids, mask, kind == "dense")


def curriculum(steps: int, ctx: int, batch: int) -> list:
    """(kind, ctx, batch, max steps) per phase: dense recall at 256 and 512
    (the gradient density the circuit needs to form), then RULER niah at a
    doubling context up to ``ctx`` with the batch shrinking as it grows;
    at ``ctx`` <= 1024 RULER niah alone."""
    if ctx <= 1024:
        return [("ruler", ctx, batch, steps)]
    phases = [("dense", 256, batch * 16, max(1, steps // 2)),
              ("dense", 512, batch * 8, max(1, steps // 2))]
    c = 1024
    while True:
        phases.append(("ruler", min(c, ctx), max(1, (batch * 4096) // c),
                       max(1, steps // (2 if c <= 2048 else 3))))
        if c >= ctx:
            return phases
        c *= 2


def load_for_training(model_dir: str, device):
    """(tokenizer, config, f32 params on ``device``) of a checkpoint."""
    from transformers import AutoTokenizer

    from shadowkv_tpu_torch.models.params import load_hf_params
    from shadowkv_tpu_torch.models.registry import config_from_hf_dir

    tokenizer = AutoTokenizer.from_pretrained(model_dir, local_files_only=True)
    cfg = config_from_hf_dir(model_dir, dtype=torch.float32)
    return tokenizer, cfg, load_hf_params(model_dir, cfg, device=device)


def tiny_trainer(cfg, params, lr: float, steps: int, max_ctx: int,
                 chunk: int = 512) -> Trainer:
    """The oracle's trainer: AdamW over a warmup of min(200, steps/5 + 1)
    and a cosine decay over 2 x ``steps`` (the phases' budgets sum to ~2 x
    steps) down to lr / 10; loss ``ans + 0.1 * fill``."""
    sched = warmup_cosine_decay_schedule(0.0, lr, min(200, steps // 5 + 1),
                                         2 * steps, end_value=lr * 0.1)
    return Trainer(cfg, params, lambda leaves: AdamW(leaves, sched), max_ctx,
                   fill_weight=0.1, chunk=chunk)


def main(argv=None) -> dict:
    from shadowkv_tpu_torch.models.params import save_hf_checkpoint
    from shadowkv_tpu_torch.tools.make_tiny_checkpoint import (
        build_tiny_checkpoint,
    )

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="checkpoints/tiny-llama-trained")
    ap.add_argument("--steps", type=int, default=1500)
    ap.add_argument("--ctx", type=int, default=4096)
    ap.add_argument("--batch", type=int, default=2)
    # 7e-4 is the JAX script's default, at which neither its runs nor this
    # tool's formed the retrieval circuit; its oracle was trained with
    # --steps 2400 --lr 3e-4 --fresh --ckpt-every 0.
    ap.add_argument("--lr", type=float, default=7e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-every", type=int, default=500)
    ap.add_argument("--fresh", action="store_true", default=False,
                    help="wipe and rebuild the base checkpoint (tokenizer "
                         "and initial weights) before training")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = torch.device(args.device)

    out = build_tiny_checkpoint(args.out, fresh=args.fresh)
    tokenizer, cfg, params = load_for_training(out, device)
    tr = tiny_trainer(cfg, params, args.lr, args.steps, args.ctx)
    rng = np.random.RandomState(args.seed)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.time()
    step = 0
    for kind, ctx, batch, n_steps in curriculum(args.steps, args.ctx,
                                                args.batch):
        print(f"-- phase {kind} ctx={ctx} batch={batch} steps<={n_steps}",
              flush=True)
        mk = make_samples_dense if kind == "dense" else make_samples
        bar = 0.8 if kind == "dense" else 0.9
        for i_phase in range(n_steps):
            ids, mask = mk(tokenizer, batch, ctx,
                           seed=int(rng.randint(0, 2**31)))
            _, ans, fill = tr.step(ids, mask)
            if step % 25 == 0:
                print(f"step {step:5d} ans {float(ans):.4f} "
                      f"fill {float(fill):.4f} ({time.time() - t0:.0f}s)",
                      flush=True)
            if args.ckpt_every and step and step % args.ckpt_every == 0:
                save_hf_checkpoint(params, cfg, out)
                print(f"  checkpointed at step {step}", flush=True)
            step += 1
            if i_phase and i_phase % 100 == 0:
                acc = retrieval_acc(tr, tokenizer, 16, ctx,
                                    seed=7_000_000 + step, kind=kind)
                print(f"  retrieval[{kind}]@{ctx}: {acc:.2f}", flush=True)
                if acc >= bar:
                    print(f"  phase {kind}@{ctx} done early at step {step}",
                          flush=True)
                    break
    wall = time.time() - t0
    save_hf_checkpoint(params, cfg, out)
    peak = (torch.cuda.max_memory_allocated(device) / 2**30
            if device.type == "cuda" else None)
    print(f"trained checkpoint at {out}: {step} steps in {wall:.1f} s "
          f"({step / wall:.3f} steps/s), peak {peak} GiB", flush=True)
    acc = retrieval_acc(tr, tokenizer, 16, args.ctx, seed=999)
    print(f"self-test retrieval@{args.ctx}: {acc:.2f} "
          f"({'OK' if acc >= 0.5 else 'MISS'})", flush=True)
    return dict(out=out, steps=step, wall_s=wall, steps_per_s=step / wall,
                peak_gib=peak, self_test_acc=acc)


if __name__ == "__main__":
    main()
