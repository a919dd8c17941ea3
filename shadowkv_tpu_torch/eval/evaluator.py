"""Accuracy evaluation harness (counterpart of
``shadowkv_tpu/eval/evaluator.py``).

Per-step results append to a jsonl archive with the reference's record
schema (prediction / ground_truth / correct / avg_score). Multi-process
data parallelism is the reference's own (``test/eval_acc.py``): launched
by ``torchrun``, each process evaluates a contiguous dataset shard, and the
per-rank (sample count, score sum) rows meet in one
``torch.distributed.all_gather`` (NCCL on the card, gloo on the CPU) for
the sample-weighted summary.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import time
from typing import Optional

import numpy as np
import torch

from shadowkv_tpu_torch.data.dataset import Dataset, middle_truncate


@dataclasses.dataclass
class DistConfig:
    is_distributed: bool
    rank: int
    world_size: int
    master_process: bool
    # Ranks of one model replica (dp * tp * sp * pp of the LLM): the
    # dataset shards over replicas, and one rank of each writes and counts.
    model_ranks: int = 1

    @property
    def replica(self) -> int:
        return self.rank // self.model_ranks

    @property
    def replicas(self) -> int:
        return self.world_size // self.model_ranks

    @property
    def writer(self) -> bool:
        """The replica's first rank: it writes the archive and its samples
        count in the summary."""
        return self.rank % self.model_ranks == 0


def init_dist(backend: Optional[str] = None) -> DistConfig:
    """Join the process group that ``torchrun`` describes (``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR``/``MASTER_PORT``), as the reference's
    ``test/eval_acc.py`` does; one process without them. The backend is
    NCCL where a card is present (each rank on ``LOCAL_RANK``'s card), gloo
    otherwise."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    rank = int(os.environ.get("RANK", "0"))
    if world > 1 and os.environ.get("MASTER_ADDR"):
        import torch.distributed as dist

        if backend is None:
            backend = "nccl" if torch.cuda.is_available() else "gloo"
        if backend == "nccl":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
        if not dist.is_initialized():
            dist.init_process_group(backend=backend, rank=rank,
                                    world_size=world)
    else:
        world, rank = 1, 0
    cfg = DistConfig(is_distributed=world > 1, rank=rank, world_size=world,
                     master_process=rank == 0)
    if cfg.master_process:
        print(f"[Dist init] world_size={world}", file=sys.stderr)
    return cfg


def close_dist(dist: DistConfig) -> None:
    """Leave the process group that ``init_dist`` joined: a barrier, so no
    rank tears down while another still talks to it, then
    ``destroy_process_group``. Nothing happens for one process. A group
    left up until interpreter exit has its gloo threads torn down in no
    order, which can abort the process."""
    if not dist.is_distributed:
        return
    import torch.distributed as tdist

    if tdist.is_initialized():
        tdist.barrier()
        tdist.destroy_process_group()


def _allgather_rows(rows: np.ndarray, dist: DistConfig) -> np.ndarray:
    """[n, 2] float64 rows of every rank -> [W, n, 2] (one
    ``all_gather``; the tensors live on the card under NCCL)."""
    if not dist.is_distributed:
        return rows[None]
    import torch.distributed as tdist

    device = ("cuda" if tdist.get_backend() == "nccl" else "cpu")
    t = torch.as_tensor(rows, dtype=torch.float64, device=device)
    out = [torch.empty_like(t) for _ in range(dist.world_size)]
    tdist.all_gather(out, t)
    return torch.stack(out).cpu().numpy()


class Evaluator:
    def __init__(self, dist_config: Optional[DistConfig] = None):
        self.dist = dist_config or DistConfig(False, 0, 1, True)
        self.all_stats: list[dict] = []

    def test(
        self,
        llm,
        dataset: Dataset,
        output_path: str,
        setting: str = "baseline",
        temperature: float = 0.0,
        top_p: float = 1.0,
        resume: bool = False,
    ) -> float:
        """Evaluate ``llm`` on ``dataset``; returns this rank's mean score.

        Batch layout matches the reference loop (test/evaluator.py:58-92):
        ``llm.batch_size`` samples per step, greedy decoding, metric per
        sample, jsonl archive per step.

        ``resume=True`` continues an interrupted run from its archive:
        completed steps' scores are reloaded from the jsonl (a torn tail
        line from a mid-write crash is dropped) and generation restarts
        at the first missing step. The reference instead truncates the
        archive and re-pays the whole eval (test/evaluator.py:54) — at
        100+ s/sample on 128K contexts a resume is hours saved.
        """
        os.makedirs(os.path.dirname(output_path) or ".", exist_ok=True)
        if self.dist.master_process:
            print(
                f"[Test] {llm.model_name} on {dataset.dataset_name} "
                f"-> {output_path}",
                file=sys.stderr,
            )
        if not dataset.is_sharded:
            dataset.shard(self.dist.replica, self.dist.replicas)
        writer = self.dist.writer

        bsz = llm.batch_size
        scores: list[float] = []
        start_step = 0
        steps = dataset.num_samples // bsz
        if resume and os.path.exists(output_path):
            intact: list[str] = []
            with open(output_path, encoding="utf8") as f:
                for line in f:
                    if start_step >= steps:
                        break  # stale over-long archive
                    try:
                        rec = json.loads(line)
                        step_correct = rec["correct"]
                    except (json.JSONDecodeError, KeyError):
                        break  # torn tail write from a crash
                    scores.extend(step_correct)
                    intact.append(line.rstrip("\n"))
                    start_step += 1
            if writer:
                with open(output_path, "w", encoding="utf8") as f:
                    f.writelines(l + "\n" for l in intact)
            if self.dist.master_process and start_step:
                print(
                    f"  [resume] {start_step}/{steps} steps restored "
                    f"from {output_path}",
                    file=sys.stderr,
                )
        elif writer:
            open(output_path, "w").close()
        t_start = time.time()
        for i in range(start_step, steps):
            rows = [dataset.tokenized_prompts[i * bsz + j] for j in range(bsz)]
            # Equal-length batching via the reference's middle-truncation
            # manner (keeps the template head AND the question tail;
            # right-alignment would chop the chat-template header off
            # longer rows).
            min_len = min(len(r) for r in rows)
            batch = np.stack([middle_truncate(r, min_len) for r in rows])
            preds = llm.generate(
                batch,
                gen_len=dataset.gen_len,
                temperature=temperature,
                top_p=top_p,
            )
            step_scores = []
            for pred, gt in zip(preds, dataset.gt[i * bsz : (i + 1) * bsz]):
                if isinstance(gt, list) and len(gt) == 1:
                    gt = gt[0]
                step_scores.append(dataset.metric(pred, gt))
            scores.extend(step_scores)
            avg = sum(scores) / len(scores)

            record = {
                "prediction": preds,
                "ground_truth": dataset.gt[i * bsz : (i + 1) * bsz],
                "correct": step_scores,
                "avg_score": avg,
            }
            if dataset.dataset_name == "niah":
                record.update(
                    context_length=dataset.ctx_len[i * bsz : (i + 1) * bsz],
                    depth_percent=dataset.depth_pct[i * bsz : (i + 1) * bsz],
                )
            if writer:
                with open(output_path, "a", encoding="utf8") as f:
                    f.write(json.dumps(record, ensure_ascii=False) + "\n")
            if self.dist.master_process:
                done = (i + 1) * bsz
                rate = (time.time() - t_start) / (
                    (i + 1 - start_step) * bsz
                )
                print(
                    f"  [{done}/{steps * bsz}] avg_score={avg:.3f} "
                    f"({rate:.1f}s/sample)",
                    file=sys.stderr,
                )

        avg = sum(scores) / max(1, len(scores))
        self.all_stats.append(dict(
            model=llm.model_name,
            dataset=dataset.dataset_name,
            samples=len(scores),
            setting=setting,
            score=avg,
        ))
        return avg

    def summarize(self) -> Optional[str]:
        """Merge per-rank stats (sample-weighted) and print a markdown
        table (reference test/evaluator.py:138-171)."""
        if not self.all_stats:
            return None
        rows = np.asarray(
            [[s["samples"], s["score"] * s["samples"]]
             for s in self.all_stats],
            np.float64,
        ) * float(self.dist.writer)  # one rank per replica counts
        gathered = _allgather_rows(rows, self.dist)  # [W, n_stats, 2]
        if not self.dist.master_process:
            return None
        totals = gathered.sum(axis=0)  # [n_stats, 2]
        lines = [
            "| model | dataset | setting | samples | score |",
            "|---|---|---|---|---|",
        ]
        for stat, (n, weighted) in zip(self.all_stats, totals):
            score = weighted / max(1.0, n)
            lines.append(
                f"| {stat['model']} | {stat['dataset']} | "
                f"{stat['setting']} | {int(n)} | {score:.4f} |"
            )
        mean = float(
            np.sum(totals[:, 1]) / max(1.0, np.sum(totals[:, 0]))
        )
        lines.append(f"| mean | | | {int(totals[:, 0].sum())} | {mean:.4f} |")
        table = "\n".join(lines)
        print(table)
        return table
