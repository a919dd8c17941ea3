"""Dataset loading/generation for the accuracy harness.

Counterpart of the reference ``Dataset`` (reference
data/dataset.py:51-245) with one TPU-driven difference: prompts are
tokenized to numpy int32 arrays and can be *bucketed* (middle-truncated
to a multiple of ``bucket``) so the jitted prefill compiles once per
bucket instead of once per unique prompt length. Middle truncation is
the reference's own truncation manner (data/utils.py:29-38), preserving
the instruction head and the question tail.

Sources:
- ``ruler/<task>``: a prebuilt ``validation.jsonl`` under
  ``data/ruler/data/<family>/<datalen>/<task>/`` when present (same
  layout as the reference), otherwise generated on the fly by
  :mod:`shadowkv_tpu_torch.data.ruler.generate`.
- ``niah``: the on-the-fly (ctx_len x depth) sweep.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np

from shadowkv_tpu_torch.data.metrics import gen_len_for, metric_for
from shadowkv_tpu_torch.data.ruler.generate import generate_task
from shadowkv_tpu_torch.models.prompt_templates import CTX_TEMPLATES, template_family

RULER_DATA_DIR = "data/ruler/data"

RULER_LENGTHS = [4 * 1024, 8 * 1024, 16 * 1024, 32 * 1024, 64 * 1024,
                 128 * 1024, 256 * 1024]  # RULER's standard ladder
# (4K included: the official benchmark starts there, and it is the CPU
# integration-test length — tests/test_eval_e2e.py)


def middle_truncate(ids: np.ndarray, max_length: int) -> np.ndarray:
    """Keep head and tail halves (reference data/utils.py:29-38)."""
    if max_length < 0 or ids.shape[-1] <= max_length:
        return ids
    split = max_length // 2
    return np.concatenate(
        [ids[: split + max_length % 2], ids[len(ids) - split:]]
    )


class Dataset:
    """Tokenized long-context eval samples.

    Args mirror the reference (data/dataset.py:52): ``dataset_name`` is
    ``"ruler/<task>"`` or ``"niah"``; ``datalen`` the nominal context
    length; ``num_samples`` caps samples (-1 = all); rank/world_size do
    data-parallel sharding.
    """

    def __init__(
        self,
        dataset_name: str,
        tokenizer,
        datalen: int,
        num_samples: int = -1,
        rank: int = 0,
        world_size: int = 1,
        bucket: int = 0,
        seed: int = 42,
    ):
        self.dataset_name = dataset_name
        self.tokenizer = tokenizer
        self.datalen = datalen
        self.rank = rank
        self.world_size = world_size
        self.bucket = bucket
        self.seed = seed
        self.is_sharded = False
        self.ctx_len: list[int] = []
        self.depth_pct: list[float] = []

        if dataset_name == "niah":
            self._build_niah()
        elif dataset_name.startswith("ruler/"):
            self._build_ruler(num_samples)
        else:
            raise ValueError(f"unknown dataset '{dataset_name}'")

        self.num_samples = len(self.tokenized_prompts)
        self.gen_len = gen_len_for(dataset_name)
        self.metric = metric_for(dataset_name)

    # -- construction -------------------------------------------------------

    def _family(self) -> str:
        name = getattr(self.tokenizer, "name_or_path", "") or ""
        return template_family(name)

    def _tokenize(self, text: str) -> np.ndarray:
        ids = self.tokenizer.encode(text, add_special_tokens=False)
        ids = np.asarray(ids, np.int32)
        if self.bucket:
            target = (len(ids) // self.bucket) * self.bucket
            ids = middle_truncate(ids, max(self.bucket, target))
        return ids

    def _build_ruler(self, num_samples: int):
        task = self.dataset_name.split("/", 1)[1]
        assert self.datalen in RULER_LENGTHS, (
            f"datalen {self.datalen} not in {RULER_LENGTHS}"
        )
        family = self._family()
        path = os.path.join(
            RULER_DATA_DIR, family, str(self.datalen), task,
            "validation.jsonl",
        )
        if os.path.exists(path):
            with open(path) as f:
                rows = [json.loads(line) for line in f]
        else:
            n = num_samples if num_samples > 0 else 24
            rows = generate_task(
                task,
                self.tokenizer,
                self.datalen,
                n,
                seed=self.seed,
                model_template=CTX_TEMPLATES[family],
            )
        if num_samples > 0:
            rows = rows[:num_samples]
        self.tokenized_prompts = [self._tokenize(r["input"]) for r in rows]
        self.gt = [r["outputs"] for r in rows]

    def _build_niah(self):
        from shadowkv_tpu_torch.data.niah import build_niah_grid

        family = self._family()
        template = CTX_TEMPLATES[family]
        samples = build_niah_grid(
            self.tokenizer, self.datalen, seed=self.seed
        )
        # NIAH shards at init like the reference (data/dataset.py:195).
        if self.world_size > 1:
            samples = samples[self.rank :: self.world_size]
            self.is_sharded = True
        self.tokenized_prompts = [
            self._tokenize(template.format(ctx=s["input"])) for s in samples
        ]
        self.gt = [s["outputs"] for s in samples]
        self.ctx_len = [s["context_length"] for s in samples]
        self.depth_pct = [s["depth_percent"] for s in samples]

    # -- protocol ------------------------------------------------------------

    def shard(self, rank: int, world_size: int):
        """Contiguous data-parallel shard (reference
        data/dataset.py:79-89)."""
        if world_size > 1 and not self.is_sharded:
            n = self.num_samples // world_size
            start = rank * n
            end = start + n if rank != world_size - 1 else self.num_samples
            self.tokenized_prompts = self.tokenized_prompts[start:end]
            self.gt = self.gt[start:end]
            if self.ctx_len:
                self.ctx_len = self.ctx_len[start:end]
                self.depth_pct = self.depth_pct[start:end]
            self.num_samples = len(self.tokenized_prompts)
        self.is_sharded = True

    def __len__(self) -> int:
        return self.num_samples

    def __getitem__(self, idx: int):
        return self.tokenized_prompts[idx], self.gt[idx]

    def __repr__(self) -> str:
        return (
            f"Dataset({self.dataset_name}, samples={self.num_samples}, "
            f"gen_len={self.gen_len}, datalen={self.datalen})"
        )
