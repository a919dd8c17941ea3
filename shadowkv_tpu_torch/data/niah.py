"""Needle-in-a-haystack (NIAH) sweep generation.

Rebuild of the reference NIAH machinery (reference data/utils.py:53-141,
data/dataset.py:164-242): a (context_length x depth_percent) grid of
prompts, each hiding one "special magic {city} number" needle in a long
haystack at a token depth. The haystack comes from a local
``pg19_mini.jsonl`` if available (same file the reference uses) or is
synthesized offline.
"""

from __future__ import annotations

import json
import os
import random
from typing import Optional

import numpy as np

from shadowkv_tpu_torch.data import wordlists as wl

NIAH_TEMPLATE = (
    "Write a high-quality answer for the given question using only the "
    "provided search results (some of which might be irrelevant).\n"
    "{context}\n\nQuestion: {question} Don't give information outside the "
    "document or repeat your findings. Keep your response short and "
    "direct. Answer: "
)

NEEDLE_FMT = "\nThe special magic {city} number is: {rnd_number}\n"
QUESTION_FMT = "What is the special magic {} number?"

HAYSTACK_PATHS = ["data/niah/data/pg19_mini.jsonl"]


def load_haystack_text(
    tokenizer, max_tokens: int, rng: random.Random,
    haystack_file: Optional[str] = None,
) -> str:
    """Book-like text with >= max_tokens tokens (reference
    data/utils.py:62-74 reads pg19_mini; offline fallback synthesizes)."""
    paths = [haystack_file] if haystack_file else HAYSTACK_PATHS
    for path in paths:
        if path and os.path.exists(path):
            text, toks = [], 0
            with open(path) as f:
                for line in f:
                    t = json.loads(line)["text"]
                    text.append(t)
                    toks += len(tokenizer.encode(t, add_special_tokens=False))
                    if toks >= max_tokens:
                        break
            return "".join(text)
    # ~0.75 words per token for English prose.
    return wl.synthetic_essay(rng, int(max_tokens * 0.8))


def insert_needle(
    needle: str,
    context_tokens: list[int],
    depth_percent: float,
    context_length: int,
    tokenizer,
    buffer: int = 32,
) -> str:
    """Insert the needle at a sentence boundary near the requested token
    depth (reference data/utils.py:76-111)."""
    needle_tokens = tokenizer.encode(needle, add_special_tokens=False)
    context_length -= buffer
    if len(context_tokens) + len(needle_tokens) > context_length:
        context_tokens = context_tokens[: context_length - len(needle_tokens)]
    if depth_percent == 100:
        new_tokens = context_tokens + needle_tokens
    else:
        insert_at = int(len(context_tokens) * depth_percent / 100)
        period_tokens = {
            tokenizer.encode(s, add_special_tokens=False)[0]
            for s in (".", ". \n", ".\n", "\n")
        }
        while insert_at > 0 and context_tokens[insert_at - 1] not in period_tokens:
            insert_at -= 1
        new_tokens = (
            context_tokens[:insert_at]
            + needle_tokens
            + context_tokens[insert_at:]
        )
    return tokenizer.decode(new_tokens, skip_special_tokens=True)


def build_niah_grid(
    tokenizer,
    max_context: int,
    min_context: int = 16 * 1024,
    n_context_intervals: int = 15,
    n_depth_intervals: int = 10,
    seed: int = 42,
    haystack_file: Optional[str] = None,
):
    """Build the full (ctx_len x depth) NIAH sweep.

    Returns a list of dicts {input, outputs, context_length,
    depth_percent} with untokenized prompt text (reference
    data/dataset.py:164-242 tokenizes inline; we defer so the Dataset
    can apply model templates uniformly).
    """
    rng = random.Random(seed)
    context_lengths = np.round(
        np.linspace(min_context, max_context, n_context_intervals)
    ).astype(int)
    depths = np.round(np.linspace(0, 100, n_depth_intervals)).astype(int)

    haystack = load_haystack_text(tokenizer, int(max_context), rng,
                                  haystack_file)
    full_tokens = tokenizer.encode(haystack, add_special_tokens=False)

    samples = []
    for ctx_len in context_lengths:
        trimmed = full_tokens[: int(ctx_len)]
        for depth in depths:
            city = rng.choice(wl.CITIES)
            number = wl.random_number(rng)
            needle = NEEDLE_FMT.format(city=city, rnd_number=number)
            context = insert_needle(
                needle, list(trimmed), float(depth), int(ctx_len), tokenizer
            )
            prompt = NIAH_TEMPLATE.format(
                context=context, question=QUESTION_FMT.format(city)
            )
            samples.append(dict(
                input=prompt,
                outputs=number,
                context_length=int(ctx_len),
                depth_percent=float(depth),
            ))
    return samples
