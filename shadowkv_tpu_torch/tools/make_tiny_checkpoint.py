"""Build the tiny oracle's base checkpoint: a byte-level BPE tokenizer
trained here on RULER-style text and an initial 6-layer Llama, saved as an
HF checkpoint (counterpart of the JAX repo's
``scripts/make_tiny_checkpoint.py``).

Writes, in ``--out`` (default ``checkpoints/tiny-llama-ruler``, gitignored):

- the tokenizer (``tokenizers`` BPE with byte fallback, the RULER word
  lists as whole merges), in HF format (``AutoTokenizer`` loads it);
- ``config.json`` and ``model.safetensors`` of a 6 x 1024 Llama (8 heads of
  128, 2 KV heads, MLP 2048, RoPE theta 10000, f32) whose weights follow
  ``LlamaForCausalLM``'s init rule, N(0, 0.02) for the embedding and every
  projection and ones for the norms, drawn from a CPU ``torch.Generator``
  seeded 0 and written by ``models/params.py``: the weights
  depend on the seed, not on the ``transformers`` version.

    python -m shadowkv_tpu_torch.tools.make_tiny_checkpoint [--out DIR]

``build_tiny_checkpoint(out_dir)`` is idempotent (``fresh=True`` rebuilds);
``tools/train_tiny_model.py`` trains from it.
"""

from __future__ import annotations

import argparse
import os
import random
import shutil

import torch

from shadowkv_tpu_torch.config import ModelConfig
from shadowkv_tpu_torch.data.wordlists import (
    ADJECTIVES,
    NOUNS,
    VERBS,
    adjective_noun_words,
)
from shadowkv_tpu_torch.models.params import (
    init_synthetic_params,
    save_hf_checkpoint,
)

SPECIALS = ["<|begin_of_text|>", "<|end_of_text|>", "<|eot_id|>",
            "<|start_header_id|>", "<|end_header_id|>"]


def _training_corpus() -> list[str]:
    """RULER-flavoured text: essay filler, number needles and queries over
    adjective-noun keys, the word lists, chat-template specials. With the
    words as whole merges a needle key is ~3 tokens, not ~17 characters,
    which the retrieval circuit needs."""
    rng = random.Random(0)
    filler = (
        "The grass is green. The sky is blue. The sun is yellow. "
        "Here we go. There and back again. "
    )
    words = adjective_noun_words()
    lines = []
    for _ in range(2000):
        key = rng.choice(words)
        parts = [filler]
        parts.append(
            f"One of the special magic numbers for {key} is: "
            f"{rng.randint(1000000, 9999999)}."
        )
        parts.append(
            f"What is the special magic number for {key} mentioned in "
            "the provided text? The special magic number for "
            f"{key} mentioned in the provided text is "
            f"{rng.randint(1000000, 9999999)}"
        )
        lines.append(" ".join(parts))
    for _ in range(20):  # every list word as a whole merge
        lines.append(" ".join(NOUNS + ADJECTIVES + VERBS))
    lines.append("<|begin_of_text|> <|eot_id|> <|end_of_text|> "
                 "<|start_header_id|> <|end_header_id|> user assistant "
                 "system\n\n")
    return lines


def train_tokenizer(vocab_size: int = 4096):
    """The trained byte-level BPE tokenizer, as a
    ``PreTrainedTokenizerFast``."""
    from tokenizers import Tokenizer, decoders, models, pre_tokenizers, trainers
    from transformers import PreTrainedTokenizerFast

    tok = Tokenizer(models.BPE(unk_token=None, byte_fallback=True))
    tok.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False)
    tok.decoder = decoders.ByteLevel()
    trainer = trainers.BpeTrainer(
        vocab_size=vocab_size,
        special_tokens=SPECIALS,
        initial_alphabet=pre_tokenizers.ByteLevel.alphabet(),
    )
    tok.train_from_iterator(_training_corpus(), trainer)
    return PreTrainedTokenizerFast(
        tokenizer_object=tok,
        bos_token="<|begin_of_text|>",
        eos_token="<|eot_id|>",
        additional_special_tokens=SPECIALS[3:],
    )


def tiny_config(vocab_size: int) -> ModelConfig:
    """The oracle's geometry. Head dim 128, so it runs the production
    kernels' contracts; 8 heads (4 never formed the retrieval circuit in
    the JAX repo's runs); theta 10000 (5e5 starved the position-matching
    heads at this scale there)."""
    return ModelConfig(
        name="tiny-llama", num_layers=6, hidden_size=1024, num_heads=8,
        num_kv_heads=2, head_dim=128, intermediate_size=2048,
        vocab_size=vocab_size, rms_norm_eps=1e-5, rope_theta=10000.0,
        max_position_embeddings=8192, tie_word_embeddings=False,
        dtype=torch.float32,
    )


def build_tiny_checkpoint(out_dir: str, vocab_size: int = 4096,
                          fresh: bool = False) -> str:
    """Train the tokenizer and write the initial model. Idempotent: returns
    at once if ``out_dir`` already holds a checkpoint (``fresh=True`` wipes
    and rebuilds, so a stale checkpoint cannot stand in for a retrain)."""
    if os.path.exists(os.path.join(out_dir, "model.safetensors")):
        if not fresh:
            return out_dir
        shutil.rmtree(out_dir)
    os.makedirs(out_dir, exist_ok=True)
    fast = train_tokenizer(vocab_size)
    fast.save_pretrained(out_dir)
    cfg = tiny_config(fast.vocab_size)
    params = init_synthetic_params(
        cfg, torch.Generator().manual_seed(0), device="cpu")
    save_hf_checkpoint(params, cfg, out_dir)
    return out_dir


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="checkpoints/tiny-llama-ruler")
    ap.add_argument("--vocab", type=int, default=4096)
    args = ap.parse_args(argv)
    path = build_tiny_checkpoint(args.out, args.vocab)
    print(f"tiny checkpoint at {path}")


if __name__ == "__main__":
    main()
