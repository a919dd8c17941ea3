"""The port's entry-point layer on a real (tiny) HF checkpoint and trained
tokenizer, against the JAX package's: ``LLM`` (tokenizer, templates, stop
ids, ``generate``, ``batch_generate``, context checkpoints), ``e2e``'s
measurement and ``eval_acc``'s archive.

One checkpoint per test run (a session fixture): the byte-level BPE
tokenizer of ``scripts/make_tiny_checkpoint.py::build_tiny_checkpoint``
beside a 2-layer, 128-wide random ``LlamaForCausalLM`` (4 heads / 2 KV
heads, head_dim 32) in float32. Rank 32 spans the 64 key features, so the
low-rank factors do not depend on either package's sketch. Tokens and
texts are compared exactly.
"""

from __future__ import annotations

import json
import sys

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from shadowkv_tpu.models.llm import LLM as JLLM
from shadowkv_tpu_torch.models.llm import LLM as TLLM

MODEL_NAME = "meta-llama/Llama-3-tiny"
PROMPT = 256
SHADOW = dict(sparse_budget=64, rank=32, chunk_size=8)
TEXT = ("The grass is green. The sky is blue. One of the special magic "
        "numbers for quiet-harbor is: 4182733. Here we go. ") * 12


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """One intra-op thread: these toy-sized ops gain nothing from more, and
    under the suite's parallel workers the spinning thread pools of every
    worker slow each small op by orders of magnitude."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="session")
def tiny_dir(tmp_path_factory):
    from transformers import AutoTokenizer, LlamaConfig, LlamaForCausalLM

    from scripts.make_tiny_checkpoint import build_tiny_checkpoint

    tok_dir = build_tiny_checkpoint(str(tmp_path_factory.mktemp("tok")))
    tok = AutoTokenizer.from_pretrained(tok_dir)
    out = tmp_path_factory.mktemp("tiny-llama")
    tok.save_pretrained(out)
    cfg = LlamaConfig(
        vocab_size=tok.vocab_size, hidden_size=128, intermediate_size=256,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=8192, rope_theta=10000.0, rms_norm_eps=1e-5,
        tie_word_embeddings=False, torch_dtype=torch.float32)
    torch.manual_seed(0)
    LlamaForCausalLM(cfg).save_pretrained(out, safe_serialization=True)
    return str(out)


def _pair(tiny_dir, **kw):
    kw = dict(model_name=MODEL_NAME, model_dir=tiny_dir, max_length=512,
              **kw)
    return (JLLM(dtype=jnp.float32, **kw),
            TLLM(dtype=torch.float32, device="cpu", **kw))


def _prompt(llm, batch=1):
    ids = llm.encode(TEXT, template="ctx")[0]
    assert len(ids) >= PROMPT
    rows = [np.roll(ids, 7 * b)[:PROMPT] for b in range(batch)]
    return np.stack(rows).astype(np.int32)


@pytest.mark.parametrize("mode", ["full", "shadow"])
def test_llm_matches_jax(tiny_dir, mode):
    """Tokenizer, templates and stop ids; greedy ``generate`` text and
    ``batch_generate`` tokens."""
    jl, tl = _pair(tiny_dir, attn_mode=mode, batch_size=2, **SHADOW)
    assert tl.stop_ids == jl.stop_ids and tl.stop_ids
    assert tl.family == jl.family == "llama-3"
    for template in (None, "ctx", "chat", "prefix"):
        np.testing.assert_array_equal(tl.encode("Hello there", template),
                                      jl.encode("Hello there", template))
    one = _prompt(tl)
    assert tl.generate(one, gen_len=12) == jl.generate(one, gen_len=12)
    rows = _prompt(tl, batch=2)
    t_out, t_rate = tl.batch_generate(rows, gen_len=8, temperature=0.0)
    j_out, _ = jl.batch_generate(rows, gen_len=8, temperature=0.0)
    assert t_out == j_out and t_rate > 0
    assert tl.engine.rt.weight_quant == "none" and "cpu" in str(tl)


def test_synthetic_token_ids_and_refusals(monkeypatch):
    """No checkpoint and no local tokenizer: int8 synthetic weights from
    the seeded generator, token ids in and out; mesh axes without as many
    ranks in the process group are refused, and ``approx_topk=True`` (exact off the TPU, as in JAX) gives the tokens of
    ``approx_topk=False``."""
    from shadowkv_tpu_torch.core.wquant import quantize_params
    from shadowkv_tpu_torch.models import llm as llm_mod
    from shadowkv_tpu_torch.models.params import init_synthetic_params
    from shadowkv_tpu_torch.models.registry import toy_config

    cfg = toy_config(dtype=torch.float32)
    monkeypatch.setattr(llm_mod, "model_config", lambda *a, **k: cfg)
    monkeypatch.setattr(llm_mod, "load_tokenizer", lambda *a: None)
    llm = TLLM("toy", attn_mode="shadowkv", max_length=512, device="cpu",
               weight_quant="int8", **SHADOW)
    want = quantize_params(init_synthetic_params(
        cfg, torch.Generator().manual_seed(llm_mod.SYNTHETIC_SEED)))
    assert torch.equal(llm.engine.params.layers.wqkv.q, want.layers.wqkv.q)
    assert llm.engine.rt.weight_quant == "int8" and llm.stop_ids == ()
    ids = np.random.RandomState(0).randint(0, cfg.vocab_size, (1, PROMPT))
    out = llm.generate(ids, gen_len=4)
    assert isinstance(out, np.ndarray) and out.shape == (1, 4)
    with pytest.raises(ValueError, match="tokenizer"):
        llm.encode("text")
    with pytest.raises(ValueError, match="world size is 1"):
        TLLM("toy", tp=2, device="cpu")
    approx = TLLM("toy", attn_mode="shadowkv", max_length=512, device="cpu",
                  weight_quant="int8", approx_topk=True, **SHADOW)
    assert np.array_equal(approx.generate(ids, gen_len=4), out)


def test_tokenizer_is_local_only(tiny_dir, tmp_path, monkeypatch):
    """A checkpoint dir without tokenizer files and a hub model name give
    no tokenizer (local files only; the hub is also set offline here as a
    guard); the tiny dir's tokenizer loads."""
    from shadowkv_tpu_torch.models.llm import load_tokenizer

    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    assert load_tokenizer(str(tmp_path), "meta-llama/Llama-3.1-8B-x") is None
    assert load_tokenizer(tiny_dir, MODEL_NAME) is not None


def test_context_save_load(tiny_dir, tmp_path):
    """``save_context`` after a short generate; a fresh ``LLM`` (V in the
    host store) loads it and ``generate(cont=True)`` gives the
    uninterrupted run's tokens."""
    kw = dict(model_name=MODEL_NAME, model_dir=tiny_dir, max_length=512,
              dtype=torch.float32, device="cpu", use_pallas=True,
              kv_quant="int8", **SHADOW)
    a = TLLM(attn_mode="shadow", **kw)
    rows = _prompt(a)
    a.tokenizer, a.stop_ids = None, ()  # token ids out, no early stop
    ref = a.generate(rows, gen_len=10)
    head = a.generate(rows, gen_len=2)
    path = str(tmp_path / "ctx.npz")
    a.save_context(path)
    b = TLLM(attn_mode="shadowkv_cpu", **kw)
    b.tokenizer, b.stop_ids = None, ()
    b.load_context(path)
    rest = b.generate(head[:, 1:], gen_len=8, cont=True)
    np.testing.assert_array_equal(np.concatenate([head, rest], axis=1), ref)
    b.print_kv_stats()


def test_e2e_measure_keys(tiny_dir):
    """``e2e.measure`` on toy rows returns JAX e2e's JSON keys."""
    from shadowkv_tpu_torch.entry import e2e

    rows = _prompt(TLLM(MODEL_NAME, model_dir=tiny_dir, device="cpu",
                        max_length=512))
    runs = {}
    out = e2e.measure(MODEL_NAME, rows, np.concatenate([rows, rows]),
                      sparse_budget=64, gen_len=4, rank=32, model_dir=tiny_dir,
                      device="cpu", datalen="toy", runs=runs)
    # shadowkv_tpu/entry/e2e.py's print(json.dumps({...}))
    assert set(out) == {"datalen", "baseline_tokens_per_sec",
                        "shadowkv_tokens_per_sec", "speedup"}
    assert out["datalen"] == "toy" and out["speedup"] > 0
    assert runs["shadowkv"]["cache"].mode == "shadow"
    assert runs["baseline"]["stats"].decode_tokens == 4
    assert len(runs["shadowkv"]["out"]) == 2
    json.dumps(out)


def test_eval_acc_writes_reference_archive(tiny_dir, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    argv = ["--model_name", MODEL_NAME, "--model_dir", tiny_dir,
            "--datalen", "4096", "--num_samples", "2", "--method", "shadow",
            "--sparse_budget", "512", "--rank", "32", "--chunk_size", "8",
            "--dataset_name", "ruler/niah_single_1", "--bucket", "512",
            "--use_pallas", "1", "--device", "cpu"]
    monkeypatch.setattr(sys, "argv", ["eval_acc"] + argv)
    from shadowkv_tpu_torch.entry.eval_acc import main

    main()
    out = (tmp_path / "archive" / "Llama-3-tiny" /
           "ruler/niah_single_1_4096_shadow_512_32_8.jsonl")
    recs = [json.loads(line) for line in out.read_text().splitlines()]
    assert len(recs) == 2
    for r in recs:
        assert set(r) >= {"prediction", "ground_truth", "correct",
                          "avg_score"}
        assert 0.0 <= float(r["avg_score"]) <= 100.0
        assert r["ground_truth"]


def test_e2e_plan_batch():
    """The batches e2e reckons for an 80 GB card from the caches' bytes on
    the meta device: Llama-3.1-8B with bf16 weights (15.0 GiB)."""
    from shadowkv_tpu_torch.entry import e2e
    from shadowkv_tpu_torch.models.registry import llama31_8b

    cfg = llama31_8b("meta-llama/Llama-3.1-8B")
    assert abs(e2e.weight_bytes(cfg) / 2**30 - 14.96) < 0.01
    got = {(mode, key): e2e.plan_batch(cfg, mode, c["min_prompt_len"], 100,
                                       c["sparse_budget"])
           for key, c in e2e.CONFIGS.items() for mode in ("full", "shadow")}
    assert got == {("full", "60k"): 8, ("full", "122k"): 3,
                   ("full", "244k"): 1, ("shadow", "60k"): 12,
                   ("shadow", "122k"): 5, ("shadow", "244k"): 2}
