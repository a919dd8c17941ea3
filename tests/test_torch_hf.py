"""Hugging Face checkpoints in the port: its own safetensors reader against
``safetensors.safe_open``, ``config_from_hf_dir`` and ``load_hf_params``
against the JAX package's, and the port's prefill logits against
``transformers`` on tiny random models of the five families of
``tests/test_hf_parity.py`` (llama, llama-3.1 with rope scaling, Qwen2,
Phi-3 with fused projections, GLM with partial RoPE and bias), saved in
temporary directories (no network).

Tolerances: the reader and the loaders bit-equal (int8 ``QTensor`` ``q``
and ``s`` too); logits within rtol = atol = 2e-4 in float32, as the JAX
parity test.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from shadowkv_tpu.core.wquant import QTensor as JQTensor
from shadowkv_tpu.models.params import load_hf_params as j_load
from shadowkv_tpu.models.registry import config_from_hf_dir as j_config
from shadowkv_tpu_torch.config import CacheConfig, RuntimeConfig
from shadowkv_tpu_torch.core.wquant import QTensor as TQTensor
from shadowkv_tpu_torch.models.engine import Engine
from shadowkv_tpu_torch.models.params import SafetensorsFile, open_shards
from shadowkv_tpu_torch.models.params import load_hf_params as t_load
from shadowkv_tpu_torch.models.registry import config_from_hf_dir as t_config

SEQ, BATCH = 24, 2
_DIMS = dict(vocab_size=128, hidden_size=64, intermediate_size=112,
             num_hidden_layers=2, num_attention_heads=4,
             max_position_embeddings=256, rope_theta=10000.0)
_IDS = dict(pad_token_id=0, bos_token_id=1, eos_token_id=2)


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """One intra-op thread: these toy-sized ops gain nothing from more, and
    under the suite's parallel workers the spinning thread pools of every
    worker slow each small op by orders of magnitude."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _hf_models():
    """(family -> (HF model class, HF config)) of test_hf_parity.py, plus a
    llama with tied embeddings (no lm_head.weight in the file)."""
    from transformers import (GlmConfig, GlmForCausalLM, LlamaConfig,
                              LlamaForCausalLM, Phi3Config, Phi3ForCausalLM,
                              Qwen2Config, Qwen2ForCausalLM)

    scaling = dict(rope_type="llama3", factor=8.0, low_freq_factor=1.0,
                   high_freq_factor=4.0, original_max_position_embeddings=64)
    return {
        "llama": (LlamaForCausalLM, LlamaConfig(
            **_DIMS, num_key_value_heads=2, head_dim=16, rms_norm_eps=1e-5,
            tie_word_embeddings=False, attention_bias=False)),
        "llama31": (LlamaForCausalLM, LlamaConfig(
            **_DIMS, num_key_value_heads=2, head_dim=16, rms_norm_eps=1e-5,
            rope_scaling=scaling, tie_word_embeddings=False)),
        "qwen2": (Qwen2ForCausalLM, Qwen2Config(
            **_DIMS, num_key_value_heads=2, rms_norm_eps=1e-6,
            tie_word_embeddings=False)),
        "phi3": (Phi3ForCausalLM, Phi3Config(
            **_DIMS, num_key_value_heads=4, rms_norm_eps=1e-5,
            tie_word_embeddings=False, **_IDS)),
        "glm": (GlmForCausalLM, GlmConfig(
            **_DIMS, num_key_value_heads=2, head_dim=16, rms_norm_eps=1e-5,
            partial_rotary_factor=0.5, attention_bias=True,
            tie_word_embeddings=False, **_IDS)),
        "llama-tied": (LlamaForCausalLM, LlamaConfig(
            **_DIMS, num_key_value_heads=2, head_dim=16, rms_norm_eps=1e-5,
            tie_word_embeddings=True)),
    }


FAMILIES = ("llama", "llama31", "qwen2", "phi3", "glm", "llama-tied")


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    """family -> (dir, HF model in f32), saved as one safetensors file."""
    out = {}
    for fam, (cls, cfg) in _hf_models().items():
        torch.manual_seed(0)
        model = cls(cfg).eval()
        path = tmp_path_factory.mktemp(fam)
        model.save_pretrained(path, safe_serialization=True)
        out[fam] = (str(path), model)
    return out


@pytest.mark.parametrize("layout", ["single-f32", "sharded-bf16", "mixed"])
def test_reader_equals_safe_open(tmp_path, layout):
    from safetensors import safe_open
    from transformers import LlamaConfig, LlamaForCausalLM

    if layout == "mixed":  # one file holding every dtype the reader takes
        from safetensors.torch import save_file

        g = torch.Generator().manual_seed(1)
        save_file({f"t.{dt}": torch.randn(3, 5, generator=g).to(dt)
                   for dt in (torch.bfloat16, torch.float16, torch.float32)},
                  str(tmp_path / "model.safetensors"))
    else:
        torch.manual_seed(0)
        model = LlamaForCausalLM(LlamaConfig(
            **_DIMS, num_key_value_heads=2, head_dim=16)).eval()
        if layout == "sharded-bf16":
            model = model.to(torch.bfloat16)
        model.save_pretrained(tmp_path, safe_serialization=True,
                              max_shard_size="60KB"
                              if layout == "sharded-bf16" else "5GB")
    get, shard_of = open_shards(str(tmp_path))
    if layout == "sharded-bf16":
        assert len(set(shard_of.values())) > 1
    for name, shard in shard_of.items():
        with safe_open(str(tmp_path / shard), framework="pt") as f:
            want = f.get_tensor(name)
        got = get(name)
        assert got.dtype == want.dtype and got.shape == want.shape, name
        assert torch.equal(got, want), name
    assert isinstance(SafetensorsFile(str(tmp_path / shard)).entries, dict)


@pytest.mark.parametrize("fam", FAMILIES)
def test_config_from_hf_dir_matches_jax(ckpts, fam):
    """Every field the JAX config has reads the same; the port's own
    fields (the hybrid layers and MoE of ``ModelConfig``) keep their
    defaults, since none of these families has them."""
    path = ckpts[fam][0]
    jc = dataclasses.asdict(j_config(path, name="m"))
    tc = dataclasses.asdict(t_config(path, name="m"))
    jc.pop("dtype"), tc.pop("dtype")
    own = {k: tc.pop(k) for k in set(tc) - set(jc)}
    assert tc == jc
    defaults = {f.name: f.default for f in dataclasses.fields(type(
        t_config(path, name="m"))) if f.name in own}
    assert own == defaults and not t_config(path, name="m").is_hybrid


def _leaves(params):
    out = []
    for x in (params.embed, *params.layers, params.final_norm,
              params.lm_head):
        if isinstance(x, (JQTensor, TQTensor)):
            out += [x.q, x.s]
        elif x is not None:
            out.append(x)
    return out


def _as_numpy(x):
    if isinstance(x, torch.Tensor):
        x = x.contiguous()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy()
        return x.numpy()
    a = np.asarray(x)
    return a.view(np.int16) if a.dtype == jnp.bfloat16 else a


@pytest.mark.parametrize("dtype, quant", [("float32", "none"),
                                          ("bfloat16", "none"),
                                          ("float32", "int8")])
@pytest.mark.parametrize("fam", FAMILIES)
def test_load_hf_params_matches_jax(ckpts, fam, dtype, quant):
    """Leaf by leaf bit-equal to JAX's loader (bf16 compared as bits)."""
    path = ckpts[fam][0]
    jcfg = j_config(path, dtype=getattr(jnp, dtype))
    tcfg = t_config(path, dtype=getattr(torch, dtype))
    jp = j_load(path, jcfg, weight_quant=quant)
    tp = t_load(path, tcfg, weight_quant=quant)
    jl, tl = _leaves(jp), _leaves(tp)
    assert len(jl) == len(tl)
    for a, b in zip(tl, jl):
        np.testing.assert_array_equal(_as_numpy(a), _as_numpy(b))


@pytest.mark.parametrize("fam", FAMILIES)
def test_prefill_logits_match_hf(ckpts, fam):
    path, hf = ckpts[fam]
    cfg = t_config(path, dtype=torch.float32)
    params = t_load(path, cfg)
    eng = Engine(cfg, CacheConfig(mode="full", max_length=SEQ + 8),
                 RuntimeConfig(), params, device="cpu")
    ids = np.random.RandomState(0).randint(1, cfg.vocab_size, (BATCH, SEQ))
    ours = eng.prefill(ids)[0][:, -1].numpy()
    with torch.no_grad():
        theirs = hf(torch.from_numpy(ids.astype(np.int64))).logits[:, -1]
    np.testing.assert_allclose(ours, theirs.float().numpy(), rtol=2e-4,
                               atol=2e-4)
