"""The port's training path against the JAX repo's training scripts
(``scripts/make_tiny_checkpoint.py``, ``train_tiny_model.py``,
``train_bench_weights.py``) and optax, on the CPU.

One tokenizer per test run (a session fixture): the port's
``build_tiny_checkpoint`` beside the script's, whose trained vocabularies
and merges must be equal; every data function then takes the port's
tokenizer on both sides.

Bounds: the samples, prompt streams and batches equal; ``full_logits`` in
f32 within 1e-4 of the largest |logit| (2 layers, hidden 128, head dim 32,
ctx 96 at query chunks of 32, so the padding to a whole chunk runs); the
loss within 1e-5 relative, each leaf's gradient within 1e-4 relative RMS
of JAX's; three optimizer steps' updates within 2e-6 of each leaf's
largest update (AdamW + clip + schedule against ``optax.chain(
clip_by_global_norm(1.0), adamw(...))``, Adafactor against
``optax.adafactor(min_dim_size_to_factor=128,
multiply_by_parameter_scale=False, clipping_threshold=None)`` with
factored and unfactored leaves; optax's weight decay alone is ~1e-5 of
an AdamW update here); the schedules within 1e-6 relative at every step;
the HF export bit-equal when read back by either package's loader, and
the port's safetensors writer bit-equal when read back by the
``safetensors`` package and the port's reader.
"""

from __future__ import annotations

import functools
import json
import os
import shutil

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

from scripts import make_tiny_checkpoint as j_mk
from scripts import train_bench_weights as j_tb
from scripts import train_tiny_model as j_tt
from shadowkv_tpu.core import rope as j_rope
from shadowkv_tpu.models.params import init_synthetic_params as j_init
from shadowkv_tpu.models.params import load_hf_params as j_load
from shadowkv_tpu.models.registry import config_from_hf_dir as j_hf_config
from shadowkv_tpu.models.registry import toy_config as j_toy
from shadowkv_tpu_torch.models.params import (
    from_jax_params,
    init_synthetic_params,
    load_hf_params,
    load_params_npz,
    save_hf_checkpoint,
)
from shadowkv_tpu_torch.models.registry import config_from_hf_dir
from shadowkv_tpu_torch.models.registry import toy_config as t_toy
from shadowkv_tpu_torch.tools import make_tiny_checkpoint as t_mk
from shadowkv_tpu_torch.tools import train_bench_weights as t_tb
from shadowkv_tpu_torch.tools import train_tiny_model as t_tt

CTX, CHUNK = 96, 32
TOY = dict(num_layers=2, hidden_size=128, num_heads=4, num_kv_heads=2,
           head_dim=32, intermediate_size=256, vocab_size=512)


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """One intra-op thread: the toy ops gain nothing from more, and under
    the suite's parallel workers spinning thread pools slow them down."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="session")
def tiny_dirs(tmp_path_factory):
    """(the port's base checkpoint, the script's)."""
    port = t_mk.build_tiny_checkpoint(str(tmp_path_factory.mktemp("t-tiny")))
    ref = j_mk.build_tiny_checkpoint(str(tmp_path_factory.mktemp("j-tiny")))
    return port, ref


@pytest.fixture(scope="session")
def tokenizer(tiny_dirs):
    from transformers import AutoTokenizer

    return AutoTokenizer.from_pretrained(tiny_dirs[0], local_files_only=True)


def test_tokenizer_and_geometry_match_script(tiny_dirs):
    port, ref = tiny_dirs
    with open(os.path.join(port, "tokenizer.json")) as f:
        t = json.load(f)
    with open(os.path.join(ref, "tokenizer.json")) as f:
        j = json.load(f)
    assert t["model"]["vocab"] == j["model"]["vocab"]
    assert t["model"]["merges"] == j["model"]["merges"]
    assert t["added_tokens"] == j["added_tokens"]
    # The config of each, as either package reads it.
    assert config_from_hf_dir(port, name="x") == config_from_hf_dir(ref,
                                                                     name="x")
    assert j_hf_config(port, name="x") == j_hf_config(ref, name="x")


def test_initial_weights_follow_llama_init(tiny_dirs):
    """N(0, 0.02) projections and embedding, ones for the norms."""
    cfg = config_from_hf_dir(tiny_dirs[0], dtype=torch.float32)
    p = load_hf_params(tiny_dirs[0], cfg)
    for w in (p.embed, p.lm_head, p.layers.wqkv, p.layers.w_down):
        assert abs(float(w.std()) - 0.02) < 2e-4 and abs(float(w.mean())) < 1e-4
    for w in (p.final_norm, p.layers.attn_norm, p.layers.mlp_norm):
        assert torch.equal(w, torch.ones_like(w))


def _het_ref(het, rng, batch, ctx):
    """The script's ``het_batch`` closure (``train_bench_weights.py``)."""
    starts = rng.randint(0, len(het) - ctx, batch)
    ids = np.stack([het[s: s + ctx] for s in starts])
    return ids, np.ones_like(ids)


@pytest.mark.parametrize("kind", ["dense", "ruler", "stream", "het"])
def test_samples_match_script(tokenizer, kind):
    if kind == "dense":
        got = t_tt.make_samples_dense(tokenizer, 3, 256, seed=11)
        want = j_tt.make_samples_dense(tokenizer, 3, 256, seed=11)
    elif kind == "ruler":
        got = t_tt.make_samples(tokenizer, 2, 1024, seed=5)
        want = j_tt.make_samples(tokenizer, 2, 1024, seed=5)
        assert (got[1] == 2).sum() > 0
    elif kind == "stream":
        got = (t_tb.build_prompt_stream(tokenizer, 6000, seed=17),)
        want = (j_tb.build_prompt_stream(tokenizer, 6000, seed=17),)
    else:
        het = t_tb.build_prompt_stream(tokenizer, 6000, seed=3)
        got = t_tb.het_batch(het, np.random.RandomState(4), 3, 128)
        want = _het_ref(het, np.random.RandomState(4), 3, 128)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def _toy_pair(seed: int = 0):
    """JAX f32 toy params with N(0, 0.1) weights and perturbed norms, and
    the same numbers as the port's params."""
    jcfg = j_toy(dtype=jnp.float32, **TOY)
    jp = jax.tree.map(np.asarray, j_init(jcfg, jax.random.PRNGKey(seed),
                                         scale=0.1))
    rng = np.random.RandomState(seed)

    def jitter(a):
        return (a + 0.1 * rng.randn(*a.shape)).astype(np.float32)

    jp = jp._replace(final_norm=jitter(jp.final_norm), layers=jp.layers._replace(
        attn_norm=jitter(jp.layers.attn_norm),
        mlp_norm=jitter(jp.layers.mlp_norm)))
    tcfg = t_toy(dtype=torch.float32, **TOY)
    return jcfg, jax.tree.map(jnp.asarray, jp), tcfg, from_jax_params(jp)


def _batch(seed: int = 1, b: int = 2):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, TOY["vocab_size"], (b, CTX)).astype(np.int32)
    mask = rng.choice([0, 1, 1, 1, 2], (b, CTX)).astype(np.int32)
    return ids, mask


@pytest.fixture
def jax_chunk(monkeypatch):
    """The script's attention at query chunks of CHUNK (its full_logits
    reads the module global)."""
    monkeypatch.setattr(j_tt, "_causal_attn",
                        functools.partial(j_tt._causal_attn, chunk=CHUNK))


def _j_loss(cfg, fill_weight):
    """The scripts' ``loss_fn`` (``train_tiny_model.py`` :303-316)."""
    cos_t, sin_t = j_rope.compute_cos_sin(cfg, CTX, dtype=jnp.float32)

    def loss_fn(p, ids, mask):
        s = ids.shape[1]
        logits = j_tt.full_logits(cfg, p, ids[:, : s - 1], cos_t[: s - 1],
                                  sin_t[: s - 1])
        tgt = ids[:, 1:s]
        m = mask[:, 1:s]
        ll = optax.softmax_cross_entropy_with_integer_labels(
            logits.astype(jnp.float32), tgt)
        w_ans = (m == 2).astype(jnp.float32)
        w_fill = (m == 1).astype(jnp.float32)
        ans = (ll * w_ans).sum() / jnp.maximum(w_ans.sum(), 1.0)
        fill = (ll * w_fill).sum() / jnp.maximum(w_fill.sum(), 1.0)
        return ans + fill_weight * fill, (ans, fill)

    return loss_fn


def test_full_logits_match_script(jax_chunk):
    jcfg, jp, tcfg, tp = _toy_pair()
    ids, _ = _batch()
    cos, sin = j_rope.compute_cos_sin(jcfg, CTX, dtype=jnp.float32)
    want = np.asarray(j_tt.full_logits(jcfg, jp, jnp.asarray(ids), cos, sin))
    tr = t_tt.tiny_trainer(tcfg, tp, 1e-3, 10, CTX, chunk=CHUNK)
    with torch.no_grad():
        got = t_tt.full_logits(tcfg, tp, torch.as_tensor(ids).long(),
                               tr.cos_t, tr.sin_t, CHUNK).numpy()
    assert got.shape == want.shape == (2, CTX, TOY["vocab_size"])
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err < 1e-4, err


@pytest.mark.parametrize("fill_weight", [0.1, 0.3])
def test_loss_and_grads_match_script(jax_chunk, fill_weight):
    jcfg, jp, tcfg, tp = _toy_pair()
    ids, mask = _batch()
    (jl, (ja, jf)), jg = jax.value_and_grad(_j_loss(jcfg, fill_weight),
                                            has_aux=True)(
        jp, jnp.asarray(ids), jnp.asarray(mask))
    tr = t_tt.Trainer(tcfg, tp, lambda leaves: None, CTX, fill_weight,
                      chunk=CHUNK)
    loss, ans, fill, grads = tr.grads(ids, mask)
    for t, j in ((loss, jl), (ans, ja), (fill, jf)):
        assert abs(float(t) - float(j)) <= 1e-5 * abs(float(j)), (t, j)
    jflat = dict(embed=jg.embed, final_norm=jg.final_norm,
                 lm_head=jg.lm_head,
                 **{f"layers.{f}": getattr(jg.layers, f)
                    for f in jg.layers._fields
                    if getattr(jg.layers, f) is not None})
    names = [n for n, _ in t_tt.named_leaves(tp)]
    assert sorted(names) == sorted(jflat)
    for name, g in zip(names, grads):
        want = np.asarray(jflat[name])
        rel = np.linalg.norm(g.numpy() - want) / np.linalg.norm(want)
        assert rel < 1e-4, (name, rel)


SHAPES = {"factored": (2, 128, 160), "factored-first": (256, 128),
          "unfactored": (2, 64), "vector": (96,)}


def _opt_case(scales, seed: int = 0):
    rng = np.random.RandomState(seed)
    params = {k: (0.3 * rng.randn(*s)).astype(np.float32)
              for k, s in SHAPES.items()}
    grads = [{k: (sc * rng.randn(*s)).astype(np.float32)
              for k, s in SHAPES.items()} for sc in scales]
    return params, grads


@pytest.mark.parametrize("which", ["adamw", "adafactor"])
def test_optimizer_matches_optax(which):
    """Three steps: the first's global norm above 1 (clipped), the others
    below; the schedule's warmup starts at 0, so the first update is 0 and
    the others not."""
    params, grads = _opt_case([0.02, 0.002, 0.001])
    lr, warm, decay = 1e-2, 2, 10
    sched = optax.warmup_cosine_decay_schedule(0.0, lr, warm, decay,
                                               end_value=lr * 0.1)
    t_sched = t_tt.warmup_cosine_decay_schedule(0.0, lr, warm, decay,
                                                end_value=lr * 0.1)
    if which == "adamw":
        opt = optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(sched))
        make = t_tt.AdamW
    else:
        opt = optax.chain(optax.clip_by_global_norm(1.0), optax.adafactor(
            learning_rate=sched, min_dim_size_to_factor=128,
            multiply_by_parameter_scale=False, clipping_threshold=None))
        make = t_tb.Adafactor
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    state = opt.init(jparams)
    leaves = [torch.tensor(params[k]) for k in SHAPES]
    topt = make(leaves, t_sched)
    if which == "adafactor":
        assert [d is not None for d in topt.dims] == [True, True, False,
                                                      False]
    for step, g in enumerate(grads):
        ju, state = opt.update({k: jnp.asarray(v) for k, v in g.items()},
                               state, jparams)
        jparams = optax.apply_updates(jparams, ju)
        tu = topt.updates([torch.tensor(g[k]) for k in SHAPES])
        for p, u in zip(leaves, tu):
            p.add_(u)
        for name, u in zip(SHAPES, tu):
            want = np.asarray(ju[name])
            scale = np.abs(want).max()
            assert (scale == 0) == (step == 0), (name, step)
            err = np.abs(u.numpy() - want).max()
            assert err <= 2e-6 * max(scale, 1e-30), (which, name, step, err)
            np.testing.assert_allclose(leaves[list(SHAPES).index(name)],
                                       np.asarray(jparams[name]),
                                       rtol=0, atol=1e-6)


@pytest.mark.parametrize("args", [(0.0, 7e-4, 201, 3000, 7e-5),
                                  (0.0, 3e-4, 50, 1650, 3e-5),
                                  (0.0, 1e-3, 1, 4, 1e-4)])
def test_schedule_matches_optax(args):
    want = optax.warmup_cosine_decay_schedule(*args[:4], end_value=args[4])
    got = t_tt.warmup_cosine_decay_schedule(*args[:4], end_value=args[4])
    steps = np.arange(args[3] + 20)
    w = np.asarray(jax.vmap(want)(jnp.asarray(steps)))
    g = np.array([got(int(s)) for s in steps])
    np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-12)


def test_trainers_schedules_match_scripts():
    """The schedules the two trainers build (``main`` of each script)."""
    for steps in (1500, 7):
        sched = optax.warmup_cosine_decay_schedule(
            0.0, 7e-4, min(200, steps // 5 + 1), 2 * steps, end_value=7e-5)
        tr = t_tt.tiny_trainer(*_toy_pair()[2:], 7e-4, steps, 16)
        for s in (0, 1, steps // 5, steps, 2 * steps):
            assert abs(tr.opt.schedule(s) - float(sched(s))) <= 1e-6 * 7e-4
    steps = 400
    warm = max(2, steps // 8)
    sched = optax.warmup_cosine_decay_schedule(0.0, 3e-4, warm,
                                               warm + 4 * steps,
                                               end_value=3e-5)
    tr = t_tb.bench_trainer(*_toy_pair()[2:], 3e-4, steps, 16)
    assert isinstance(tr.opt, t_tb.Adafactor) and tr.fill_weight == 0.3
    for s in (0, 1, warm, 3 * steps):
        assert abs(tr.opt.schedule(s) - float(sched(s))) <= 1e-6 * 3e-4


def test_hf_export_round_trip(tmp_path):
    """``save_hf_checkpoint`` read back by the port's and JAX's loaders; a
    CPU load owns its memory, so writing the checkpoint back over the file
    it came from leaves the loaded params intact."""
    _, jp, tcfg, tp = _toy_pair(3)
    d = str(tmp_path)
    save_hf_checkpoint(tp, tcfg, d)
    cfg = config_from_hf_dir(d, dtype=torch.float32)
    assert cfg == t_toy(name=cfg.name, dtype=torch.float32, **TOY)
    got = load_hf_params(d, cfg)
    jgot = j_load(d, j_hf_config(d, dtype=jnp.float32))
    for name, t in t_tt.named_leaves(tp):
        a = t_tt.named_leaves(got)
        assert torch.equal(dict(a)[name], t), name
        j = jgot.layers if name.startswith("layers.") else jgot
        np.testing.assert_array_equal(
            np.asarray(getattr(j, name.split(".")[-1])), t.numpy())
    save_hf_checkpoint(got, cfg, d)  # over the file the leaves came from
    for name, t in t_tt.named_leaves(tp):
        assert torch.equal(dict(t_tt.named_leaves(got))[name], t), name


def test_tiny_trainer_main_smoke(tiny_dirs, tmp_path):
    """``main`` at smoke size on the CPU writes a checkpoint that ``LLM``
    loads and generates text from."""
    from shadowkv_tpu_torch.models.llm import LLM

    out = str(tmp_path / "tiny")
    shutil.copytree(tiny_dirs[0], out)
    before = load_hf_params(out, config_from_hf_dir(out, dtype=torch.float32))
    res = t_tt.main(["--device", "cpu", "--steps", "2", "--ctx", "128",
                     "--out", out])
    assert res["steps"] == 2 and 0.0 <= res["self_test_acc"] <= 1.0
    llm = LLM("meta-llama/Llama-3-tiny", model_dir=out, max_length=256,
              dtype=torch.float32, device="cpu")
    after = llm.engine.params
    # step 0's learning rate is 0; step 1's is not
    assert not torch.equal(after.layers.wqkv, before.layers.wqkv)
    text = llm.generate(llm.encode("One of the special magic numbers for "
                                   "quiet-harbor is: 4182733."), gen_len=6)
    assert isinstance(text[0], str)


def test_bench_trainer_main_smoke(tiny_dirs, tmp_path):
    """``main --smoke`` on the CPU writes ``params.npz`` and ``prompt.npy``
    that an ``Engine`` generates from."""
    from shadowkv_tpu_torch.config import CacheConfig, RuntimeConfig
    from shadowkv_tpu_torch.models.engine import Engine

    out = str(tmp_path / "bench")
    res = t_tb.main(["--smoke", "--device", "cpu", "--steps", "2", "--ctx",
                     "128", "--batch", "1", "--prompt-tokens", "512",
                     "--tokenizer", tiny_dirs[0], "--out", out])
    assert res["steps"] == 2
    params = load_params_npz(os.path.join(out, "params.npz"))
    prompt = np.load(os.path.join(out, "prompt.npy"))
    assert prompt.shape == (512,) and prompt.dtype == np.int32
    cfg = t_tb.bench_model_config(smoke=True)
    init = init_synthetic_params(cfg, torch.Generator().manual_seed(0))
    for (n, a), (_, b) in zip(t_tt.named_leaves(params),
                              t_tt.named_leaves(init)):
        assert a.shape == b.shape and a.dtype == b.dtype == torch.float32, n
        assert not torch.equal(a, b) or n.endswith("norm"), n
    eng = Engine(cfg, CacheConfig(mode="full", max_length=512),
                 RuntimeConfig(), params, device="cpu")
    toks, _ = eng.generate(prompt[None, :256], gen_len=4)
    assert toks.shape == (1, 4)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32])
def test_write_safetensors_reads_back(tmp_path, dtype):
    """The port's writer: the ``safetensors`` package and the port's reader
    give back every tensor bit for bit; the header pads to 8 bytes."""
    from safetensors import safe_open

    from shadowkv_tpu_torch.models.params import (
        SafetensorsFile,
        write_safetensors,
    )

    g = torch.Generator().manual_seed(0)
    tensors = {"a": torch.randn(3, 5, generator=g).to(dtype),
               "b.weight": torch.randn(7, generator=g).to(dtype).t(),
               "c": torch.randn(2, 3, 4, generator=g).to(dtype)[:, 1]}
    path = str(tmp_path / "x.safetensors")
    size = write_safetensors(path, tensors)
    assert size == os.path.getsize(path)
    with open(path, "rb") as f:
        assert int.from_bytes(f.read(8), "little") % 8 == 0
    mine = SafetensorsFile(path)
    with safe_open(path, framework="pt") as ref:
        assert sorted(ref.keys()) == sorted(tensors)
        for k, t in tensors.items():
            assert torch.equal(ref.get_tensor(k), t), k
            assert torch.equal(mine.get(k), t), k
