"""K-EXAONE's hybrid decoder on the port (CPU, float32 toy): a dense layer,
then two LLLG periods (sliding window 8, NoPE global layers), QK-norm,
post-norm blocks and MoE layers of 16 experts (top 4, one shared), this
device holding 4 of them; against the plain reference
``tests/reference_k_exaone.py``.

Tolerances: the port and the reference both compute in float32 here, in
different orders (fused QKV, head-major buffers, the masked expert pass,
f32 sums of another order); over 9 layers of post-norm blocks that leaves
~1e-6 of the logits' spread, so 1e-4 of it bounds them with room, while a
bf16 rounding anywhere (2^-8 relative) would exceed it. The ShadowKV run
rebuilds the selected chunks' keys from U @ SV at full rank (exact up to
f32 rounding, ~1e-6), so the same bound holds there.
"""

import json

import numpy as np
import pytest
import torch

from shadowkv_tpu_torch.cache.hybrid import HybridState
from shadowkv_tpu_torch.config import CacheConfig, ModelConfig, RuntimeConfig
from shadowkv_tpu_torch.core import moe as moe_lib
from shadowkv_tpu_torch.core.layers import ModelParams
from shadowkv_tpu_torch.kernels.reconstruct import sparse_refresh_plain
from shadowkv_tpu_torch.models.engine import Engine
from shadowkv_tpu_torch.models.registry import (choose_model_config,
                                                config_from_hf_dir)
import reference_k_exaone as ref

LLLG = ("sliding_attention",) * 3 + ("full_attention",)
TOL = 1e-4  # of the reference logits' spread (module docstring)


def toy_model(**kw) -> ModelConfig:
    cfg = dict(
        name="toy-k-exaone", num_layers=9, hidden_size=128, num_heads=4,
        num_kv_heads=2, head_dim=32, intermediate_size=256, vocab_size=256,
        rms_norm_eps=1e-5, rope_theta=10000.0, max_position_embeddings=4096,
        dtype=torch.float32, layer_types=("sliding_attention",) + LLLG * 2,
        sliding_window=8, exaone4_block=True,
        mlp_layer_types=("dense",) + ("sparse",) * 8,
        moe_intermediate_size=32, num_experts=16, num_experts_per_tok=4,
        num_shared_experts=1, routed_scaling_factor=2.5,
        held_experts=(0, 1, 2, 3))
    cfg.update(kw)
    return ModelConfig(**cfg)


def draw(md: ModelConfig, seed: int) -> dict:
    """Weights of every expert (``experts_*`` [Lm, E, ...]), float32."""
    g = torch.Generator().manual_seed(seed)
    L, D, H, K, Dh = (md.num_layers, md.hidden_size, md.num_heads,
                      md.num_kv_heads, md.head_dim)
    ld = sum(t == "dense" for t in md.mlp_layer_types)
    lm, E, Ie = len(md.moe_layers), md.num_experts, md.moe_intermediate_size

    def n(*shape, std=0.1):
        return torch.randn(*shape, generator=g) * std

    def gain(*shape):
        return 1.0 + n(*shape)

    w = dict(
        embed=n(md.vocab_size, D, std=1.0), wqkv=n(L, D, (H + 2 * K) * Dh),
        wo=n(L, H * Dh, D), q_norm=gain(L, Dh), k_norm=gain(L, Dh),
        post_attn_norm=gain(L, D), post_mlp_norm=gain(L, D),
        dense_gate_up=n(ld, D, 2 * md.intermediate_size),
        dense_down=n(ld, md.intermediate_size, D),
        router=n(lm, D, E, std=D ** -0.5), e_bias=n(lm, E, std=0.02),
        experts_gate_up=n(lm, E, D, 2 * Ie), experts_down=n(lm, E, Ie, D),
        shared_gate_up=n(lm, D, 2 * Ie), shared_down=n(lm, Ie, D),
        final_norm=gain(D), lm_head=n(D, md.vocab_size))
    return w


def share(w: dict, held) -> dict:
    """The weights a device holding experts ``held`` keeps."""
    out = dict(w, held=list(held))
    idx = torch.tensor(list(held), dtype=torch.long)
    for k in ("experts_gate_up", "experts_down"):
        out[k] = w[k][:, idx]
    return out


def ref_md(md: ModelConfig) -> dict:
    return dict(num_heads=md.num_heads, num_kv_heads=md.num_kv_heads,
                head_dim=md.head_dim, rms_norm_eps=md.rms_norm_eps,
                sliding_window=md.sliding_window,
                layer_types=md.layer_types,
                mlp_layer_types=md.mlp_layer_types,
                rope_theta=md.rope_theta,
                num_experts_per_tok=md.num_experts_per_tok,
                norm_topk_prob=md.norm_topk_prob,
                routed_scaling_factor=md.routed_scaling_factor)


def engine(md, w, mode="full", **cache_kw):
    cc = dict(mode=mode, max_length=256, gen_capacity=16)
    cc.update(cache_kw)
    wh = share(w, md.held)
    return Engine(md, CacheConfig(**cc), RuntimeConfig(use_pallas=True),
                  ModelParams.from_tensors(wh, md), device="cpu"), wh


def run_engine(eng, ids, steps):
    """Prefill + greedy decode steps of every row, with each row's routing
    recorded: (prefill logits [B, V], step logits [T, B, V], fed tokens [B,
    T], routes {m: [B, S + T, k]})."""
    eng.record_routes(range(ids.shape[0]))
    pre, cache = eng.prefill(ids)
    tok = pre[:, -1].argmax(-1).to(torch.int32)
    fed, lg, rid = [], [], []
    for _ in range(steps):
        fed.append(tok.clone())
        tok, logits = eng.decode_step(cache, tok)
        lg.append(logits.clone())
        rid.append(cache.hybrid.route_ids.clone())
    hy = cache.hybrid
    routes = {m: torch.cat([hy.prefill_routes[m],
                            torch.stack([r[m] for r in rid], 1)], 1)
              for m in range(hy.prefill_routes.shape[0])}
    return pre[:, -1], torch.stack(lg), torch.stack(fed, 1), routes, cache


def check_rows(md, wh, ids, pre, lg, fed, routes):
    s = ids.shape[1]
    for r in range(ids.shape[0]):
        seq = torch.cat([torch.as_tensor(ids[r]), fed[r].long()])
        chosen = {m: routes[m][r] for m in routes}
        want, info = ref.forward(ref_md(md), wh, seq, routes=chosen)
        for m in chosen:  # the program chose the reference's top experts
            assert ref.route_regret(info["scores"][m], wh["e_bias"][m],
                                    chosen[m]) < 1e-5
        got = torch.cat([pre[r][None], lg[:, r]])
        exp = want[s - 1:s - 1 + got.shape[0]]
        err = float((got - exp).abs().max() / exp.std())
        assert err < TOL, err


def test_full_cache_prefill_and_decode_match_the_reference():
    md = toy_model()
    w = draw(md, 0)
    ids = np.random.default_rng(0).integers(0, md.vocab_size, (2, 40))
    eng, wh = engine(md, w)
    pre, lg, fed, routes, cache = run_engine(eng, ids, 6)
    # the caches: the 2 global layers' rows, a ring of 8 for the 7 sliding
    assert cache.k.shape[0] == 2 and cache.hybrid.ring_k.shape[:1] == (7,)
    assert cache.hybrid.ring_k.shape[3] == 8
    check_rows(md, wh, ids, pre, lg, fed, routes)


def test_shadow_step_follows_the_reference():
    """ShadowKV on the two NoPE global layers (kernel A's no-RoPE plain
    version, every context chunk selected, full rank), the rings on the
    sliding ones; the reference follows the program's expert choices."""
    md = toy_model()
    w = draw(md, 1)
    ids = np.random.default_rng(1).integers(0, md.vocab_size, (2, 128))
    eng, wh = engine(md, w, mode="shadow", sparse_budget=80, rank=64,
                     chunk_size=4, local_chunks=2, outlier_chunks=4)
    pre, lg, fed, routes, cache = run_engine(eng, ids, 6)
    assert cache.k_buf.shape[0] == 2 and cache.u.shape[0] == 2
    check_rows(md, wh, ids, pre, lg, fed, routes)


@pytest.mark.parametrize("restore", [True, False])
def test_per_slot_depth_reset_restores_the_window(restore, monkeypatch):
    """A round on a slot whose depth is reset starts from the prompt's
    window again: the same tokens give the same logits, up to the order in
    which the slot-stable selection places the chunks (the round before
    left its selection in the slots); without the ring's restore they
    differ."""
    if not restore:
        monkeypatch.setattr(HybridState, "restore", lambda self, slot: None)
    md = toy_model()
    w = draw(md, 2)
    ids = np.random.default_rng(2).integers(0, md.vocab_size, (2, 128))
    eng, _ = engine(md, w, mode="shadow", sparse_budget=32, rank=64,
                    chunk_size=4, local_chunks=2, outlier_chunks=4,
                    gen_capacity=4)
    _, cache = eng.prefill(ids)
    eng.use_slot_depths(cache)
    q = torch.tensor([5, 9], dtype=torch.int32)
    rounds = []
    for _ in range(2):
        for slot in range(2):
            eng.reset_slot_depth(slot, 4)
        tok, lgs = q, []
        for _ in range(4):
            tok, logits = eng.decode_step(cache, tok)
            lgs.append(logits.clone())
        rounds.append(torch.stack(lgs))
    err = float((rounds[0] - rounds[1]).abs().max() / rounds[0].std())
    assert (err < TOL) == restore, err


@pytest.mark.parametrize("static", [True, False])
def test_expert_shares_sum_to_the_uncut_layer(static):
    """Every device's routed part, with the shared expert counted once,
    adds up to the uncut reference MoE layer."""
    md = toy_model()
    w = draw(md, 3)
    x = torch.randn(1, 24, md.hidden_size, generator=torch.Generator()
                    .manual_seed(3)) * 3
    m = 2
    uncut, _, _ = ref.moe(ref_md(md), share(w, range(16)), m, x[0])
    total = 0
    for shard in range(4):
        held = tuple(range(4 * shard, 4 * shard + 4))
        mdj = toy_model(held_experts=held)
        hp = ModelParams.from_tensors(share(w, held), mdj)
        out, top = moe_lib.moe(mdj, hp.moe.layer(mdj.moe_layers[m]), x,
                               static)
        total = total + out[0]
        assert top.shape == (1, 24, 4)
    shared = ref.swiglu(x[0], w["shared_gate_up"][m], w["shared_down"][m])
    err = (total - 3 * shared - uncut).abs().max() / uncut.std()
    assert err < 1e-5, err


def _window_model(win):
    return toy_model(num_layers=1, layer_types=("sliding_attention",),
                     mlp_layer_types=("dense",), sliding_window=win,
                     held_experts=None, num_experts=0,
                     num_experts_per_tok=0, moe_intermediate_size=0)


@pytest.mark.parametrize("win", [8, 128])
def test_window_edge(win):
    """One sliding layer: the output at position p moves with the token
    W - 1 back and not with the token W back, at prefill (kernel C's plain
    version) and at decode (the ring)."""
    md = _window_model(win)
    w = draw(md, 4)
    eng, _ = engine(md, w, max_length=512)
    s = win + 20
    ids = np.random.default_rng(4).integers(0, md.vocab_size, (1, s))

    def prefill_out(row):
        return eng.prefill(row[None])[0][0, -1]

    def decode_out(row):
        _, cache = eng.prefill(row[None, :-1])
        return eng.decode_step(cache, torch.tensor([int(row[-1])],
                                                   dtype=torch.int32))[1][0]

    for out in (prefill_out, decode_out):
        base = out(ids[0])
        far, near = ids[0].copy(), ids[0].copy()
        far[s - 1 - win] = (far[s - 1 - win] + 1) % md.vocab_size
        near[s - win] = (near[s - win] + 1) % md.vocab_size
        assert torch.equal(out(far), base)  # W back: not seen
        assert not torch.allclose(out(near), base)  # W - 1 back: seen


def test_rope_on_sliding_layers_only():
    """The global layers' cached keys are unrotated (NoPE); the rings hold
    rotated keys: both as the reference attends them."""
    md = toy_model()
    w = draw(md, 5)
    ids = np.random.default_rng(5).integers(0, md.vocab_size, (1, 40))
    eng, wh = engine(md, w)
    _, cache = eng.prefill(ids)
    _, info = ref.forward(ref_md(md), wh, torch.as_tensor(ids[0]),
                          keep_keys=True)
    g = s = 0
    for layer, kind in enumerate(md.layer_types):
        k = info["keys"][layer]  # [S, K, Dh]
        if kind == "full_attention":
            got = cache.k[g, 0, :, :40].transpose(0, 1)
            g += 1
        else:
            pos = torch.arange(32, 40)
            got = cache.hybrid.ring_k[s, 0][:, pos % 8].transpose(0, 1)
            k = k[32:]
            s += 1
        assert (got - k).abs().max() / k.abs().max() < 1e-5
    # a rotated key differs from the cached one of a global layer
    rot = ref.rope(info["keys"][4], torch.arange(40), md.rope_theta)
    assert (rot - cache.k[1, 0, :, :40].transpose(0, 1)).abs().max() > 1e-2


def test_refresh_plain_no_rope_writes_unrotated_keys():
    """Kernel A's plain version with ``rope_style="none"``: a missed
    chunk's K rows are U @ SV as they are, its V rows copied."""
    g = torch.Generator().manual_seed(6)
    L, B, K, cs, C, r, dh, S = 2, 2, 3, 4, 12, 8, 16, 3
    u = torch.randn(L, B, C * cs, r, generator=g)
    sv = torch.randn(L, B, K, r, dh, generator=g)
    v = torch.randn(L, B, K, C * cs, dh, generator=g)
    cap = 40
    kb, vb = torch.zeros(L, B, K, cap, dh), torch.zeros(L, B, K, cap, dh)
    mc = torch.tensor([[[1, 5, 7]] * K] * B, dtype=torch.int32)
    ms = torch.tensor([[[0, 2, 1]] * K] * B, dtype=torch.int32)
    cnt = torch.full((B, K), 3, dtype=torch.int32)
    inv = torch.rand(dh, generator=g)
    sparse_refresh_plain(1, mc, ms, cnt, u, sv, v, inv, kb, vb,
                         chunk_size=cs, sparse_start=8, rope_dim=dh,
                         rope_style="none")
    for c, slot in ((1, 0), (5, 2), (7, 1)):
        rows = slice(c * cs, c * cs + cs)
        dst = slice(8 + slot * cs, 8 + slot * cs + cs)
        want = torch.einsum("bnr,bkrd->bknd", u[1][:, rows], sv[1])
        assert torch.allclose(kb[1][:, :, dst], want, atol=1e-5)
        assert torch.equal(vb[1][:, :, dst], v[1][:, :, rows])
    assert not kb[0].any()


@pytest.mark.parametrize("rt", [dict(tp=2), dict(pp=2), dict(dp=2)])
def test_hybrid_refuses_the_mesh(rt):
    md = toy_model()
    with pytest.raises(ValueError, match="one device"):
        Engine(md, CacheConfig(mode="shadow"), RuntimeConfig(**rt),
               ModelParams.from_tensors(share(draw(md, 7), md.held), md),
               device="cpu")


def test_hybrid_refuses_offload():
    md = toy_model()
    with pytest.raises(ValueError, match="shadow_offload"):
        Engine(md, CacheConfig(mode="shadow_offload"),
               RuntimeConfig(use_pallas=True),
               ModelParams.from_tensors(share(draw(md, 7), md.held), md),
               device="cpu")


def test_config_from_an_exaone_moe_config_json(tmp_path):
    hf = {"architectures": ["ExaoneMoEForCausalLM"],
          "model_type": "exaone_moe", "num_hidden_layers": 48,
          "hidden_size": 6144, "num_attention_heads": 64,
          "num_key_value_heads": 8, "head_dim": 128,
          "intermediate_size": 18432, "vocab_size": 153600,
          "rms_norm_eps": 1e-5, "max_position_embeddings": 262144,
          "rope_parameters": {"rope_theta": 1000000, "rope_type": "default"},
          "sliding_window": 128, "sliding_window_pattern": "LLLG",
          "first_k_dense_replace": 1, "moe_intermediate_size": 2048,
          "num_experts": 128, "num_experts_per_tok": 8,
          "num_shared_experts": 1, "routed_scaling_factor": 2.5,
          "norm_topk_prob": True, "scoring_func": "sigmoid", "n_group": 1,
          "topk_group": 1}
    (tmp_path / "config.json").write_text(json.dumps(hf))
    got = config_from_hf_dir(str(tmp_path), name="K-EXAONE-236B-A23B")
    assert got == choose_model_config("K-EXAONE-236B-A23B")
    assert len(got.global_layers) == 12 and len(got.moe_layers) == 47
    hf["n_group"] = 8
    (tmp_path / "config.json").write_text(json.dumps(hf))
    with pytest.raises(ValueError, match="sigmoid router"):
        config_from_hf_dir(str(tmp_path))
