"""Data and tensor parallelism of the port (``parallel/mesh.py``) against
the single-device port engine and the JAX package's (dp, tp) mesh.

Without spawning: ``shard_params`` of rank t equals block t of JAX's
``permute_packed_for_tp`` (int8 ``QTensor`` leaves included), and the
composition rules raise ``ValueError``.

Four gloo ranks (``torch_ranks.spawn``, once for the file) run the toy
model (2 layers, 8 heads / 4 KV heads, head_dim 32, f32) through: the tp=2
factorization (U bit-equal on both ranks, U and SV, sign-aligned per
direction, those of the single device within 1e-4); (dp=2, tp=2)
greedy generation on the XLA-gather branch, the fused refresh and the ring
gather (int8 stores), three offload paths, the full cache, tp=2 with the
stream prefill and with a per-head vs pattern table (each rank its heads'
rows), tp=4, dp=2 at temperature 0.6, (dp=2, tp=2) under
``use_pallas="auto"`` (the sampled hit rate averaged over the ranks), and the continuous batcher
over (dp=2, tp=2), V on the card and on the host, and ``LLM(dp=2,
tp=2)``, and tp=2 and dp=2 vs prefills with ``vs_sim="clustered"``
(each rank's slice of one device's draws). Each gives the
single-device port engine's tokens, and every rank returns the same
tokens; prefill logits agree within 1e-4. The (dp=2, tp=2) XLA run also
gives the JAX engine's tokens on its (dp=2, tp=2) mesh of 8 virtual
devices, on the same weights and sketch.

Context checkpoints on (dp=2, tp=2) (fused int8, XLA-gather, offload-ring,
offload-fused int8, HostVStore) and dp=2: a file saved on the mesh
resumes there with the unbroken run's tokens, loads on one device and, a
single-device file, on the mesh, with the single device's tokens; files
of other V placements load across; a file of another layout raises
ValueError on every rank; the dp=2 file equals the single device's field
by field (CKPT_FIELD_TOL: f32 sums in another order); JAX's (dp=2, tp=2) save -> load ->
``generate(cont=True)`` gives the port's tokens. Shared-prefix snapshots
over (dp=2, tp=2), V on the card and on the host: contexts restored across
the dp shards give the single-device batcher's tokens, and JAX's batcher
on its (dp=2, tp=2) mesh gives the same.
"""

from __future__ import annotations

import numpy as np
import pytest

import jax.numpy as jnp
import torch

import torch_ranks as R
from torch_ranks import fake_mesh
from shadowkv_tpu.config import CacheConfig as JCache
from shadowkv_tpu.config import RuntimeConfig as JRuntime
from shadowkv_tpu.models.engine import Engine as JEngine
from shadowkv_tpu.models.registry import toy_config as j_toy
from shadowkv_tpu.serving import ContinuousBatcher as JBatcher
from shadowkv_tpu.serving import Request as JRequest
from shadowkv_tpu.parallel.mesh import permute_packed_for_tp
from shadowkv_tpu_torch.config import CacheConfig, RuntimeConfig
from shadowkv_tpu_torch.core.lowrank import lowrank_kv_factors
from shadowkv_tpu_torch.core.wquant import QTensor, quantize_params
from shadowkv_tpu_torch.models.engine import Engine
from shadowkv_tpu_torch.models.params import from_jax_params
from shadowkv_tpu_torch.parallel import mesh as mesh_lib

LOGIT_TOL = 1e-4  # f32 toy: tp sums the o_proj / MLP halves in another order

SHADOW = {"mode": "shadow"}
# per query head: each tp rank takes its 4 rows of the table
VS_HEADS = ("vertical_and_slash", "stream_llm", "dense",
            ("vertical_and_slash", 32, 64)) * 2
INT8 = {"mode": "shadow", "kv_quant": "int8"}
VS_SIM = dict(prefill_pattern="vs", vs_vertical_size=64, vs_slash_size=64,
              vs_block=64, vs_sim="clustered")
OFFLOAD = {"mode": "shadow_offload"}
CASES = {
    "dp2tp2-xla": dict(dp=2, tp=2, cache=SHADOW),
    "dp2tp2-fused-int8": dict(dp=2, tp=2, cache=INT8,
                              rt=dict(use_pallas=True)),
    "dp2tp2-ring-int8": dict(dp=2, tp=2, cache=INT8,
                             rt=dict(ring_gather=True)),
    "dp2tp2-offload-ring": dict(dp=2, tp=2, cache=OFFLOAD,
                                rt=dict(ring_gather=True)),
    "dp2tp2-offload-host": dict(dp=2, tp=2, cache=OFFLOAD),
    "dp2tp2-offload-fused-int8": dict(
        dp=2, tp=2, cache=dict(OFFLOAD, kv_quant="int8"),
        rt=dict(use_pallas=True)),
    "dp2tp2-full": dict(dp=2, tp=2, cache={"mode": "full"}),
    "tp2-stream": dict(tp=2, cache=SHADOW, rt=dict(
        prefill_pattern="stream", stream_window=64, stream_sink=16)),
    "tp4-xla": dict(tp=4, cache=SHADOW),
    "tp2-vs": dict(tp=2, cache=SHADOW, rt=dict(
        prefill_pattern="vs", vs_vertical_size=64, vs_slash_size=64,
        vs_block=64, minference_patterns=VS_HEADS)),
    "dp2-sampled": dict(dp=2, cache=SHADOW, sample=dict(temperature=0.6)),
    "dp2tp2-auto": dict(dp=2, tp=2, cache=SHADOW, rt=dict(
        use_pallas="auto", pallas_auto_interval=2)),
    "tp2-vs-sim": dict(tp=2, cache=SHADOW, rt=VS_SIM),
    "dp2-vs-sim": dict(dp=2, cache=SHADOW, rt=VS_SIM),
}
SERVE = {
    "serve-dp2tp2": dict(dp=2, tp=2, cache=SHADOW),
    "serve-dp2tp2-offload-ring": dict(dp=2, tp=2, cache=OFFLOAD,
                                      rt=dict(ring_gather=True)),
}
SERVE_GEN = [4, 5, 6, 7]
# Shared contexts over (dp=2, tp=2), one slot a shard: the first chunk
# ends both first requests; slot 0 then restores context 1 (taken on slot
# 1, the other shard) and slot 1 context 0.
SERVE_CTX = {
    "serve-ctx-dp2tp2": dict(dp=2, tp=2, cache=SHADOW),
    "serve-ctx-dp2tp2-offload-ring": dict(dp=2, tp=2, cache=OFFLOAD,
                                          rt=dict(ring_gather=True)),
}
CTX_OF, CTX_GEN = [0, 1, 1, 0], [3, 6, 5, 4]
# Saved on the mesh; "loads" names earlier cases whose files this one
# loads too (across V placements).
OFFLOAD_INT8 = dict(OFFLOAD, kv_quant="int8")
CKPT = {
    "ckpt-dp2tp2-fused-int8": dict(dp=2, tp=2, cache=INT8,
                                   rt=dict(use_pallas=True)),
    "ckpt-dp2tp2-xla": dict(dp=2, tp=2, cache=SHADOW),
    "ckpt-dp2tp2-offload-ring": dict(dp=2, tp=2, cache=OFFLOAD,
                                     rt=dict(ring_gather=True),
                                     loads=["ckpt-dp2tp2-xla"]),
    "ckpt-dp2tp2-offload-fused-int8": dict(
        dp=2, tp=2, cache=OFFLOAD_INT8, rt=dict(use_pallas=True),
        loads=["ckpt-dp2tp2-fused-int8"]),
    "ckpt-dp2tp2-offload-host": dict(dp=2, tp=2, cache=OFFLOAD,
                                     loads=["ckpt-dp2tp2-offload-ring"]),
    "ckpt-dp2": dict(dp=2, cache=SHADOW, bad=True),
}
# f32 toy: a dp or pp file against the single device's, relative to each
# float field's largest value (the sums of a batch of one and of two
# rows differ in order); ids, masks and depths exactly
CKPT_FIELD_TOL = 1e-5
LLM_CASE = dict(kind="llm", dp=2, tp=2)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread, as the ranks have: the single-device references
    share the CPU with the other test workers and the spawned ranks."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    """Every case of the file on 4 gloo ranks, run once; the checkpoint
    cases' single-device runs (whose files the ranks load) first."""
    cases = [dict(kind="lowrank", tp=2, keys=_keys())]
    cases += [dict(c, kind="generate") for c in CASES.values()]
    cases += [dict(c, kind="serve", slots=2, gen_lens=SERVE_GEN)
              for c in SERVE.values()]
    cases.append(LLM_CASE)
    cases += [dict(c, kind="serve", slots=2, gen_lens=CTX_GEN,
                   contexts=CTX_OF) for c in SERVE_CTX.values()]
    w = R.weights()
    sketch = R.jax_sketch()
    ids = R.prompts(4)
    params = from_jax_params(w, device="cpu")
    ckpt, singles = R.ckpt_cases(CKPT, tmp_path_factory.mktemp("ckpt"),
                                 params, sketch, ids)
    cases += ckpt
    res = R.spawn(4, dict(cases=cases, weights=[w], sketch=sketch,
                          prompts=ids))
    return dict(cases=cases, res=res, w=w, sketch=sketch, ids=ids,
                params=params, singles=singles)


def _keys() -> np.ndarray:
    rng = np.random.default_rng(3)
    return rng.standard_normal((2, R.PROMPT, 4, 32)).astype(np.float32)


def _case(job, name):
    names = (["lowrank"] + list(CASES) + list(SERVE) + ["llm"]
             + list(SERVE_CTX) + list(CKPT))
    i = names.index(name)
    return job["cases"][i], [r[i] for r in job["res"]]


# ---------------------------------------------------------------------------
# Without ranks
# ---------------------------------------------------------------------------


def _np(leaf):
    if isinstance(leaf, QTensor):
        return (leaf.q.numpy(), leaf.s.numpy())
    return leaf.numpy()


def _jnp(leaf):
    if hasattr(leaf, "q") and hasattr(leaf, "s"):
        return (np.asarray(leaf.q), np.asarray(leaf.s))
    return np.asarray(leaf)


def _block(x, t, tp, axis):
    n = x.shape[axis] // tp
    return np.take(x, np.arange(t * n, (t + 1) * n), axis=axis)


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("quant", [False, True])
def test_shard_params_matches_jax_permute(tp, quant):
    """Rank t's shard is block t of JAX's permuted packed dims (wqkv,
    w_gate_up), of the input rows of wo / w_down and of the lm_head's
    columns; a QTensor scale follows its output dim (the row-sharded
    weights keep all of it)."""
    w = R.weights()
    jcfg = j_toy(dtype=jnp.float32, **R.SHAPE)
    jp = R.jax_params(w, quant)
    perm = permute_packed_for_tp(jp, jcfg, tp)
    tparams = from_jax_params(w, device="cpu")
    if quant:  # the port's quantization (equal to JAX's, test_torch_wquant)
        tparams = quantize_params(tparams)
    cfg = R.port_model()
    for t in range(tp):
        sh = mesh_lib.shard_params(tparams, cfg, fake_mesh(tp, t))
        for name, axis in (("wqkv", -1), ("w_gate_up", -1), ("wo", -2),
                           ("w_down", -2)):
            got = _np(getattr(sh.layers, name))
            want = _jnp(getattr(perm.layers, name))
            if isinstance(want, tuple):  # (q, s): s drops the input dim
                np.testing.assert_array_equal(
                    got[0], _block(want[0], t, tp, axis))
                np.testing.assert_array_equal(
                    got[1], want[1] if axis == -2
                    else _block(want[1], t, tp, -1))
            else:
                np.testing.assert_array_equal(got, _block(want, t, tp, axis))
        lm = _np(sh.lm_head)
        want = _jnp(jp.lm_head)
        if isinstance(want, tuple):
            np.testing.assert_array_equal(lm[0], _block(want[0], t, tp, -1))
            np.testing.assert_array_equal(lm[1], _block(want[1], t, tp, -1))
        else:
            np.testing.assert_array_equal(lm, _block(want, t, tp, -1))


def test_shard_params_pp_layers_and_loader():
    """Stage p holds layers [p L/pp, (p+1) L/pp); ``shard_jax_params`` is
    ``shard_params`` of ``from_jax_params``."""
    w = R.weights()
    cfg = R.port_model()
    full = from_jax_params(w, device="cpu")
    for p in range(2):
        m = fake_mesh(pp=2, p=p)
        sh = mesh_lib.shard_jax_params(w, cfg, m, device="cpu")
        np.testing.assert_array_equal(sh.layers.wqkv.numpy(),
                                      full.layers.wqkv[p:p + 1].numpy())
        np.testing.assert_array_equal(sh.embed.numpy(), full.embed.numpy())
    q = quantize_params(full)
    sh = mesh_lib.shard_params(q, cfg, fake_mesh(tp=2, t=1, pp=2, p=1))
    assert isinstance(sh.layers.wo, QTensor)
    assert tuple(sh.layers.wo.q.shape) == (1, 128, 256)
    assert tuple(sh.layers.wo.s.shape) == (1, 256)


def test_mesh_layouts_are_jax():
    """Rank r's coordinates follow JAX's device reshape: (dp, sp, tp) and
    (pp, dp) / (pp, tp), the last axis fastest."""
    m = fake_mesh(dp=2, sp=2, tp=2)
    m.coords = {"dp": 1, "sp": 0, "tp": 1, "pp": 0}
    assert m.batch_index == 2 and m.batch_rows(8) == slice(4, 6)
    assert m.prefill_rows(8) == slice(4, 8) and m.head_slice(4) == slice(2, 4)
    mp = fake_mesh(pp=4, p=3)
    assert mp.layer_slice(8) == slice(6, 8)


@pytest.mark.parametrize("rt_kw, match", [
    (dict(tp=3), "num_kv_heads"),
    (dict(tp=2), "torch.distributed"),
])
def test_tp_rules_raise(rt_kw, match):
    """tp must divide the KV heads; a mesh needs a process group."""
    cfg = R.port_model()
    with pytest.raises(ValueError, match=match):
        Engine(cfg, CacheConfig(mode="shadow", **R.CACHE),
               RuntimeConfig(**rt_kw), from_jax_params(R.weights()),
               device="cpu")


def test_mesh_must_match_runtime():
    cfg = R.port_model()
    with pytest.raises(ValueError, match="does not match"):
        Engine(cfg, CacheConfig(mode="shadow", **R.CACHE),
               RuntimeConfig(dp=2), from_jax_params(R.weights()),
               device="cpu", mesh=fake_mesh(tp=2))


# ---------------------------------------------------------------------------
# Gloo ranks
# ---------------------------------------------------------------------------


def test_lowrank_tp_factors(job):
    """tp=2: U is bit-equal on the two ranks of a tp group; each rank's SV
    is its head slice of the single-device factors. eigh fixes each
    direction up to its sign, and the summed Grams round differently, so
    directions are sign-aligned to the single-device U first."""
    case, res = _case(job, "lowrank")
    keys = torch.from_numpy(case["keys"])
    u1, sv1 = lowrank_kv_factors(keys, R.RANK, 4, 32, dtype=torch.float32,
                                 omega=torch.from_numpy(job["sketch"]))
    u1, sv1 = u1.numpy(), sv1.numpy()
    np.testing.assert_array_equal(res[0]["u"], res[1]["u"])
    u = res[0]["u"]
    sign = np.sign(np.einsum("bsr,bsr->br", u, u1))  # [B, r]
    assert np.abs(u * sign[:, None] - u1).max() <= 1e-4
    for t in range(2):
        sv = res[t]["sv"] * sign[:, None, :, None]
        ref = sv1[:, 2 * t:2 * t + 2]
        assert np.abs(sv - ref).max() <= 1e-4 * np.abs(ref).max()


@pytest.mark.parametrize("name", list(CASES))
def test_mesh_generation_matches_single(job, name):
    """Greedy (or sampled) tokens equal the single-device port engine's on
    every rank; prefill logits within LOGIT_TOL."""
    case, res = _case(job, name)
    ref = R.single(case, job["params"], job["sketch"], job["ids"])
    for r in res:
        np.testing.assert_array_equal(r["tokens"], ref["tokens"])
        np.testing.assert_allclose(r["logits"], ref["logits"], rtol=0,
                                   atol=LOGIT_TOL)


@pytest.mark.parametrize("name", list(SERVE))
def test_continuous_batching_sharded_mesh(job, name):
    """The batcher over (dp=2, tp=2): every request's tokens equal the
    single-device batcher's, on every rank (JAX
    ``test_continuous_batching_sharded_mesh`` and its offload sibling)."""
    case, res = _case(job, name)
    ref = R.single(case, job["params"], job["sketch"], job["ids"])
    for r in res:
        assert r["admissions"] == len(SERVE_GEN) - 2
        assert sorted(r["tokens"]) == sorted(ref["tokens"])
        for uid, toks in ref["tokens"].items():
            np.testing.assert_array_equal(r["tokens"][uid], toks)


def test_llm_takes_mesh_axes(job, monkeypatch):
    """``LLM(dp=2, tp=2)`` in a world of 4 ranks (its synthetic weights,
    no tokenizer) generates the single-device LLM's tokens on every rank."""
    from shadowkv_tpu_torch.models import llm as llm_mod

    case, res = _case(job, "llm")
    monkeypatch.setattr(llm_mod, "model_config",
                        lambda *a, **k: R.port_model())
    monkeypatch.setattr(llm_mod, "load_tokenizer", lambda *a: None)
    ref = R.run_case({k: v for k, v in case.items()
                      if k not in ("dp", "tp")}, None, job["sketch"],
                     job["ids"])
    for r in res:
        np.testing.assert_array_equal(r["tokens"], ref["tokens"])


def test_evaluator_counts_one_rank_per_replica():
    """eval_acc's data parallelism over model replicas: the dataset shards
    over replicas and only a replica's first rank writes and counts."""
    from shadowkv_tpu_torch.eval.evaluator import DistConfig

    d = DistConfig(True, rank=3, world_size=8, master_process=False,
                   model_ranks=4)
    assert (d.replica, d.replicas, d.writer) == (0, 2, False)
    d.rank = 4
    assert (d.replica, d.writer) == (1, True)


def test_mesh_matches_jax_engine(job):
    """(dp=2, tp=2) on the XLA-gather branch gives the tokens of the JAX
    engine on its (dp=2, tp=2) mesh (8 virtual CPU devices), on the same
    weights and sketch."""
    _, res = _case(job, "dp2tp2-xla")
    jcfg = j_toy(dtype=jnp.float32, **R.SHAPE)
    je = JEngine(jcfg, JCache(mode="shadow", **R.CACHE),
                 JRuntime(prefill_block_q=64, dp=2, tp=2),
                 R.jax_params(job["w"], False))
    want, _ = je.generate(job["ids"], gen_len=R.GEN)
    np.testing.assert_array_equal(res[0]["tokens"], np.asarray(want))


@pytest.mark.parametrize("name", list(CKPT))
def test_mesh_checkpoint_resumes(job, name):
    """Saved on the mesh after CKPT_FIRST greedy tokens: resumed there, the
    unbroken mesh run's tokens; the single-device file (and the files of
    ``loads``, other V placements) resumed on the mesh, and the mesh file
    resumed on one device, the single device's unbroken tokens, on every
    rank (``torch_ranks.check_ckpt``); the dp=2 file equals the single
    device's field by field (CKPT_FIELD_TOL). On a tp mesh the writer
    checked that the tp ranks' U copies are bit-equal
    (``checkpoint.VERIFY_SHARED``); the other tp-sharded fields are held
    by the resumed tokens."""
    case, res = _case(job, name)
    R.check_ckpt(case, res, job["singles"][name], job["params"],
                 job["sketch"], CKPT_FIELD_TOL)


def test_checkpoint_layout_mismatch_raises_on_every_rank(job):
    """A file of another layout raises ValueError on every rank, and the
    ranks go on to the next case."""
    _, res = _case(job, "ckpt-dp2")
    assert len(res) == 4
    for r in res:
        assert "does not match" in r["bad"]


def test_mesh_checkpoint_matches_jax_engine(job, tmp_path):
    """JAX's (dp=2, tp=2) engine: save -> load -> ``generate(cont=True)``
    gives the port's resumed (dp=2, tp=2) tokens."""
    _, res = _case(job, "ckpt-dp2tp2-xla")
    je = JEngine(j_toy(dtype=jnp.float32, **R.SHAPE),
                 JCache(mode="shadow", **R.CACHE),
                 JRuntime(prefill_block_q=64, dp=2, tp=2),
                 R.jax_params(job["w"], False))
    first, _ = je.generate(job["ids"], gen_len=R.CKPT_FIRST)
    path = str(tmp_path / "jax.npz")
    je.save_state(path)
    je.load_state(path)
    rest, _ = je.generate(np.asarray(first)[:, 1:],
                          gen_len=R.CKPT_GEN - R.CKPT_FIRST, cont=True)
    want = np.concatenate([np.asarray(first), np.asarray(rest)], axis=1)
    np.testing.assert_array_equal(res[0]["resumed"], want)


@pytest.mark.parametrize("name", list(SERVE_CTX))
def test_snapshots_restore_across_dp_shards(job, name):
    """Shared contexts over (dp=2, tp=2): both restores cross dp shards,
    and every request's tokens equal the single-device batcher's."""
    case, res = _case(job, name)
    ref = R.single(case, job["params"], job["sketch"], job["ids"])
    for r in res:
        assert r["cross"] == 2 and r["hits"] == 2
        assert sorted(r["tokens"]) == sorted(ref["tokens"])
        for uid, toks in ref["tokens"].items():
            np.testing.assert_array_equal(r["tokens"][uid], toks)


def test_mesh_snapshots_match_jax_batcher(job):
    """JAX's batcher on its (dp=2, tp=2) mesh (unquantized stores, the
    XLA-gather branch) serves the shared-context requests with the port's
    tokens."""
    _, res = _case(job, "serve-ctx-dp2tp2")
    je = JEngine(j_toy(dtype=jnp.float32, **R.SHAPE),
                 JCache(mode="shadow", **R.CACHE),
                 JRuntime(prefill_block_q=64, dp=2, tp=2),
                 R.jax_params(job["w"], False))
    reqs = R.context_requests(job["ids"], CTX_OF, CTX_GEN, JRequest)
    want, stats = JBatcher(je, slots=2).run(reqs)
    assert stats.context_hits == 2
    for uid, toks in want.items():
        np.testing.assert_array_equal(res[0]["tokens"][uid],
                                      np.asarray(toks))


@pytest.mark.parametrize("mesh_kw, rows, layers", [
    (dict(tp=2, t=1), (0, 4), (0, 2)),
    (dict(dp=2), (2, 4), (0, 2)),
    (dict(pp=2, p=1), (0, 4), (1, 2)),
])
def test_sim_draws_are_a_slice_of_the_global_draws(mesh_kw, rows, layers):
    """A rank's ``vs_sim`` draws (``minference.SimShard``) are its rows,
    heads and global layer's slice of one device's: tp rank 1 its heads,
    dp shard 1 its rows, pp stage 1 its layer as the salt."""
    from shadowkv_tpu_torch.core import minference as mi

    mesh = fake_mesh(**mesh_kw)
    mesh.groups["tp"] = None  # no process group: nothing is summed here
    if mesh.dp > 1:
        mesh.coords["dp"] = 1
    eng = Engine(R.port_model(), CacheConfig(mode="shadow", **R.CACHE),
                 RuntimeConfig(**VS_SIM, dp=mesh.dp, tp=mesh.tp, pp=mesh.pp),
                 from_jax_params(R.weights()), device="cpu", mesh=mesh)
    h, s = R.SHAPE["num_heads"], 128
    heads = mesh.head_slice(h)
    r0, r1 = rows
    sim = eng._sim(4, 4, r0)
    for local in range(layers[1] - layers[0]):
        whole = mi.sim_vs_draws(4, h, s, salt=layers[0] + local)
        mine = mi.sim_vs_draws(r1 - r0, heads.stop - heads.start, s,
                               salt=local + sim.layer0, shard=sim)
        for w, m in zip(whole, mine):
            assert torch.equal(m, w[r0:r1, heads])


def test_sim_draws_follow_the_single_device_sub_batches():
    """One device prefilling 3 rows 2 at a time draws once per sub-batch;
    a shard's rows 1..2 cross both and take each from its own draw; with
    a per-head table only the vertical_and_slash heads are drawn."""
    from shadowkv_tpu_torch.core import minference as mi

    s = 64
    first = mi.sim_vs_draws(2, 4, s, salt=3)
    second = mi.sim_vs_draws(1, 4, s, salt=3)
    shard = mi.SimShard(batch=3, sub=2, row0=1, heads=4, head0=2)
    got = mi.sim_vs_draws(2, 2, s, salt=3, shard=shard)
    for g, a, b in zip(got, first, second):
        assert torch.equal(g[0], a[1, 2:]) and torch.equal(g[1], b[0, 2:])
    table = ("dense", "vertical_and_slash", "stream_llm",
             "vertical_and_slash") * 2
    vs = dict(VS_SIM, minference_patterns=table)
    mesh = fake_mesh(tp=2, t=1)
    mesh.groups["tp"] = None
    eng = Engine(R.port_model(), CacheConfig(mode="shadow", **R.CACHE),
                 RuntimeConfig(**vs, tp=2), from_jax_params(R.weights()),
                 device="cpu", mesh=mesh)
    sim = eng._sim(4, 4, 0)
    assert (sim.heads, sim.head0) == (4, 2)


def test_batch_rows_sampling_equals_single(job):
    """A dp rank draws the whole batch's numbers and keeps its rows: the
    sampled tokens of the dp=2 run are the single engine's (checked in
    test_mesh_generation_matches_single[dp2-sampled]); here the rows
    argument itself."""
    from shadowkv_tpu_torch.core.sampling import sample_token

    logits = torch.randn(4, 64, generator=torch.Generator().manual_seed(0))
    whole = sample_token(logits, torch.Generator().manual_seed(5), 0.6)
    half = sample_token(logits[2:], torch.Generator().manual_seed(5), 0.6,
                        rows=(2, 4))
    assert torch.equal(whole[2:], half)


def test_local_model_is_head_scaled():
    cfg = R.port_model()
    loc = mesh_lib.local_model(cfg, fake_mesh(tp=2, pp=2))
    assert (loc.num_heads, loc.num_kv_heads, loc.intermediate_size,
            loc.num_layers) == (4, 2, 256, 1)
