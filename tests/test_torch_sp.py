"""Sequence parallelism of the port (``forward.prefill_shadow_sp`` and
kernel B's query-offset form) against the single-device port engine and
the JAX package's sp mesh.

Without spawning: the plain offset attention
(``causal_prefill_attention(offset=)``, the CPU path of
``causal_prefill_offset``) against JAX's ``causal_prefill_attention(offset=)``
within 1e-5; the offset tile plan against the dense causal mask; the sp
composition rules (``ValueError``, JAX ``test_sp_rejects_unsupported_modes``)
and the batcher's refusal.

Four gloo ranks (once for the file) run the toy model with (sp=2, tp=2),
(dp=2, sp=2) and sp=2: greedy tokens equal the single-device port
engine's on every rank, prefill logits within 2e-4 (JAX's
``test_sp_prefill_logits_match`` bound); the (sp=2, tp=2) tokens equal the
JAX engine's on its (dp=1, sp=2, tp=2) mesh of virtual CPU devices.
Context checkpoints saved on (sp=2, tp=2) and sp=2 (after the prefill
the cache is sharded over the decode batch) resume on their mesh with the
unbroken run's tokens and on one device with the single device's, the
single-device file and the (sp=2, tp=2) file resume on sp=2, and the
sp=2 file equals the single device's field by field.
"""

from __future__ import annotations

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import torch_ranks as R
from torch_ranks import fake_mesh
from shadowkv_tpu.config import CacheConfig as JCache
from shadowkv_tpu.config import RuntimeConfig as JRuntime
from shadowkv_tpu.core.attention import (
    causal_prefill_attention as j_causal,
)
from shadowkv_tpu.models.engine import Engine as JEngine
from shadowkv_tpu.models.registry import toy_config as j_toy
from shadowkv_tpu_torch.config import CacheConfig, RuntimeConfig
from shadowkv_tpu_torch.core.attention import causal_prefill_attention
from shadowkv_tpu_torch.kernels.prefill_attention import (
    TILE,
    causal_prefill_offset,
    prefill_tile_plan,
)
from shadowkv_tpu_torch.models.engine import Engine
from shadowkv_tpu_torch.models.params import from_jax_params
from shadowkv_tpu_torch.serving import ContinuousBatcher

LOGIT_TOL = 2e-4
CASES = {
    "sp2tp2": dict(sp=2, tp=2),
    "dp2sp2": dict(dp=2, sp=2),
    "sp2": dict(sp=2),
}
CKPT = {
    "ckpt-sp2tp2": dict(sp=2, tp=2, cache={"mode": "shadow"}),
    "ckpt-sp2": dict(sp=2, cache={"mode": "shadow"}, loads=["ckpt-sp2tp2"]),
}
CKPT_FIELD_TOL = 1e-5  # as test_torch_mesh.py's


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
    cases = [dict(c, kind="generate", cache={"mode": "shadow"})
             for c in CASES.values()]
    w = R.weights(seed=1)
    sketch = R.jax_sketch()
    ids = R.prompts(4, seed=1)
    params = from_jax_params(w, device="cpu")
    ckpt, singles = R.ckpt_cases(CKPT, tmp_path_factory.mktemp("ckpt"),
                                 params, sketch, ids)
    cases += ckpt
    res = R.spawn(4, dict(cases=cases, weights=[w], sketch=sketch,
                          prompts=ids))
    return dict(cases=cases, res=res, w=w, sketch=sketch, ids=ids,
                params=params, singles=singles)


@pytest.mark.parametrize("s_q, t_k, offset", [
    (64, 256, 128), (128, 256, 0), (96, 300, 200), (1, 64, 63)])
def test_offset_attention_matches_jax(s_q, t_k, offset):
    """S_q query rows at key positions [offset, offset + S_q) of T_k keys:
    the plain version against JAX's blockwise causal attention with the
    same offset (the body of its ``sp_causal_prefill_attention``)."""
    rng = np.random.default_rng(s_q + offset)
    q = rng.standard_normal((2, s_q, 8, 32)).astype(np.float32)
    k = rng.standard_normal((2, t_k, 2, 32)).astype(np.float32)
    v = rng.standard_normal((2, t_k, 2, 32)).astype(np.float32)
    want = np.asarray(j_causal(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), block_q=32, offset=offset))
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    got = causal_prefill_attention(tq, tk, tv, block_q=32, offset=offset)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    # the wrapper's CPU path is the plain version
    np.testing.assert_array_equal(
        causal_prefill_offset(tq, tk, tv, offset).numpy(),
        causal_prefill_attention(tq, tk, tv, offset=offset).numpy())


def test_offset_attention_rejects_rows_past_the_keys():
    q = torch.zeros(1, 8, 2, 32)
    k = torch.zeros(1, 16, 1, 32)
    with pytest.raises(ValueError, match="outside"):
        causal_prefill_offset(q, k, k, 9)


@pytest.mark.parametrize("t_k, offset, s_q", [
    (1024, 512, 512), (1000, 300, 400), (4096, 2048, 2048), (640, 0, 640)])
def test_offset_tile_plan_matches_mask(t_k, offset, s_q):
    """Kernel B's offset plan visits exactly the key tiles that hold an
    active pair of each query block, and calls a tile full only when
    every pair is active."""
    plans = prefill_tile_plan(t_k, offset=offset, q_len=s_q)
    assert len(plans) == -(-s_q // TILE)
    n_tiles = -(-t_k // TILE)
    for i, plan in enumerate(plans):
        rows = np.arange(offset + i * TILE, offset + min((i + 1) * TILE, s_q))
        keys = np.arange(n_tiles * TILE)
        active = (keys[None, :] <= rows[:, None]) & (keys[None, :] < t_k)
        for t in range(n_tiles):
            tile = active[:, t * TILE:(t + 1) * TILE]
            if t in plan.full:
                assert tile.all()
            elif t in plan.masked:
                assert tile.any()
            else:
                assert t in plan.skipped and not tile.any()


def _engine(rt: RuntimeConfig, mode: str = "shadow", mesh=None):
    return Engine(R.port_model(), CacheConfig(mode=mode, **R.CACHE), rt,
                  from_jax_params(R.weights()), device="cpu", mesh=mesh)


def test_sp_rejects_unsupported_modes():
    """sp serves mode 'shadow' on the XLA decode path, a dense prefill."""
    with pytest.raises(ValueError, match="shadow"):
        _engine(RuntimeConfig(sp=2, tp=2), mode="shadow_offload")
    with pytest.raises(ValueError, match="XLA decode"):
        _engine(RuntimeConfig(sp=2, tp=2, ring_gather=True))
    with pytest.raises(ValueError, match="XLA decode"):
        _engine(RuntimeConfig(sp=2, use_pallas=True))
    with pytest.raises(ValueError, match="dense"):
        _engine(RuntimeConfig(sp=2, prefill_pattern="stream"))


def test_batcher_refuses_sp():
    eng = _engine(RuntimeConfig(sp=2), mesh=fake_mesh(sp=2))
    with pytest.raises(ValueError, match="sp mesh"):
        ContinuousBatcher(eng, slots=2)


@pytest.mark.parametrize("name", list(CASES))
def test_sp_generation_matches_single(job, name):
    i = list(CASES).index(name)
    case = job["cases"][i]
    ref = R.single(case, job["params"], job["sketch"], job["ids"])
    for r in job["res"]:
        np.testing.assert_array_equal(r[i]["tokens"], ref["tokens"])
        np.testing.assert_allclose(r[i]["logits"], ref["logits"], rtol=0,
                                   atol=LOGIT_TOL)


@pytest.mark.parametrize("name", list(CKPT))
def test_sp_checkpoint_resumes(job, name):
    """As ``test_torch_mesh.py::test_mesh_checkpoint_resumes``; the sp=2
    file equals the single device's field by field (CKPT_FIELD_TOL)."""
    i = len(CASES) + list(CKPT).index(name)
    R.check_ckpt(job["cases"][i], [r[i] for r in job["res"]],
                 job["singles"][name], job["params"], job["sketch"],
                 CKPT_FIELD_TOL)


def test_sp_matches_jax_engine(job):
    """(sp=2, tp=2) gives the JAX engine's tokens on its (1, 2, 2) mesh."""
    w = job["w"]
    jp = R.jax_params(w)
    je = JEngine(j_toy(dtype=jnp.float32, **R.SHAPE),
                 JCache(mode="shadow", **R.CACHE),
                 JRuntime(prefill_block_q=64, sp=2, tp=2), jp)
    want, _ = je.generate(job["ids"], gen_len=R.GEN)
    np.testing.assert_array_equal(job["res"][0][0]["tokens"],
                                  np.asarray(want))
    assert jax.devices()[0].platform == "cpu"
