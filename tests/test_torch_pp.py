"""Pipeline parallelism of the port (``parallel/pipeline.py``) against the
single-device port engine and the JAX package's pp mesh.

Without spawning: the pp composition rules (``ValueError``, JAX
``test_pp_rejects_unsupported_modes`` and ``test_pp_tp_rejects_int8_kv``),
the microbatch rule and the batcher's refusal.

Four gloo ranks (once for the file) run the toy model (f32, 8 heads / 4
KV heads) with pp=2 at batch 4 and at batch 1 (fewer rows than stages),
pp=2 over 4 layers (two per stage), pp2 x dp2, pp2 x tp2 and a pp=2 vs prefill with ``vs_sim="clustered"``
(the global layer as each stage's salt): greedy tokens equal the
single-device port engine's on every rank, prefill logits within 1e-4;
pp=2 gives the JAX engine's tokens on its pp=2 mesh of virtual CPU
devices. Context checkpoints saved on pp2, pp2 x dp2 and pp2 x tp2 resume
on their mesh with the unbroken run's tokens and on one device with the
single device's, the single-device file and the other pp meshes' files
resume on each mesh, and the pp2 and pp2 x dp2 files equal the single
device's field by field.
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
from shadowkv_tpu_torch.config import CacheConfig, RuntimeConfig
from shadowkv_tpu_torch.models.engine import Engine
from shadowkv_tpu_torch.models.params import from_jax_params
from shadowkv_tpu_torch.parallel.pipeline import n_micro
from shadowkv_tpu_torch.serving import ContinuousBatcher

LOGIT_TOL = 1e-4
CASES = {
    "pp2-b4": dict(pp=2),
    "pp2-b1": dict(pp=2, batch=1),
    "pp2-4layers": dict(pp=2, batch=2, num_layers=4, weights=1),
    "pp2dp2": dict(pp=2, dp=2),
    "pp2tp2": dict(pp=2, tp=2),
    "pp2-vs-sim": dict(pp=2, rt=dict(
        prefill_pattern="vs", vs_vertical_size=64, vs_slash_size=64,
        vs_block=64, vs_sim="clustered")),
}
SHADOW = {"mode": "shadow"}
CKPT = {
    "ckpt-pp2": dict(pp=2, cache=SHADOW),
    "ckpt-pp2dp2": dict(pp=2, dp=2, cache=SHADOW, loads=["ckpt-pp2"]),
    "ckpt-pp2tp2": dict(pp=2, tp=2, cache=SHADOW, loads=["ckpt-pp2dp2"]),
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
    w = [R.weights(seed=2), R.weights(seed=3, num_layers=4)]
    sketch = R.jax_sketch()
    ids = R.prompts(4, seed=2)
    params = [from_jax_params(x, device="cpu") for x in w]
    ckpt, singles = R.ckpt_cases(CKPT, tmp_path_factory.mktemp("ckpt"),
                                 params[0], sketch, ids)
    cases += ckpt
    res = R.spawn(4, dict(cases=cases, weights=w, sketch=sketch,
                          prompts=ids))
    return dict(cases=cases, res=res, w=w, sketch=sketch, ids=ids,
                params=params, singles=singles)


def _engine(rt: RuntimeConfig, mesh=None, **cache_kw):
    kw = dict(dict(mode="shadow", **R.CACHE), **cache_kw)
    return Engine(R.port_model(), CacheConfig(**kw), rt,
                  from_jax_params(R.weights()), device="cpu", mesh=mesh)


@pytest.mark.parametrize("rt_kw, cache_kw, match", [
    (dict(pp=2), dict(mode="shadow_offload"), "shadow"),
    (dict(pp=2, tp=2, dp=2), {}, "EITHER dp OR tp"),
    (dict(pp=3), {}, "num_layers"),
    (dict(pp=2, ring_gather=True), {}, "XLA decode"),
    (dict(pp=2, use_pallas=True), {}, "XLA decode"),
    (dict(pp=2, sp=2), {}, "pp x sp"),
])
def test_pp_rejects_unsupported_modes(rt_kw, cache_kw, match):
    with pytest.raises(ValueError, match=match):
        _engine(RuntimeConfig(**rt_kw), **cache_kw)


def test_pp_tp_rejects_int8_kv():
    with pytest.raises(ValueError, match="kv_quant"):
        _engine(RuntimeConfig(pp=2, tp=2), kv_quant="int8")


def test_n_micro_rule():
    """JAX's microbatch rule: pp when it divides the batch, the batch when
    smaller than pp, otherwise refused."""
    assert (n_micro(4, 2), n_micro(1, 2), n_micro(8, 4), n_micro(2, 4)) \
        == (2, 1, 4, 2)
    with pytest.raises(ValueError, match="divisible"):
        n_micro(6, 4)


def test_batcher_refuses_pp():
    eng = _engine(RuntimeConfig(pp=2), mesh=fake_mesh(pp=2))
    with pytest.raises(ValueError, match="pp mesh"):
        ContinuousBatcher(eng, slots=2)


@pytest.mark.parametrize("name", list(CASES))
def test_pp_generation_matches_single(job, name):
    i = list(CASES).index(name)
    case = job["cases"][i]
    ref = R.single(case, job["params"][case.get("weights", 0)],
                   job["sketch"], job["ids"])
    for r in job["res"]:
        np.testing.assert_array_equal(r[i]["tokens"], ref["tokens"])
        np.testing.assert_allclose(r[i]["logits"], ref["logits"], rtol=0,
                                   atol=LOGIT_TOL)


@pytest.mark.parametrize("name", list(CKPT))
def test_pp_checkpoint_resumes(job, name):
    """As ``test_torch_mesh.py::test_mesh_checkpoint_resumes``: resumed on
    the mesh, the unbroken run's tokens; the single-device file and the
    earlier pp meshes' files on the mesh, and the mesh file on one device,
    the single device's; pp2 and pp2 x dp2 files equal the single
    device's field by field (CKPT_FIELD_TOL)."""
    i = len(CASES) + list(CKPT).index(name)
    R.check_ckpt(job["cases"][i], [r[i] for r in job["res"]],
                 job["singles"][name], job["params"][0], job["sketch"],
                 CKPT_FIELD_TOL)


def test_pp_matches_jax_engine(job):
    """pp=2 at batch 4 gives the JAX engine's tokens on its pp=2 mesh."""
    w = job["w"][0]
    jp = R.jax_params(w)
    je = JEngine(j_toy(dtype=jnp.float32, **R.SHAPE),
                 JCache(mode="shadow", **R.CACHE),
                 JRuntime(prefill_block_q=64, pp=2), jp)
    want, _ = je.generate(job["ids"], gen_len=R.GEN)
    np.testing.assert_array_equal(job["res"][0][0]["tokens"],
                                  np.asarray(want))
