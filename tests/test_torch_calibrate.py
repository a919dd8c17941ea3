"""The port's offline pattern calibration (``models/calibrate.py``) against
the JAX package's on the same toy model (float32, 2 layers, 4 heads) and
prompt: the same per-head winners, uniform and per layer, with the
relative L2 errors within atol 1e-4 (f32 attention in another order; the
sparse candidates' selections come from each package's own estimate), and
the same JSON, read back by both packages; the per-layer table then drives
the port's engine."""

from __future__ import annotations

import json

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from shadowkv_tpu.models import calibrate as jcal
from shadowkv_tpu.models.params import init_synthetic_params as j_init
from shadowkv_tpu.models.registry import toy_config as j_toy
from shadowkv_tpu_torch.config import CacheConfig, RuntimeConfig
from shadowkv_tpu_torch.models import calibrate as tcal
from shadowkv_tpu_torch.models.engine import Engine
from shadowkv_tpu_torch.models.params import from_jax_params
from shadowkv_tpu_torch.models.registry import toy_config as t_toy

KW = dict(block=64, stream_sink=64, stream_window=256)
CANDIDATES = (("vertical_and_slash", 64, 128), ("vertical_and_slash", 30, 50),
              ("stream_llm", 0, 0))


@pytest.fixture(scope="module")
def setup():
    jcfg = j_toy(dtype=jnp.float32)
    jparams = j_init(jcfg, jax.random.PRNGKey(0), scale=0.2)
    tparams = from_jax_params(jax.tree.map(np.asarray, jparams), device="cpu")
    ids = np.random.RandomState(5).randint(0, jcfg.vocab_size, (384,))
    return jcfg, jparams, t_toy(dtype=torch.float32), tparams, ids


@pytest.mark.parametrize("per_layer", [False, True])
def test_calibration_matches_jax(setup, per_layer, tmp_path):
    jcfg, jparams, tcfg, tparams, ids = setup
    jt, je = jcal.calibrate_patterns(jcfg, jparams, ids, CANDIDATES,
                                     return_errors=True, per_layer=per_layer,
                                     **KW)
    tt, te = tcal.calibrate_patterns(tcfg, tparams, ids, CANDIDATES,
                                     return_errors=True, per_layer=per_layer,
                                     **KW)
    np.testing.assert_allclose(te, np.asarray(je), atol=1e-4)
    assert tt == jt
    jp, tp = tmp_path / "jax.json", tmp_path / "port.json"
    jcal.save_patterns(jt, str(jp))
    tcal.save_patterns(tt, str(tp))
    assert json.loads(tp.read_text()) == json.loads(jp.read_text())
    assert tcal.load_patterns(str(jp)) == jcal.load_patterns(str(tp)) == tt


def test_mixed_table_round_trip_and_engine(setup, tmp_path):
    """Per-layer rows mixing bare kind strings with tuples stay per-layer
    through JSON, and a per-layer table drives the port's engine."""
    _, _, tcfg, tparams, ids = setup
    mixed = (("dense", ("vertical_and_slash", 64, 64)),
             ("stream_llm", "dense"))
    p = tmp_path / "mixed.json"
    tcal.save_patterns(mixed, str(p))
    assert tcal.load_patterns(str(p)) == jcal.load_patterns(str(p)) == mixed
    table = tuple(("vertical_and_slash", 64, 128) if h % 2 else "stream_llm"
                  for h in range(tcfg.num_heads))
    eng = Engine(
        tcfg,
        CacheConfig(mode="shadow", max_length=512, sparse_budget=64, rank=32,
                    outlier_chunks=4),
        RuntimeConfig(prefill_pattern="vs", vs_block=64, vs_tile=128,
                      stream_sink=64, stream_window=256,
                      minference_layer_patterns=(table, table)),
        tparams, device="cpu")
    out, _ = eng.generate(ids[None], gen_len=4)
    assert out.shape == (1, 4)
