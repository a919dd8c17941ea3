"""``use_pallas="auto"`` of the PyTorch port against the JAX engine's
(``tests/test_auto_path.py``'s cases) on the float32 toy model of
``test_torch_engine.py``, same weights, prompt and sketch.

'auto' samples the slot hit rate on one consecutive step pair per
``pallas_auto_interval`` steps and moves between the XLA-gather branch and
the fused refresh when its EMA crosses ``pallas_hit_threshold`` by more
than ``pallas_auto_deadband``. Both engines run ``batch_generate`` (whose
warmup alternates the two paths), and each case holds the port to JAX's
greedy tokens, to the path chosen after every observation and the EMA
there (a list of (kernel on, EMA) pairs), and to the ``kv_stats`` auto
fields. The toy's synthetic selection churns, so a high threshold keeps
the XLA-gather branch and a threshold of 0.0 switches to the kernel.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from shadowkv_tpu_torch.config import CacheConfig, RuntimeConfig
from shadowkv_tpu_torch.models.engine import Engine
from test_torch_engine import _engines, models  # noqa: F401

AUTO_FIELDS = ("auto_hit_ema", "auto_kernel_now", "auto_switches")


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """Run this file's torch work on the calling thread: under the suite's
    parallel workers, eight intra-op threads per worker oversubscribe the
    cores and make the toy model's many small ops ~20x slower. The tests
    pass with one thread and with eight; the setting only saves time."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _record(eng, method: str, ema: str) -> list:
    """Wrap ``eng.<method>`` (the per-step observation) to log the path
    and the EMA after each call."""
    log = []
    inner = getattr(eng, method)

    def observe(cache):
        inner(cache)
        log.append((eng._kernel_now, getattr(eng, ema)))

    setattr(eng, method, observe)
    return log


def _run_both(models, threshold, gen_len, kv_quant="none"):
    rt_kw = dict(use_pallas="auto", pallas_hit_threshold=threshold,
                 pallas_auto_interval=4)
    je, te = _engines(models, rt_kw=rt_kw, mode="shadow", kv_quant=kv_quant)
    j_log = _record(je, "_auto_observe", "_auto_hit_ema")
    t_log = _record(te, "_observe_hits", "_hit_ema")
    ids = models[-1]
    jt, _ = je.batch_generate(ids, gen_len=gen_len, temperature=0.0,
                              warmup_steps=2)
    tt, _ = te.batch_generate(ids, gen_len=gen_len, temperature=0.0,
                              warmup_steps=2)
    assert tt.shape == (ids.shape[0], gen_len)
    np.testing.assert_array_equal(tt, np.asarray(jt))
    assert t_log == j_log and len(t_log) == gen_len + 2
    js, ts = je.kv_stats(), te.kv_stats()
    assert {k: ts[k] for k in AUTO_FIELDS} == {k: js[k] for k in AUTO_FIELDS}
    assert ts["hit_rate_ema"] == js["hit_rate_ema"]
    assert ts["hit_samples"] == js["hit_samples"]
    np.testing.assert_array_equal(te._cache.cached_ids.numpy(),
                                  np.asarray(je._cache.cached_ids))
    return te


def test_auto_stays_on_xla_when_selection_churns(models):
    te = _run_both(models, threshold=0.99, gen_len=12)
    assert te._hit_ema is not None  # it did measure
    assert te._kernel_now is False
    assert te.kv_stats()["auto_kernel_now"] is False


def test_auto_switches_to_kernel_at_degenerate_threshold(models):
    te = _run_both(models, threshold=0.0, gen_len=12)
    assert te._kernel_now is True
    assert te._auto_switches >= 1


def test_auto_with_int8_stores(models):
    te = _run_both(models, threshold=0.0, gen_len=10, kv_quant="int8")
    assert te._kernel_now is True  # degenerate threshold -> flipped


@pytest.mark.parametrize("mode, rt_kw", [
    ("shadow_offload", dict(use_pallas="auto")),
    ("shadow", dict(use_pallas="auto", ring_gather=True)),
    ("full", dict(use_pallas="auto")),
])
def test_auto_rejected_outside_hbm_shadow_without_ring(models, mode, rt_kw):
    """JAX asserts 'auto' with an offloaded store, with ring_gather and on
    the full cache (engine.py:243-252, :356); the port raises ValueError."""
    _, _, tcfg, tparams, _ = models
    cc = CacheConfig(mode=mode, max_length=544, kv_quant="int8")
    with pytest.raises(ValueError, match="auto"):
        Engine(tcfg, cc, RuntimeConfig(**rt_kw), tparams, device="cpu")


@pytest.mark.parametrize("chunk_size", [8, 16, 32])
def test_auto_threshold_default(chunk_size):
    """``pallas_hit_threshold=None`` resolves to the H100 crossover of the
    cache's chunk size (16 and above, or 8), never to the JAX package's
    v5e constants; an explicit value wins."""
    from shadowkv_tpu_torch.config import H100_HIT_THRESHOLD

    cc = CacheConfig(mode="shadow", chunk_size=chunk_size)
    want = H100_HIT_THRESHOLD[16 if chunk_size >= 16 else 8]
    assert 0.0 <= want <= 1.0
    assert RuntimeConfig(use_pallas="auto").hit_threshold(cc) == want
    assert RuntimeConfig(use_pallas="auto",
                         pallas_hit_threshold=0.3).hit_threshold(cc) == 0.3
