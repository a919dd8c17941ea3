"""The host V store of the XLA-gather branch (``mode="shadow_offload"`` with
neither decode kernel; JAX's ``HostVStore`` path) in the PyTorch port,
against the JAX package's io_callback path on the CPU. The port keeps no
wrapper: the store is the cache's ``v_full`` and decode reads it through
``kernels/gather.py::gather_v_rows``.

- ``gather_v_rows`` against JAX's ``HostVStore._host_fetch`` (the native
  row gather, hit slots skipped) on the same store, chunk ids and stay
  mask: bit-equal on the rows that missed; the stay rows are unspecified
  in both (the plain version zeroes them).
- The engine on the float32 toy model of ``tests/torch_toy.py`` (same
  weights, prompt and low-rank sketch) against JAX's io_callback engine:
  greedy tokens and cached chunk ids equal, compact buffers within 0.1 %
  of their largest entry (as ``test_torch_engine.py`` holds unquantized
  stores); the same tokens and ids as the port's HBM engine, whose V bytes
  are the same, in another place.
- A decode on a copy of the cache reads the copy's store, not the live
  one's.
- Admission: the JAX batcher over its io_callback engine and the port's
  batcher over the host-store engine serve one stream (admissions write a
  slot of the store in place): the same tokens per request and the same
  counters.
- Checkpoints across placements: the host-store engine's file loads into
  the HBM engine and an HBM engine's into it, and both continue
  (``generate(cont=True)``) to the tokens JAX's io_callback engine gives
  without a file.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from shadowkv_tpu.cache.offload import HostVStore as JStore
from shadowkv_tpu.serving import ContinuousBatcher as JBatcher
from shadowkv_tpu.serving import Request as JRequest
from shadowkv_tpu_torch.core.sampling import sample_token
from shadowkv_tpu_torch.kernels.gather import gather_v_rows
from shadowkv_tpu_torch.serving import ContinuousBatcher, Request
from test_torch_serving import _one_intra_op_thread  # noqa: F401
from torch_toy import GEN, PROMPT, engines, models, port_engine  # noqa: F401

HOST = dict(use_pallas=None)  # neither decode kernel


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_fetch_matches_jax_host_fetch(dtype):
    """[L 3, B 2, K 2, C 40, cs 16, Dh 64] store, 12 selected chunks per
    head, about half of the slots staying."""
    import ml_dtypes

    rng = np.random.default_rng(0)
    l, b, k, c, cs, dh, s = 3, 2, 2, 40, 16, 64, 12
    np_dt = ml_dtypes.bfloat16 if dtype == "bfloat16" else dtype
    v6 = rng.standard_normal((l, b, k, c, cs, dh)).astype(np_dt)
    ids = np.stack([rng.permutation(c)[:s] for _ in range(b * k)]).reshape(
        b, k, s).astype(np.int32)
    stay = rng.random((b, k, s)) < 0.5
    j_out = JStore(v6)._host_fetch(1, ids, stay)

    rows = torch.from_numpy(v6.view(np.int16) if dtype == "bfloat16" else v6)
    if dtype == "bfloat16":
        rows = rows.view(torch.bfloat16)
    store = rows.reshape(l, b, k, c * cs, dh).clone()
    t_out = gather_v_rows(1, torch.from_numpy(ids), torch.from_numpy(stay),
                          store, chunk_size=cs)
    assert t_out.shape == (b, k, s, cs, dh) and t_out.dtype == rows.dtype
    got = t_out.float().numpy()[~stay]
    np.testing.assert_array_equal(got, np.asarray(j_out, np.float32)[~stay])
    assert not got.size == 0 and (t_out.float().numpy()[stay] == 0).all()


def test_decode_on_a_copy_reads_its_own_store(models):
    """A decode step on a copy of the cache (its own V store) gives the
    same logits whatever is written into the live cache's store, and the
    logits of the live cache before that write."""
    import dataclasses

    eng = port_engine(models, "shadow_offload", kv_quant="none", **HOST)
    logits, cache = eng.prefill(models[-1])
    tok = sample_token(logits[:, -1])[:, None]
    copy = dataclasses.replace(
        cache, k_buf=cache.k_buf.clone(), v_buf=cache.v_buf.clone(),
        v_full=cache.v_full.clone(), cached_ids=cache.cached_ids.clone(),
        gen_len=cache.gen_len.clone())
    spare = dataclasses.replace(
        copy, k_buf=copy.k_buf.clone(), v_buf=copy.v_buf.clone(),
        cached_ids=copy.cached_ids.clone(), gen_len=copy.gen_len.clone())
    ref = eng._decode(spare, tok)
    cache.v_full.fill_(1e3)
    got = eng._decode(copy, tok)
    assert torch.equal(got, ref)
    live = eng._decode(cache, tok)
    assert not torch.equal(live, ref)


def test_host_store_engine_matches_jax_io_callback(models):
    je, te = engines(models, "shadow_offload", kv_quant="none", **HOST)
    ids = models[-1]
    jt, _ = je.generate(ids, gen_len=GEN)
    tt, _ = te.generate(ids, gen_len=GEN)
    np.testing.assert_array_equal(tt, jt)
    assert je.v_store is not None and te.host_store and te._cache.v_on_host
    jc, tc = je._cache, te._cache
    np.testing.assert_array_equal(tc.cached_ids.numpy(),
                                  np.asarray(jc.cached_ids))
    for a, b in ((tc.k_buf, jc.k_buf), (tc.v_buf, jc.v_buf)):
        a, b = a.double().numpy(), np.asarray(b, np.float64)
        assert np.abs(a - b).max() <= 1e-3 * np.abs(b).max()
    # the V store holds JAX's host rows (within 0.1 %, as the buffers)
    a = te._cache.v_full.double().numpy().reshape(-1)
    b = np.asarray(je.v_store.rows, np.float64).reshape(-1)
    assert np.abs(a - b).max() <= 1e-3 * np.abs(b).max()
    # the HBM engine: the same V bytes in another place
    hbm = port_engine(models, "shadow", kv_quant="none", **HOST)
    ht, _ = hbm.generate(ids, gen_len=GEN)
    np.testing.assert_array_equal(tt, ht)
    assert torch.equal(hbm._cache.cached_ids, tc.cached_ids)
    assert torch.equal(hbm._cache.v_full, tc.v_full)
    # kv_stats: the store is host bytes, as JAX counts v_store.rows
    ts, js, hs = te.kv_stats(), je.kv_stats(), hbm.kv_stats()
    rows = te._cache.v_full
    assert ts["host_bytes"] == rows.numel() * rows.element_size() \
        == js["host_bytes"]
    assert "v_full" not in ts["bytes_by_field"]
    assert ts["device_bytes"] == hs["device_bytes"] - ts["host_bytes"]


GEN_LENS = [6, 9, 4, 7, 5]
COUNTERS = ("admissions", "chunks", "decode_steps", "completed_requests",
            "completed_tokens")


def test_host_store_batcher_matches_jax(models, monkeypatch):
    """The JAX batcher over its io_callback engine and the port's over the
    host-store engine (chunk 3, 2 slots, 5 requests: 3 admissions)."""
    je, te = engines(models, "shadow_offload", kv_quant="none", **HOST)
    prompts = np.random.RandomState(7).randint(
        1, models[2].vocab_size, (len(GEN_LENS), PROMPT))
    j_res, j_stats = JBatcher(je, slots=2, steps_per_dispatch=3).run(
        [JRequest(uid=i, input_ids=prompts[i], gen_len=g)
         for i, g in enumerate(GEN_LENS)])
    stores = []
    admit_slot = type(te).admit_slot

    def spy(self, cache, ids_row, slot):
        stores.append(cache.v_full)
        out = admit_slot(self, cache, ids_row, slot)
        assert cache.v_full is stores[-1]
        return out

    monkeypatch.setattr(type(te), "admit_slot", spy)
    t_res, t_stats = ContinuousBatcher(te, slots=2, steps_per_dispatch=3).run(
        [Request(uid=i, input_ids=prompts[i], gen_len=g)
         for i, g in enumerate(GEN_LENS)])
    assert sorted(t_res) == sorted(j_res)
    for uid in j_res:
        np.testing.assert_array_equal(t_res[uid], j_res[uid],
                                      err_msg=f"uid {uid}")
    for name in COUNTERS:
        assert getattr(t_stats, name) == getattr(j_stats, name), name
    # every admission wrote its slot into the live store in place
    assert t_stats.admissions == 3 == len(stores)
    assert all(v is te._cache.v_full for v in stores)


@pytest.mark.parametrize("src, dst", [("host", "hbm"), ("hbm", "host")])
def test_checkpoint_across_placements_matches_jax(models, tmp_path, src,
                                                  dst):
    """Turn one on the ``src`` engine (prefill + 3 tokens), saved; the file
    loaded into the ``dst`` engine, which continues a 5-token turn two
    (``cont_chunk=4``): the tokens JAX's io_callback engine gives without
    a file."""
    modes = {"host": "shadow_offload", "hbm": "shadow"}
    je, _ = engines(models, "shadow_offload", kv_quant="none", **HOST)
    ids = models[-1]
    turn2 = np.random.RandomState(3).randint(
        1, models[2].vocab_size, (ids.shape[0], 5))
    j_first, _ = je.generate(ids, gen_len=3)
    j_second, _ = je.generate(turn2, gen_len=4, cont=True, cont_chunk=4)

    a = port_engine(models, modes[src], kv_quant="none", **HOST)
    t_first, _ = a.generate(ids, gen_len=3)
    path = str(tmp_path / "ctx.npz")
    a.save_state(path)
    with np.load(path) as z:
        import json
        meta = json.loads(bytes(z["__meta__"]).decode())
    assert meta["variant"] == ("io_callback" if src == "host" else "hbm")
    b = port_engine(models, modes[dst], kv_quant="none", **HOST)
    b.load_state(path)
    assert b.host_store == b._cache.v_on_host == (dst == "host")
    t_second, _ = b.generate(turn2, gen_len=4, cont=True, cont_chunk=4)
    np.testing.assert_array_equal(t_first, j_first)
    np.testing.assert_array_equal(t_second, j_second)
    np.testing.assert_array_equal(b._cache.cached_ids.numpy(),
                                  np.asarray(je._cache.cached_ids))


def test_host_slot_rows_roundtrip(models):
    """``host_slot_rows`` copies a slot of the host store; written back
    into the other slot through ``set_host_slot_rows`` it equals the
    first."""
    eng = port_engine(models, "shadow_offload", kv_quant="none", **HOST)
    eng.prefill(models[-1])
    rows = eng.host_slot_rows(0)
    store = eng._cache.v_full
    assert rows.shape[1] == 1 and not torch.equal(store[:, 0], store[:, 1])
    eng.set_host_slot_rows(rows, 1)
    assert torch.equal(store[:, 0], store[:, 1])
