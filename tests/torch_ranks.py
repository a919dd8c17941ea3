"""Gloo ranks for the port's parallelism tests (``test_torch_mesh.py``,
``test_torch_sp.py``, ``test_torch_pp.py``).

``spawn`` starts ``world`` processes of this module once per test file;
each joins a gloo group on the CPU (torchrun's variables), pins itself to
one intra-op thread, runs every case of the job on one toy model (numpy
weights from a seed, the JAX package's toy shape: 2 layers, hidden 256, 8
heads / 4 KV heads, head_dim 32, f32) and writes its results; rank 0's are
returned. A worker imports torch and the port only (no JAX); the JAX
helpers (``jax_sketch``, ``jax_params``) run in the test process.

A case is a dict: ``kind`` "generate" (greedy tokens of
``Engine.generate``; the prefill logits too), "serve" (the batcher's
tokens) or "lowrank" (the tp factors of one layer's keys, from every
rank), the mesh sizes ``dp/tp/sp/pp``, and ``cache``/``rt`` keyword
dicts. The single-device references run in the test process
(``single``).
"""

from __future__ import annotations

import os
import pickle
import socket
import subprocess
import sys
import tempfile

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
SHAPE = dict(num_layers=2, hidden_size=256, num_heads=8, num_kv_heads=4,
             head_dim=32, intermediate_size=512, vocab_size=512)
CACHE = dict(max_length=512, sparse_budget=64, rank=32, outlier_chunks=4,
             gen_capacity=32)
PROMPT, GEN = 256, 8
RANK = CACHE["rank"]


def weights(seed: int = 0, scale: float = 0.2, num_layers: int = 2) -> dict:
    """The toy model's numpy weights (the ``from_jax_params`` tree)."""
    rng = np.random.default_rng(seed)
    s = dict(SHAPE, num_layers=num_layers)
    l, d, i, v = (s["num_layers"], s["hidden_size"], s["intermediate_size"],
                  s["vocab_size"])
    qkv = (s["num_heads"] + 2 * s["num_kv_heads"]) * s["head_dim"]

    def w(*shape):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    return dict(
        embed=w(v, d),
        layers=dict(attn_norm=1.0 + 0.1 * w(l, d), wqkv=w(l, d, qkv),
                    bqkv=None, wo=w(l, s["num_heads"] * s["head_dim"], d),
                    mlp_norm=1.0 + 0.1 * w(l, d), w_gate_up=w(l, d, 2 * i),
                    w_down=w(l, i, d)),
        final_norm=1.0 + 0.1 * w(d),
        lm_head=w(d, v),
    )


def jax_sketch() -> np.ndarray:
    """JAX's global low-rank sketch (``PRNGKey(7)``) for the toy shape:
    rank + 32 < K * Dh, so the factors depend on it (ROADMAP §3)."""
    import jax
    import jax.numpy as jnp

    d = SHAPE["num_kv_heads"] * SHAPE["head_dim"]
    return np.array(jax.random.normal(jax.random.PRNGKey(7),
                                      (d, min(d, RANK + 32)), jnp.float32))


def jax_params(w: dict, quant: bool = False):
    """The JAX package's ``ModelParams`` of ``weights``' numpy tree (int8
    ``QTensor`` leaves with ``quant``)."""
    import jax.numpy as jnp

    from shadowkv_tpu.core.layers import LayerParams, ModelParams
    from shadowkv_tpu.core.wquant import quantize_params

    tree = ModelParams(
        embed=jnp.asarray(w["embed"]),
        layers=LayerParams(**{k: None if v is None else jnp.asarray(v)
                              for k, v in w["layers"].items()}),
        final_norm=jnp.asarray(w["final_norm"]),
        lm_head=jnp.asarray(w["lm_head"]),
    )
    return quantize_params(tree) if quant else tree


def prompts(batch: int, seed: int = 0) -> np.ndarray:
    return np.random.RandomState(seed).randint(0, SHAPE["vocab_size"],
                                               (batch, PROMPT))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(world: int, job: dict, timeout: float = 240.0) -> list:
    """Run ``job`` (``cases``, ``weights``, ``sketch``, ``prompts``) on
    ``world`` gloo ranks; returns every rank's results (a list of dicts,
    one per case, per rank)."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "job.pkl")
        with open(path, "wb") as f:
            pickle.dump(job, f)
        env = dict(os.environ, MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(_free_port()), WORLD_SIZE=str(world),
                   OMP_NUM_THREADS="1", PYTHONPATH=ROOT)
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), path],
            env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for r in range(world)]
        errs = []
        try:
            for p in procs:
                _, err = p.communicate(timeout=timeout)
                errs.append(err)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
        if any(p.returncode for p in procs):
            raise RuntimeError("gloo ranks failed:\n" + "\n".join(
                e[-3000:] for e in errs))
        out = []
        for r in range(world):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out


def fake_mesh(tp: int = 1, t: int = 0, pp: int = 1, p: int = 0,
              dp: int = 1, sp: int = 1):
    """A RankMesh with no process groups: the layout arithmetic alone."""
    from shadowkv_tpu_torch.parallel import mesh as mesh_lib

    return mesh_lib.RankMesh(
        dp=dp, tp=tp, sp=sp, pp=pp, coords={"dp": 0, "sp": 0, "tp": t, "pp": p}, groups={},
        group_ranks={}, batch_group=None, batch_ranks=[0], backend="gloo")


def port_model():
    import torch

    from shadowkv_tpu_torch.models.registry import toy_config

    return toy_config(dtype=torch.float32, **SHAPE)


def run_case(case: dict, params, sketch, ids, mesh=None) -> dict:
    """One case on this process: the single-device port engine with
    ``mesh=None`` and all sizes 1, a rank of the case's mesh otherwise."""
    import torch

    from shadowkv_tpu_torch.config import CacheConfig, RuntimeConfig
    from shadowkv_tpu_torch.core.lowrank import lowrank_kv_factors
    from shadowkv_tpu_torch.models.engine import Engine
    from shadowkv_tpu_torch.serving import ContinuousBatcher, Request

    cfg = port_model()
    if case["kind"] == "llm":
        return _run_llm(case, cfg, ids, mesh is not None)
    if case.get("num_layers"):
        import dataclasses

        cfg = dataclasses.replace(cfg, num_layers=case["num_layers"])
    axes = {a: case.get(a, 1) for a in ("dp", "tp", "sp", "pp")}
    omega = torch.from_numpy(sketch)
    if case["kind"] == "lowrank":
        k = torch.from_numpy(case["keys"])  # [B, S, K, Dh]
        tp = None
        if mesh is not None:
            k = k[:, :, mesh.head_slice(k.shape[2])]
            tp = mesh.tp_group
        u, sv = lowrank_kv_factors(k, RANK, k.shape[2], k.shape[3],
                                   dtype=torch.float32, omega=omega, tp=tp)
        return dict(u=u.numpy(), sv=sv.numpy())
    cc = CacheConfig(**dict(CACHE, **case.get("cache", {})))
    rt = RuntimeConfig(**case.get("rt", {}), **axes)
    eng = Engine(cfg, cc, rt, params, device="cpu", sketch=omega, mesh=mesh)
    batch = ids[: case.get("batch", ids.shape[0])]
    if case["kind"] == "serve":
        gens = case["gen_lens"]
        reqs = [Request(uid=i, input_ids=batch[i % len(batch)],
                        gen_len=g) for i, g in enumerate(gens)]
        got, stats = ContinuousBatcher(eng, slots=case["slots"]).run(reqs)
        return dict(tokens={k: np.asarray(v) for k, v in got.items()},
                    admissions=stats.admissions)
    logits, _ = eng.prefill(batch)
    tokens, _ = eng.generate(batch, gen_len=GEN, **case.get("sample", {}))
    return dict(tokens=tokens, logits=logits.numpy())


def _run_llm(case: dict, cfg, ids, meshed: bool) -> dict:
    """``LLM`` on the toy config with its synthetic weights and no
    tokenizer (a rank patches the loaders; the test process patches them
    with ``monkeypatch``): the mesh from the process group when
    ``meshed``."""
    from shadowkv_tpu_torch.models import llm as llm_mod

    if meshed:
        llm_mod.model_config = lambda *a, **k: cfg
        llm_mod.load_tokenizer = lambda *a: None
    axes = {a: case.get(a, 1) for a in ("dp", "tp", "sp", "pp")}
    llm = llm_mod.LLM("toy", batch_size=len(ids), max_length=CACHE[
        "max_length"], attn_mode="shadow", sparse_budget=64, rank=RANK,
        chunk_size=8, gen_capacity=32, device="cpu",
        **(axes if meshed else {}))
    return dict(tokens=llm.generate(ids, gen_len=GEN))


def single(case: dict, params, sketch, ids) -> dict:
    """The single-device port engine's result of ``case``."""
    base = {k: v for k, v in case.items() if k not in ("dp", "tp", "sp",
                                                       "pp")}
    return run_case(base, params, sketch, ids)


def _worker(path: str) -> None:
    import torch

    torch.set_num_threads(1)
    from shadowkv_tpu_torch.eval.evaluator import close_dist, init_dist
    from shadowkv_tpu_torch.models.params import from_jax_params
    from shadowkv_tpu_torch.parallel import mesh as mesh_lib

    with open(path, "rb") as f:
        job = pickle.load(f)
    dist = init_dist("gloo")
    meshes = {}
    results = []
    try:
        for case in job["cases"]:
            key = tuple(case.get(a, 1) for a in ("dp", "tp", "sp", "pp"))
            if key not in meshes:
                dp, tp, sp, pp = key
                meshes[key] = (mesh_lib.build_mesh_pp(pp, tp, dp) if pp > 1
                               else mesh_lib.build_mesh(dp, tp, sp))
            params = from_jax_params(
                job["weights"][case.get("weights", 0)], device="cpu")
            results.append(run_case(case, params, job["sketch"],
                                    job["prompts"], meshes[key]))
    finally:
        close_dist(dist)
    out = os.path.join(os.path.dirname(path), f"rank{dist.rank}.pkl")
    with open(out, "wb") as f:
        pickle.dump(results, f)


if __name__ == "__main__":
    _worker(sys.argv[1])
