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
tokens; with ``contexts``, shared-prefix requests and the count of
restores across dp shards), "ckpt" (a context checkpoint: save, resume,
load other files; see ``_run_ckpt``) or "lowrank" (the tp factors of one
layer's keys, from every rank), the mesh sizes ``dp/tp/sp/pp``, and
``cache``/``rt`` keyword dicts. The single-device references run in the
test process (``single``). The ranks save with
``checkpoint.VERIFY_SHARED``: the writer checks that the tp ranks' copies
of U agree.
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
CKPT_FIRST, CKPT_GEN = 2, 10  # tokens before the save; in the unbroken run
SUFFIX = 3  # the shared-context requests' suffix tokens


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


def engine(case: dict, params, sketch, mesh=None):
    """The port engine of ``case`` on the CPU: one device with ``mesh=None``
    (the case's mesh sizes ignored), a rank of ``mesh`` otherwise."""
    import dataclasses

    import torch

    from shadowkv_tpu_torch.config import CacheConfig, RuntimeConfig
    from shadowkv_tpu_torch.models.engine import Engine

    cfg = port_model()
    if case.get("num_layers"):
        cfg = dataclasses.replace(cfg, num_layers=case["num_layers"])
    axes = {a: case.get(a, 1) if mesh is not None else 1
            for a in ("dp", "tp", "sp", "pp")}
    cc = CacheConfig(**dict(CACHE, **case.get("cache", {})))
    rt = RuntimeConfig(**case.get("rt", {}), **axes)
    return Engine(cfg, cc, rt, params, device="cpu",
                  sketch=torch.from_numpy(sketch), mesh=mesh)


def resume(case: dict, params, sketch, path: str, first) -> np.ndarray:
    """``path`` loaded into the single-device engine of ``case`` and
    continued from the first tokens ``first`` [B, CKPT_FIRST]: the
    CKPT_GEN tokens of the run."""
    eng = engine(case, params, sketch)
    eng.load_state(path)
    rest, _ = eng.generate(first[:, 1:], gen_len=CKPT_GEN - CKPT_FIRST,
                           cont=True)
    return np.concatenate([first, rest], axis=1)


def check_ckpt(case: dict, res: list, one: dict, params, sketch,
               field_tol: float) -> None:
    """A "ckpt" case against its single-device run ``one``: on every rank
    the unbroken run and the resume from the mesh's own file give the
    single device's tokens, and so does every file of ``loads``; the mesh
    file resumed on one device too; without tp the mesh file equals the
    single device's field by field (``assert_files_match``)."""
    np.testing.assert_array_equal(one["resumed"], one["ref"])
    for r in res:
        np.testing.assert_array_equal(r["ref"], one["ref"])
        np.testing.assert_array_equal(r["resumed"], r["ref"])
        assert len(r["loaded"]) == len(case["loads"])
        for path, toks in r["loaded"].items():
            np.testing.assert_array_equal(toks, one["ref"], err_msg=path)
    got = resume(case, params, sketch, case["save"],
                 one["ref"][:, :CKPT_FIRST])
    np.testing.assert_array_equal(got, one["ref"])
    if case.get("tp", 1) == 1:
        assert_files_match(case["save"], case["single"], field_tol)


def assert_files_match(path: str, ref: str, tol: float) -> None:
    """Two checkpoint files of one cache: every entry of one shape and
    dtype; ids, masks and depths equal, float fields within ``tol`` of
    the largest value of ``ref``'s."""
    import torch

    from shadowkv_tpu_torch.cache.shadow import ShadowCache
    from shadowkv_tpu_torch.utils import checkpoint

    a = checkpoint.load_shadow_state(path, "cpu")
    b = checkpoint.load_shadow_state(ref, "cpu")
    assert a.layout == b.layout
    for name in ShadowCache.FIELDS + ("gen_len",):
        x, y = getattr(a, name), getattr(b, name)
        assert (x is None) == (y is None), name
        if x is None:
            continue
        assert x.shape == y.shape and x.dtype == y.dtype, name
        if x.is_floating_point():
            top = float(y.float().abs().max())
            err = float((x.float() - y.float()).abs().max())
            assert err <= tol * top, (name, err, top)
        else:
            assert torch.equal(x, y), name


def run_case(case: dict, params, sketch, ids, mesh=None) -> dict:
    """One case on this process: the single-device port engine with
    ``mesh=None`` and all sizes 1, a rank of the case's mesh otherwise."""
    import torch

    from shadowkv_tpu_torch.core.lowrank import lowrank_kv_factors
    from shadowkv_tpu_torch.serving import ContinuousBatcher, Request

    if case["kind"] == "llm":
        return _run_llm(case, port_model(), ids, mesh is not None)
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
    eng = engine(case, params, sketch, mesh)
    batch = ids[: case.get("batch", ids.shape[0])]
    if case["kind"] == "ckpt":
        return _run_ckpt(case, eng, batch, mesh is not None)
    if case["kind"] == "serve":
        gens = case["gen_lens"]
        if "contexts" in case:
            reqs = context_requests(batch, case["contexts"], gens)
        else:
            reqs = [Request(uid=i, input_ids=batch[i % len(batch)],
                            gen_len=g) for i, g in enumerate(gens)]
        cross = _count_cross_restores(eng)
        got, stats = ContinuousBatcher(eng, slots=case["slots"]).run(reqs)
        return dict(tokens={k: np.asarray(v) for k, v in got.items()},
                    admissions=stats.admissions, cross=len(cross),
                    hits=stats.context_hits)
    logits, _ = eng.prefill(batch)
    tokens, _ = eng.generate(batch, gen_len=GEN, **case.get("sample", {}))
    return dict(tokens=tokens, logits=logits.numpy())


def context_requests(prompts, contexts, gens, cls=None):
    """Shared-prefix requests: request i's prefix is prompt row
    ``contexts[i]`` (its ``context_id``) and its suffix SUFFIX seeded
    tokens."""
    if cls is None:
        from shadowkv_tpu_torch.serving import Request as cls
    rng = np.random.RandomState(5)
    return [cls(uid=i, input_ids=np.concatenate([
        prompts[c], rng.randint(0, SHAPE["vocab_size"], SUFFIX)]),
        gen_len=g, context_id=c, context_len=PROMPT)
        for i, (c, g) in enumerate(zip(contexts, gens))]


def _count_cross_restores(eng) -> list:
    """A list that gains one entry per snapshot restored into a slot of
    another dp shard than the one it was taken on."""
    cross = []
    real = eng._merge_slots

    def counted(cache, small, b0, with_v=False, src=None):
        if src is not None and eng._slot_at(src)[0] != eng._slot_at(b0)[0]:
            cross.append(b0)
        return real(cache, small, b0, with_v, src)

    eng._merge_slots = counted
    return cross


def _run_ckpt(case: dict, eng, batch, meshed: bool) -> dict:
    """A context checkpoint: the unbroken run (CKPT_GEN greedy tokens); a
    run of CKPT_FIRST tokens saved (``case["save"]`` on a mesh, one file
    per replica, ``case["single"]`` on one device) and resumed from its
    file in the same engine; on a mesh, every file of ``case["loads"]`` (the
    single-device file, files of other meshes) resumed the same way, and
    ``case["bad"]`` (a file of another layout) loaded: every rank must
    raise ValueError."""
    ref, _ = eng.generate(batch, gen_len=CKPT_GEN)
    first, _ = eng.generate(batch, gen_len=CKPT_FIRST)
    path = case["save"] if meshed else case["single"]
    if meshed and eng.mesh.rank >= eng.mesh.size:
        # a mesh smaller than the world runs as several replicas, each
        # writing a file of its own (the first one's is case["save"])
        path = path.replace(".npz", f"-r{eng.mesh.rank // eng.mesh.size}.npz")
    eng.save_state(path)

    def resume(p):
        eng.load_state(p)
        rest, _ = eng.generate(first[:, 1:], gen_len=CKPT_GEN - CKPT_FIRST,
                               cont=True)
        return np.concatenate([first, rest], axis=1)

    out = dict(ref=ref, resumed=resume(path), loaded={})
    if meshed:
        for p in case.get("loads", []):
            out["loaded"][p] = resume(p)
        if case.get("bad"):
            try:
                eng.load_state(case["bad"])
            except ValueError as e:
                out["bad"] = str(e)
    return out


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


def ckpt_cases(specs: dict, tmp, params, sketch, ids) -> tuple:
    """The "ckpt" cases of ``specs`` (name -> mesh case; ``loads``: names
    of earlier cases whose mesh files it loads too; ``bad``: it loads a
    file of another layout), their files under ``tmp``, and the
    single-device runs (name -> ``_run_ckpt``'s result), which write the
    single-device files the ranks load."""
    import torch

    from shadowkv_tpu_torch.config import CacheConfig, RuntimeConfig
    from shadowkv_tpu_torch.models.engine import Engine

    bad = os.path.join(str(tmp), "bad-layout.npz")
    if any(spec.get("bad") for spec in specs.values()):
        eng = Engine(port_model(), CacheConfig(
            **dict(CACHE, mode="shadow", gen_capacity=64)), RuntimeConfig(),
            params, device="cpu", sketch=torch.from_numpy(sketch))
        eng.prefill(ids[:1])
        eng.save_state(bad)
    cases, singles = [], {}
    for name, spec in specs.items():
        case = {k: v for k, v in spec.items() if k not in ("loads", "bad")}
        case.update(kind="ckpt", save=os.path.join(str(tmp), name + ".npz"),
                    single=os.path.join(str(tmp), name + "-single.npz"))
        case["loads"] = [case["single"]] + [
            os.path.join(str(tmp), n + ".npz") for n in spec.get("loads", [])]
        if spec.get("bad"):
            case["bad"] = bad
        singles[name] = single(case, params, sketch, ids)
        cases.append(case)
    return cases, singles


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
    from shadowkv_tpu_torch.utils import checkpoint

    checkpoint.VERIFY_SHARED = True
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
