"""Parameter initialization, npz snapshots, JAX-weight import and Hugging
Face checkpoint loading (counterpart of ``shadowkv_tpu/models/params.py``).

The npz format is the JAX package's: keys ``embed``, ``final_norm``,
``lm_head`` and ``layers.<leaf>``, with bf16 leaves stored as uint16 bit
patterns under a ``.bf16`` suffix (np.savez has no bfloat16).

HF checkpoints are read by this module's own safetensors reader
(``SafetensorsFile``: a little-endian u64 header size, a JSON header, raw
little-endian bytes, mapped and viewed by ``torch.frombuffer``) and written
by its own writer (``write_safetensors``; ``save_hf_checkpoint`` is the
inverse of ``load_hf_params`` for a llama), so neither needs the
``safetensors`` package nor ``ml_dtypes``.
"""

from __future__ import annotations

import json
import mmap
import os
import struct

import numpy as np
import torch

from shadowkv_tpu_torch.config import ModelConfig
from shadowkv_tpu_torch.core.layers import LayerParams, ModelParams
from shadowkv_tpu_torch.core.wquant import QTensor, quantize_weight

_TOP = ("embed", "final_norm", "lm_head")
# The matmul leaves of LayerParams (int8 under weight_quant='int8').
_MATMUL = ("wqkv", "wo", "w_gate_up", "w_down")


def _check_quant(weight_quant: str) -> bool:
    if weight_quant not in ("none", "int8"):
        raise ValueError(f"unknown weight_quant {weight_quant!r}")
    return weight_quant == "int8"


def quantize_stacked(w: torch.Tensor) -> QTensor:
    """``quantize_weight`` of a stacked [L, in, out] leaf, one layer at a
    time, so the f32 temporaries are one layer's (the same numbers as one
    call: each output column's scale reduces over its own layer's input
    dim)."""
    q = torch.empty(w.shape, dtype=torch.int8, device=w.device)
    s = torch.empty(w.shape[0], w.shape[2], dtype=torch.float32,
                    device=w.device)
    for i in range(w.shape[0]):
        q[i], s[i] = quantize_weight(w[i])
    return QTensor(q, s)


def init_synthetic_params(
    cfg: ModelConfig,
    generator: torch.Generator,
    scale: float = 0.02,
    device=None,
    weight_quant: str = "none",
) -> ModelParams:
    """Random N(0, scale) weights with the right shapes, drawn on
    ``device`` (default: the generator's) straight into ``cfg.dtype``, one
    tensor at a time, so an 8B model never holds an f32 copy.

    ``weight_quant='int8'`` quantizes each matmul leaf right after it is
    drawn (JAX ``init_synthetic_params_host``'s rule: one leaf at a time),
    so the device holds the int8 params plus one model-dtype leaf. The
    draws are those of the unquantized call: the int8 params equal
    ``quantize_params`` of the same generator's model-dtype params."""
    device = torch.device(device) if device is not None else generator.device
    q8 = _check_quant(weight_quant)
    l, d = cfg.num_layers, cfg.hidden_size
    qkv_out = (cfg.num_heads + 2 * cfg.num_kv_heads) * cfg.head_dim
    dt = cfg.dtype

    def rnd(*shape):
        t = torch.empty(shape, dtype=dt, device=device)
        return t.normal_(0.0, scale, generator=generator)

    def w(*shape):
        return quantize_stacked(rnd(*shape)) if q8 else rnd(*shape)

    def ones(*shape):
        return torch.ones(shape, dtype=dt, device=device)

    layers = LayerParams(
        attn_norm=ones(l, d),
        wqkv=w(l, d, qkv_out),
        bqkv=torch.zeros(l, qkv_out, dtype=dt, device=device)
        if cfg.qkv_bias else None,
        wo=w(l, cfg.q_size, d),
        mlp_norm=ones(l, d),
        w_gate_up=w(l, d, 2 * cfg.intermediate_size),
        w_down=w(l, cfg.intermediate_size, d),
    )
    embed = rnd(cfg.vocab_size, d)
    lm_head = embed.t() if cfg.tie_word_embeddings else rnd(d, cfg.vocab_size)
    if q8:
        embed, lm_head = (quantize_weight(embed, reduce_axis=-1),
                          quantize_weight(lm_head))
    return ModelParams(embed=embed, layers=layers, final_norm=ones(d),
                       lm_head=lm_head)


def _to_numpy(t: torch.Tensor) -> tuple[str, np.ndarray]:
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return ".bf16", t.view(torch.int16).numpy().view(np.uint16)
    return "", t.numpy()


def _from_numpy(a: np.ndarray, bf16: bool, device) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:  # torch tensors must own writable memory
        a = a.copy()
    if bf16:
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device)


def save_params_npz(params: ModelParams, path: str) -> None:
    """Flat npz snapshot in the JAX package's format."""
    flat = {name: getattr(params, name) for name in _TOP}
    for f in LayerParams._fields:
        v = getattr(params.layers, f)
        if v is not None:
            flat[f"layers.{f}"] = v
    out = {}
    for k, v in flat.items():
        suffix, arr = _to_numpy(v)
        out[k + suffix] = arr
    np.savez(path, **out)


def load_params_npz(path: str, device=None) -> ModelParams:
    """Load a snapshot written by either package's ``save_params_npz``."""
    flat = {}
    with np.load(path) as z:
        for k in z.files:
            if k.endswith(".bf16"):
                flat[k[:-5]] = _from_numpy(z[k], True, device)
            else:
                flat[k] = _from_numpy(z[k], False, device)
    return ModelParams(
        embed=flat["embed"],
        layers=LayerParams(*(flat.get(f"layers.{f}") for f in LayerParams._fields)),
        final_norm=flat["final_norm"],
        lm_head=flat["lm_head"],
    )


def from_jax_params(np_tree, device=None) -> ModelParams:
    """Port parameters from the JAX ``ModelParams`` pytree given as numpy
    arrays (e.g. ``jax.tree.map(np.asarray, params)``; attribute or key
    access, leaf names of ``shadowkv_tpu/core/layers.py``). bf16 arrays
    (ml_dtypes) keep their bits."""

    def get(obj, name):
        return obj[name] if isinstance(obj, dict) else getattr(obj, name)

    def conv(a):
        if a is None:
            return None
        a = np.asarray(a)
        return _from_numpy(a, a.dtype.name == "bfloat16", device)

    layers = get(np_tree, "layers")
    return ModelParams(
        embed=conv(get(np_tree, "embed")),
        layers=LayerParams(*(conv(get(layers, f)) for f in LayerParams._fields)),
        final_norm=conv(get(np_tree, "final_norm")),
        lm_head=conv(get(np_tree, "lm_head")),
    )


# ---------------------------------------------------------------------------
# Hugging Face safetensors checkpoints
# ---------------------------------------------------------------------------

_ST_DTYPES = {"BF16": torch.bfloat16, "F16": torch.float16,
              "F32": torch.float32}
_ST_NAMES = {v: k for k, v in _ST_DTYPES.items()}


def write_safetensors(path: str, tensors: dict) -> int:
    """Write a ``.safetensors`` file of bf16, f16 or f32 tensors on any
    device (a JSON header padded with spaces to 8 bytes, then the raw
    little-endian bytes in the dict's order); returns its size."""
    header, offset, blobs = {}, 0, []
    for name, t in tensors.items():
        t = t.detach().contiguous().cpu()
        st = _ST_NAMES.get(t.dtype)
        if st is None:
            raise ValueError(f"{name}: {t.dtype} is not one of "
                             f"{sorted(map(str, _ST_NAMES))}")
        a = (t.view(torch.int16) if t.element_size() == 2 else t).numpy()
        header[name] = {"dtype": st, "shape": list(t.shape),
                        "data_offsets": [offset, offset + a.nbytes]}
        offset += a.nbytes
        blobs.append(a)
    head = json.dumps(header).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(len(head).to_bytes(8, "little"))
        f.write(head)
        for a in blobs:
            f.write(a.data)
    return 8 + len(head) + offset


def save_hf_checkpoint(params: ModelParams, cfg: ModelConfig,
                       out_dir: str) -> None:
    """Write a llama ``ModelParams`` as an HF checkpoint in ``out_dir``:
    ``model.safetensors`` in f32 under the names ``load_hf_params`` reads
    (the fused ``wqkv`` / ``w_gate_up`` split back into q/k/v and gate/up,
    each [in, out] leaf transposed to HF's [out, in]) and ``config.json``.
    The inverse of ``load_hf_params`` (JAX ``scripts/train_tiny_model.py``
    ``save_hf_checkpoint``) for plain (not int8) weights."""
    if cfg.qkv_bias or cfg.rope_style != "neox":
        raise ValueError("save_hf_checkpoint writes llama checkpoints only")
    qd, kd = cfg.q_size, cfg.kv_size

    def t(x):  # [in, out] -> HF [out, in]
        return x.detach().float().t()

    def v1(x):
        return x.detach().float()

    sd = {"model.embed_tokens.weight": v1(params.embed),
          "model.norm.weight": v1(params.final_norm),
          "lm_head.weight": t(params.lm_head)}
    for i in range(cfg.num_layers):
        lp = params.layer(i)
        p = f"model.layers.{i}."
        ii = lp.w_gate_up.shape[-1] // 2
        sd.update({
            p + "self_attn.q_proj.weight": t(lp.wqkv[:, :qd]),
            p + "self_attn.k_proj.weight": t(lp.wqkv[:, qd:qd + kd]),
            p + "self_attn.v_proj.weight": t(lp.wqkv[:, qd + kd:]),
            p + "self_attn.o_proj.weight": t(lp.wo),
            p + "mlp.gate_proj.weight": t(lp.w_gate_up[:, :ii]),
            p + "mlp.up_proj.weight": t(lp.w_gate_up[:, ii:]),
            p + "mlp.down_proj.weight": t(lp.w_down),
            p + "input_layernorm.weight": v1(lp.attn_norm),
            p + "post_attention_layernorm.weight": v1(lp.mlp_norm),
        })
    os.makedirs(out_dir, exist_ok=True)
    write_safetensors(os.path.join(out_dir, "model.safetensors"), sd)
    with open(os.path.join(out_dir, "config.json"), "w") as f:
        json.dump({
            "architectures": ["LlamaForCausalLM"], "model_type": "llama",
            "hidden_size": cfg.hidden_size,
            "intermediate_size": cfg.intermediate_size,
            "num_hidden_layers": cfg.num_layers,
            "num_attention_heads": cfg.num_heads,
            "num_key_value_heads": cfg.num_kv_heads,
            "head_dim": cfg.head_dim,
            "vocab_size": cfg.vocab_size,
            "max_position_embeddings": cfg.max_position_embeddings,
            "rope_theta": cfg.rope_theta,
            "rope_scaling": cfg.rope_scaling_dict,
            "rms_norm_eps": cfg.rms_norm_eps,
            "tie_word_embeddings": cfg.tie_word_embeddings,
            "attention_bias": False, "mlp_bias": False, "hidden_act": "silu",
            "torch_dtype": "float32",
        }, f, indent=2)


class SafetensorsFile:
    """One ``.safetensors`` file, mapped copy-on-write: ``get`` returns a
    tensor viewing the file's bytes (no read until it is used)."""

    def __init__(self, path: str):
        with open(path, "rb") as f:
            (n,) = struct.unpack("<Q", f.read(8))
            header = json.loads(f.read(n))
            self._map = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
        self._base = 8 + n
        header.pop("__metadata__", None)
        self.entries: dict[str, dict] = header

    def keys(self):
        return self.entries.keys()

    def get(self, name: str) -> torch.Tensor:
        e = self.entries[name]
        dtype = _ST_DTYPES.get(e["dtype"])
        if dtype is None:
            raise ValueError(f"{name}: safetensors dtype {e['dtype']} is not "
                             f"one of {sorted(_ST_DTYPES)}")
        begin, end = e["data_offsets"]
        count = (end - begin) // dtype.itemsize
        if count == 0:
            return torch.empty(e["shape"], dtype=dtype)
        t = torch.frombuffer(self._map, dtype=dtype, count=count,
                             offset=self._base + begin)
        return t.reshape(e["shape"])


def open_shards(model_dir: str):
    """(get, names) over a checkpoint's one ``model.safetensors`` or its
    shards listed in ``model.safetensors.index.json``."""
    index_path = os.path.join(model_dir, "model.safetensors.index.json")
    if os.path.exists(index_path):
        with open(index_path) as f:
            shard_of = json.load(f)["weight_map"]
    else:
        single = SafetensorsFile(os.path.join(model_dir, "model.safetensors"))
        shard_of = dict.fromkeys(single.keys(), "model.safetensors")
    files: dict[str, SafetensorsFile] = {}

    def get(name: str) -> torch.Tensor:
        shard = shard_of[name]
        if shard not in files:
            files[shard] = SafetensorsFile(os.path.join(model_dir, shard))
        return files[shard].get(name)

    return get, shard_of


def load_hf_params(
    model_dir: str, cfg: ModelConfig, weight_quant: str = "none", device=None
) -> ModelParams:
    """Load an HF safetensors checkpoint into stacked params on ``device``.

    Handles the layouts of JAX ``load_hf_params``: separate q/k/v
    projections (biases when ``cfg.qkv_bias``) and gate/up MLP (llama,
    llama-3.1, Yi, Qwen2, GLM-hf); Phi-3's fused ``qkv_proj`` and
    ``gate_up_proj``; tied embeddings (or a missing ``lm_head.weight``).
    HF stores projections as [out, in]; they are transposed to [in, out]
    and fused along out, in f32 on the host as JAX does.

    Each leaf reaches its final dtype (``cfg.dtype``, or an int8
    ``QTensor`` under ``weight_quant='int8'``) on the host and is then
    copied into its preallocated stacked tensor on the device, one layer at
    a time: the device peak is the final params, never a bf16 and an int8
    copy of the model at once."""
    q8 = _check_quant(weight_quant)
    device = torch.device(device if device is not None else "cpu")
    get, shard_of = open_shards(model_dir)
    dt = cfg.dtype

    def t(name):
        return get(name).float()

    def has(name):
        return name in shard_of

    def final(w, mat_leaf=False, reduce_axis=-2):
        return quantize_weight(w, reduce_axis) if q8 and mat_leaf else w.to(dt)

    stacked: dict[str, object] = {}

    def put(field, i, leaf):
        if leaf is None:
            stacked[field] = None
            return
        if field not in stacked:
            def alloc(x):
                return torch.empty((cfg.num_layers,) + tuple(x.shape),
                                   dtype=x.dtype, device=device)
            stacked[field] = (QTensor(alloc(leaf.q), alloc(leaf.s))
                              if isinstance(leaf, QTensor) else alloc(leaf))
        dst = stacked[field]
        if isinstance(leaf, QTensor):
            dst.q[i].copy_(leaf.q)
            dst.s[i].copy_(leaf.s)
        else:
            dst[i].copy_(leaf)

    for i in range(cfg.num_layers):
        p = f"model.layers.{i}."
        if has(p + "self_attn.qkv_proj.weight"):  # phi3-style fused
            wqkv = t(p + "self_attn.qkv_proj.weight").T
            bqkv = (t(p + "self_attn.qkv_proj.bias")
                    if has(p + "self_attn.qkv_proj.bias") else None)
        else:
            wqkv = torch.cat([t(p + f"self_attn.{x}_proj.weight").T
                              for x in "qkv"], dim=-1)
            bqkv = None
            if cfg.qkv_bias and has(p + "self_attn.q_proj.bias"):
                bqkv = torch.cat([t(p + f"self_attn.{x}_proj.bias")
                                  for x in "qkv"], dim=-1)
        if has(p + "mlp.gate_up_proj.weight"):  # phi3/glm fused
            w_gate_up = t(p + "mlp.gate_up_proj.weight").T
        else:
            w_gate_up = torch.cat([t(p + "mlp.gate_proj.weight").T,
                                   t(p + "mlp.up_proj.weight").T], dim=-1)
        put("attn_norm", i, final(t(p + "input_layernorm.weight")))
        put("wqkv", i, final(wqkv, True))
        put("bqkv", i, None if bqkv is None else final(bqkv))
        put("wo", i, final(t(p + "self_attn.o_proj.weight").T, True))
        put("mlp_norm", i, final(t(p + "post_attention_layernorm.weight")))
        put("w_gate_up", i, final(w_gate_up, True))
        put("w_down", i, final(t(p + "mlp.down_proj.weight").T, True))

    embed = t("model.embed_tokens.weight")
    tied = cfg.tie_word_embeddings or not has("lm_head.weight")
    lm_head = embed.T if tied else t("lm_head.weight").T
    def place(w):
        # A copy: an f32 leaf kept on the CPU would otherwise view the file's
        # mapping, which rewriting the checkpoint pulls away.
        return w.to(device) if isinstance(w, QTensor) else w.to(device,
                                                                 copy=True)

    embed_d = place(final(embed, True, reduce_axis=-1))
    if tied and not q8:
        lm_head_d = embed_d.t()  # one table, as init_synthetic_params
    else:
        lm_head_d = place(final(lm_head.contiguous(), True))
    return ModelParams(
        embed=embed_d,
        layers=LayerParams(**stacked),
        final_norm=place(final(t("model.norm.weight"))),
        lm_head=lm_head_d,
    )
