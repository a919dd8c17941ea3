"""Offline per-head sparse-prefill pattern calibration (counterpart of
``shadowkv_tpu/models/calibrate.py``).

Runs one calibration prompt through the model; at every layer each
candidate pattern's sparse attention (the plain versions of
``core/minference.py::minference_prefill``) is scored against dense causal
attention by its per-head relative L2 error, and the dense output feeds the
next layer, so errors do not compound. The lowest error wins, ties (within
1e-6 of the minimum) going to the later, cheaper candidate: averaged over
layers for a uniform table (``RuntimeConfig.minference_patterns``), per
layer with ``per_layer=True`` (``minference_layer_patterns``). Tables
serialize to the reference's JSON: {head: [kind, vertical, slash]}, or a
list of such dicts, one per layer.
"""

from __future__ import annotations

import json
from typing import Optional, Sequence

import numpy as np
import torch

from shadowkv_tpu_torch.config import ModelConfig
from shadowkv_tpu_torch.core import rope as rope_lib
from shadowkv_tpu_torch.core import wquant
from shadowkv_tpu_torch.core.attention import causal_prefill_attention
from shadowkv_tpu_torch.core.layers import ModelParams
from shadowkv_tpu_torch.core.minference import minference_prefill
from shadowkv_tpu_torch.models.forward import _layer_qkv, _layer_tail

DEFAULT_CANDIDATES = (
    ("vertical_and_slash", 1000, 6144),
    ("vertical_and_slash", 100, 800),
    ("stream_llm", 0, 0),  # sizes unused; sink/window from the arguments
)


def calibrate_patterns(
    model: ModelConfig,
    params: ModelParams,
    input_ids,  # [S] calibration prompt
    candidates: Sequence[tuple] = DEFAULT_CANDIDATES,
    block: int = 64,
    stream_sink: int = 64,
    stream_window: int = 256,
    return_errors: bool = False,
    per_layer: bool = False,
):
    """The best pattern per q-head on one prompt: a per-head table, or with
    ``per_layer`` a [num_layers] tuple of them (optionally with the error
    matrix, [n_candidates, H] averaged or [L, n_candidates, H]). Runs on
    the device of ``params``; per-layer candidates must avoid
    block_sparse."""
    dev = params.final_norm.device
    ids = torch.as_tensor(np.asarray(input_ids), dtype=torch.long,
                          device=dev)[None]
    s = ids.shape[1]
    h = model.num_heads
    cos, sin = rope_lib.compute_cos_sin(model, s, dtype=torch.float32,
                                        device=dev)
    x = wquant.take_rows(params.embed, ids, model.dtype)
    layer_errs = np.zeros((model.num_layers, len(candidates), h))
    for layer in range(model.num_layers):
        lp = params.layer(layer)
        q, k_r, _, v = _layer_qkv(model, lp, x, cos[:s], sin[:s])
        dense = causal_prefill_attention(q, k_r, v, block_q=min(512, s))
        ref = torch.linalg.vector_norm(dense.float(), dim=(1, 3))  # [B, H]
        for ci, cand in enumerate(candidates):
            sparse = minference_prefill(
                q, k_r, v, patterns=[cand] * h, block=block,
                stream_sink=stream_sink, stream_window=stream_window,
            )
            diff = torch.linalg.vector_norm((sparse - dense).float(), dim=(1, 3))
            layer_errs[layer, ci] = (diff / ref.clamp_min(1e-6))[0].cpu().numpy()
        x = _layer_tail(lp, model, x, dense)

    def pick(err_ch):  # [n_candidates, H] -> per-head table
        rows = []
        for hh in range(h):
            min_err = err_ch[:, hh].min()
            best = max(ci for ci in range(len(candidates))
                       if err_ch[ci, hh] <= min_err + 1e-6)
            rows.append(tuple(candidates[best]))
        return tuple(rows)

    if per_layer:
        table = tuple(pick(layer_errs[li]) for li in range(model.num_layers))
        return (table, layer_errs) if return_errors else table
    errs = layer_errs.mean(axis=0)
    table = pick(errs)
    return (table, errs) if return_errors else table


def _row_dict(table: Sequence) -> dict:
    # bare kind strings serialize as [kind]
    return {str(i): ([t] if isinstance(t, str) else list(t))
            for i, t in enumerate(table)}


def _row_tuple(raw: dict) -> tuple:
    out = []
    for i in range(len(raw)):
        e = raw[str(i)]
        if len(e) == 1:
            out.append(e[0])  # bare kind string
        else:
            out.append(tuple(e[:1]) + tuple(int(v) for v in e[1:3]))
    return tuple(out)


def _is_head_entry(e) -> bool:
    """A head entry is a bare kind string or (kind, vertical, slash)."""
    if isinstance(e, str):
        return True
    return (isinstance(e, (tuple, list)) and bool(e) and isinstance(e[0], str)
            and all(isinstance(x, (int, np.integer)) for x in e[1:3]))


def save_patterns(table: Sequence, path: str,
                  per_layer: Optional[bool] = None) -> None:
    """JSON {head: [kind, vertical_size, slash_size]} for a uniform table,
    a list of such dicts for a per-layer one. Detected as per-layer unless
    every element is a head entry; a one-head per-layer table of bare
    1-tuples is ambiguous, pass ``per_layer=True`` there."""
    if per_layer is None:
        per_layer = bool(table) and not all(_is_head_entry(e) for e in table)
    with open(path, "w") as f:
        if per_layer:
            json.dump([_row_dict(row) for row in table], f)
        else:
            json.dump(_row_dict(table), f)


def load_patterns(path: str) -> tuple:
    """``save_patterns`` output: a JSON list is a per-layer table, a dict a
    uniform one."""
    with open(path) as f:
        raw = json.load(f)
    if isinstance(raw, list):
        return tuple(_row_tuple(row) for row in raw)
    return _row_tuple(raw)
