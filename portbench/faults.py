"""Faults planted in the program's timed path, for the checks that
``correct`` has to fail: each breaks what the port computes while the rest
of a run goes on as usual. The CPU tests plant them in toy cells and
``portbench.calibrate`` in the cells themselves on the card; a benchmark
run never does.

Decode cells: a step that returns its cache unchanged (``frozen_step``),
the batch's second half left out, its rows given the first row's token
(``half_batch``), a token altered where it is produced, every 5th step
(``altered_token``). Prefill cells: the shadow state left unwritten
(``prefill_unwritten``), the last-token logits altered
(``prefill_altered``). The cells run on one card, so no exchange between
chips exists to leave out."""

from __future__ import annotations

import contextlib

import torch

from shadowkv_tpu_torch.models import forward
from shadowkv_tpu_torch.models.engine import Engine


def _frozen_step(real):
    def step(self, cache, tokens, *a, **kw):
        keep = {f: getattr(cache, f).clone()
                for f in ("k_buf", "v_buf", "cached_ids", "gen_len")}
        out = real(self, cache, tokens, *a, **kw)
        for f, t in keep.items():
            getattr(cache, f).copy_(t)
        return out
    return step


def _half_batch(real):
    def step(self, cache, tokens, *a, **kw):
        nxt, logits = real(self, cache, tokens, *a, **kw)
        nxt[nxt.shape[0] // 2:] = nxt[0]
        return nxt, logits
    return step


def _altered_token(real):
    count = [0]

    def step(self, cache, tokens, *a, **kw):
        nxt, logits = real(self, cache, tokens, *a, **kw)
        count[0] += 1
        if count[0] % 5 == 0:
            nxt.add_(1).remainder_(logits.shape[-1])
        return nxt, logits
    return step


def _unwritten(real):
    def layer(*a, **kw):
        return {k: torch.zeros_like(v) for k, v in real(*a, **kw).items()}
    return layer


def _altered_logits(real):
    def finalize(*a, **kw):
        return real(*a, **kw).roll(1, dims=-1)
    return finalize


# name -> (object, attribute, wrapper of the real attribute)
FAULTS = {
    "frozen_step": (Engine, "decode_step", _frozen_step),
    "half_batch": (Engine, "decode_step", _half_batch),
    "altered_token": (Engine, "decode_step", _altered_token),
    "prefill_unwritten": (forward, "shadow_prefill_layer", _unwritten),
    "prefill_altered": (forward, "_finalize", _altered_logits),
}
DECODE = ("frozen_step", "half_batch", "altered_token")
PREFILL = ("prefill_unwritten", "prefill_altered")


@contextlib.contextmanager
def planted(name: str):
    """The fault ``name`` in place for the ``with`` block."""
    obj, attr, wrap = FAULTS[name]
    real = getattr(obj, attr)
    setattr(obj, attr, wrap(real))
    try:
        yield
    finally:
        setattr(obj, attr, real)
