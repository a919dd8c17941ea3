"""Faults planted in a hybrid model's timed path (``hybrid_rounds``
cells), for the checks that ``correct`` has to fail, as
``portbench/faults.py`` plants its own:

- ``unscaled_routes``: the routed experts' weights without the routed
  scaling factor (x 2.5 in K-EXAONE);
- ``window_plus_one``: every sliding layer sees one key more than its
  window (129 for a window of 128), at prefill (kernel C) and at decode (a
  ring one row longer).

The CPU tests plant them in a toy cell, and the card tests in the cell at
its own size; a benchmark run never does."""

from __future__ import annotations

import contextlib
import dataclasses

from shadowkv_tpu_torch.cache.hybrid import HybridState
from shadowkv_tpu_torch.core import moe
from shadowkv_tpu_torch.models import forward


def _unscaled(real):
    def route(model, lp, x):
        top, w = real(model, lp, x)
        return top, w / model.routed_scaling_factor
    return route


def _wider_prefill(real):
    def attend(q, k, v, window, sink, *a, **kw):
        return real(q, k, v, window + 1, sink, *a, **kw)
    return attend


def _wider_ring(real):
    def init(cls, model, *a, **kw):
        wider = dataclasses.replace(model,
                                    sliding_window=model.sliding_window + 1)
        return real.__func__(cls, wider, *a, **kw)
    return classmethod(init)


# name -> [(object, attribute, wrapper of the real attribute)]
FAULTS = {
    "unscaled_routes": [(moe, "route", _unscaled)],
    "window_plus_one": [(forward, "sparse_prefill_splash", _wider_prefill),
                        (HybridState, "init", _wider_ring)],
}


@contextlib.contextmanager
def planted(name: str):
    """The fault ``name`` in place for the ``with`` block."""
    parts = FAULTS[name]
    real = [getattr(obj, attr) for obj, attr, _ in parts]
    for (obj, attr, wrap), r in zip(parts, real):
        setattr(obj, attr, wrap(r))
    try:
        yield
    finally:
        for (obj, attr, _), r in zip(parts, real):
            setattr(obj, attr, r)
