"""Prefilled-state checkpoints: a ShadowCache on disk (counterpart of
``shadowkv_tpu/utils/checkpoint.py``).

A context that took seconds to prefill (low-rank factors, landmarks, int8
stores) resumes in the time it takes to read one file, in this process or
another: ``Engine.save_state`` / ``load_state``, then
``generate(cont=True)``.

Format: one uncompressed ``.npz`` holding every array field of the port's
``ShadowCache`` (``ShadowCache.FIELDS``; bfloat16 stored as an int16 view,
numpy having no bfloat16), ``gen_len`` (0-d, or [B] per-slot depths), and a
``__meta__`` JSON header: the ``ShadowLayout``, each entry's dtype, the
format version, whether the V store was in host memory and the writing
engine's V placement (``variant``). The port lays
its stores out in its own way (ROADMAP.md "Layouts"), so the format has its
own version and does not read the JAX package's files.

The V store loads wherever the loading engine keeps it: on the device, or
straight into a host tensor (pinned when the engine runs on the card) that
it never leaves, so a file written with V on the card loads into a
``shadow_offload`` engine without passing through device memory, and the
reverse.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Callable, Optional

import numpy as np
import torch

from shadowkv_tpu_torch.cache.shadow import ShadowCache, ShadowLayout

FORMAT_VERSION = 1
_ENTRIES = ShadowCache.FIELDS + ("gen_len",)


def _encode(t: torch.Tensor) -> tuple[np.ndarray, str]:
    """A numpy view (or host copy) of ``t`` and its dtype name."""
    t = t.detach().cpu().contiguous()
    name = str(t.dtype).removeprefix("torch.")
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy(), name


def _decode(a: np.ndarray, name: str) -> torch.Tensor:
    t = torch.from_numpy(a)
    return t.view(torch.bfloat16) if name == "bfloat16" else t


def save_shadow_state(cache: ShadowCache, path: str,
                      variant: str = "hbm") -> None:
    """Write a prefilled (or mid-generation) ShadowCache to ``path``.
    ``variant`` records which V placement wrote it (as JAX's header does:
    'hbm', 'host' for the kernels' pinned store, 'io_callback' for the
    HostVStore path); any variant loads into any other."""
    entries: dict[str, np.ndarray] = {}
    dtypes: dict[str, str] = {}
    for name in _ENTRIES:
        val = getattr(cache, name)
        if val is not None:
            entries[name], dtypes[name] = _encode(val)
    meta = {
        "version": FORMAT_VERSION,
        "layout": dataclasses.asdict(cache.layout),
        "dtypes": dtypes,
        "v_on_host": cache.v_on_host,
        "variant": variant,
    }
    entries["__meta__"] = np.frombuffer(json.dumps(meta).encode(),
                                        dtype=np.uint8)
    with open(path, "wb") as fh:
        np.savez(fh, **entries)


def load_shadow_state(
    path: str, device, v_on_host: bool = False,
    check: Optional[Callable[[ShadowLayout], None]] = None,
) -> ShadowCache:
    """Read a checkpoint into a ShadowCache on ``device``; with
    ``v_on_host`` the V store goes into a host tensor (pinned when
    ``device`` is a CUDA device) instead. ``check`` sees the layout before
    any array is read."""
    device = torch.device(device)
    with np.load(path) as z:
        meta = json.loads(bytes(z["__meta__"]).decode())
        if meta.get("version") != FORMAT_VERSION:
            raise ValueError(f"checkpoint format {meta.get('version')} is "
                             f"not this package's {FORMAT_VERSION}")
        layout = ShadowLayout(**meta["layout"])
        if check is not None:
            check(layout)
        fields = {}
        for name in _ENTRIES:
            if name not in z.files:
                fields[name] = None
                continue
            t = _decode(z[name], meta["dtypes"][name])
            if name == "v_full" and v_on_host:
                host = torch.empty(t.shape, dtype=t.dtype,
                                   pin_memory=device.type == "cuda")
                fields[name] = host.copy_(t)
            else:
                fields[name] = t.to(device)
    return ShadowCache(layout=layout, v_on_host=v_on_host, **fields)
