"""The state of a hybrid model's other layers, beside the cache of its
full-attention layers (``ShadowCache`` or ``FullCache``, which hold only
those layers): two kinds of cache in one manager.

- Sliding layers keep a ring of the last ``W = sliding_window`` keys
  (post-RoPE) and values per (layer, row, KV head): the key of position
  ``p`` sits at ring row ``p % W``. A query at ``p`` sees the keys ``p - W
  + 1 .. p``, which after its own key's write are the ring's rows, all of
  them once ``p + 1 >= W`` and rows ``0 .. p`` before. The prefill writes
  the prompt's last ``W`` positions; each decode step writes its position
  and attends the ring. A copy of the prefill's ring (``base_*``) is put
  back when a slot's depth is reset (a new question on the same document),
  since the steps of the round before overwrote the prompt's rows.
- MoE layers record the experts each row chose at the last decode step
  (``route_ids``), as ``ShadowCache.cached_ids`` records the selections,
  and, for the rows named before a prefill (``route_rows``), the experts
  every prompt position chose (``prefill_routes``).

Layout: ``ring_k`` / ``ring_v`` / ``base_k`` / ``base_v`` [Ls, B, K, W,
Dh] in the model dtype, ``route_ids`` [Lm, B, k] int16, ``prefill_routes``
[Lm, R, S, k] int16.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class HybridState:
    ring_k: torch.Tensor
    ring_v: torch.Tensor
    base_k: torch.Tensor
    base_v: torch.Tensor
    route_ids: torch.Tensor | None = None
    prefill_routes: torch.Tensor | None = None
    route_rows: tuple = ()

    @classmethod
    def init(cls, model, batch: int, prompt_len: int, device=None,
             route_rows=()) -> "HybridState":
        kh, dh, dt = model.num_kv_heads, model.head_dim, model.dtype
        ls, lm = len(model.sliding_layers), len(model.moe_layers)
        w = model.sliding_window or 1
        ring = (ls, batch, kh, w, dh)
        k = model.num_experts_per_tok

        def z(shape, dtype=dt):
            return torch.zeros(shape, dtype=dtype, device=device)

        return cls(
            ring_k=z(ring), ring_v=z(ring), base_k=z(ring), base_v=z(ring),
            route_ids=z((lm, batch, k), torch.int16) if lm else None,
            prefill_routes=(z((lm, len(route_rows), prompt_len, k),
                              torch.int16) if lm and route_rows else None),
            route_rows=tuple(route_rows))

    @property
    def window(self) -> int:
        return self.ring_k.shape[3]

    def write_prefill(self, layer: int, rows: slice, k: torch.Tensor,
                      v: torch.Tensor) -> None:
        """The last ``W`` positions of a prefill's k/v [b, S, K, Dh] into
        sliding layer ``layer``'s ring (and its base) at batch rows
        ``rows``."""
        s = k.shape[1]
        pos = torch.arange(max(0, s - self.window), s, device=k.device)
        at = pos % self.window
        for ring, base, x in ((self.ring_k, self.base_k, k),
                              (self.ring_v, self.base_v, v)):
            x = x[:, pos].transpose(1, 2)
            ring[layer, rows][:, :, at] = x
            base[layer, rows][:, :, at] = x

    def write_step(self, layer: int, pos: torch.Tensor, k: torch.Tensor,
                   v: torch.Tensor) -> None:
        """One decode step's k/v [B, 1, K, Dh] at positions ``pos`` (a 0-d
        or [B] device tensor) into the ring rows ``pos % W``; no host
        read."""
        at = pos.long() % self.window
        for ring, x in ((self.ring_k, k), (self.ring_v, v)):
            x = x.transpose(1, 2)  # [B, K, 1, Dh]
            if at.dim() == 0:
                ring[layer].index_copy_(2, at.reshape(1), x)
            else:
                b, kh, _, dh = x.shape
                ring[layer].scatter_(
                    2, at[:, None, None, None].expand(b, kh, 1, dh), x)

    def valid(self, pos: torch.Tensor) -> torch.Tensor:
        """The ring rows a query at ``pos`` attends (its own included)."""
        return (pos + 1).clamp(max=self.window)

    def restore(self, slot: int) -> None:
        """Put the prefill's ring of ``slot`` back (in place)."""
        self.ring_k[:, slot].copy_(self.base_k[:, slot])
        self.ring_v[:, slot].copy_(self.base_v[:, slot])

    def record_prefill(self, layer: int, batch_start: int,
                       top: torch.Tensor) -> None:
        """MoE layer ``layer``'s choices top [b, S, k] of the prefill rows
        from ``batch_start``: kept for the rows in ``route_rows``."""
        for r, row in enumerate(self.route_rows):
            if batch_start <= row < batch_start + top.shape[0]:
                self.prefill_routes[layer, r] = top[row - batch_start]

    def record_step(self, layer: int, top: torch.Tensor) -> None:
        """MoE layer ``layer``'s choices top [B, 1, k] at a decode step."""
        self.route_ids[layer].copy_(top[:, -1])
