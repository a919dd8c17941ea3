"""Full-attention KV cache, the baseline path (counterpart of
``shadowkv_tpu/cache/full.py``).

Dense K/V per layer in the head-major layout [L, B, K, T, Dh] the JAX
package uses. Prefill and decode write into it in place (JAX returns a new
buffer via ``dynamic_update_slice`` on a donated one); ``length`` is an
int32 scalar tensor on the cache's device, advanced in place once per
forward step, so a CUDA graph of the decode step reads the live value.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from shadowkv_tpu_torch.cache.hybrid import HybridState
from shadowkv_tpu_torch.config import CacheConfig, ModelConfig


@dataclasses.dataclass
class FullCache:
    k: torch.Tensor  # [L, B, K, T, Dh]
    v: torch.Tensor  # [L, B, K, T, Dh]
    length: torch.Tensor | int = 0  # valid tokens (int32, 0-d)
    # A hybrid model's sliding-layer rings and expert choices
    # (cache/hybrid.py); k and v then hold its full-attention layers only.
    hybrid: Optional[HybridState] = None

    def __post_init__(self):
        if not isinstance(self.length, torch.Tensor):
            self.length = torch.tensor(self.length, dtype=torch.int32,
                                       device=self.k.device)

    @classmethod
    def init(
        cls, model: ModelConfig, cache: CacheConfig, batch_size: int,
        device=None,
    ) -> "FullCache":
        shape = (
            len(model.global_layers),
            batch_size,
            model.num_kv_heads,
            cache.max_length,
            model.head_dim,
        )
        return cls(
            k=torch.zeros(shape, dtype=model.dtype, device=device),
            v=torch.zeros(shape, dtype=model.dtype, device=device),
        )
