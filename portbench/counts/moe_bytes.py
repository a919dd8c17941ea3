"""The least bytes one MoE layer of a decode step reads from device
memory, once each: the held experts that some row of the batch chose
(their fused gate/up and down projections), the shared expert, and the
router with its bias (float32), for a configuration of K-EXAONE's keys."""

import numpy as np

ROUTER_BYTES = 4  # the router and its bias are float32


def moe_layer_bytes(cfg: dict, chosen: np.ndarray, weight_bytes: int = 2
                    ) -> int:
    """chosen [B, k]: every row's chosen expert ids at one MoE layer."""
    d, ie = cfg["hidden_size"], cfg["moe_intermediate_size"]
    e_all = cfg["num_experts_published"]
    held = np.intersect1d(np.unique(chosen), cfg["held_experts"]).size
    expert = 3 * d * ie * weight_bytes
    shared = 3 * d * ie * cfg["num_shared_experts"] * weight_bytes
    router = (d + 1) * e_all * ROUTER_BYTES
    return held * expert + shared + router
