"""The whole hybrid decode step's share of the card's bf16 peak over the
traced steps: model FLOPs (``counts/hybrid_decode_flops.py``, each row's
chosen experts from the routing ids the run kept) of every row and step
over the traced window's wall time x 989 TFLOP/s, in %."""

from portbench.counts.hybrid_decode_flops import hybrid_step_flops
from portbench.peaks import BF16_FLOPS


def read(obs):
    if "routes" not in obs or not obs["trace"].device:
        return None
    flops = sum(hybrid_step_flops(obs["model"], obs["layout"], d,
                                  routes[:, row])
                for d, routes in zip(obs["depths"], obs["routes"])
                for row in range(obs["batch"]))
    return 100.0 * flops / (obs["trace"].window_s * BF16_FLOPS)
