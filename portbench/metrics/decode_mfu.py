"""The whole decode step's share of the card's bf16 peak over the traced
steps: model FLOPs (``counts/decode_flops.py``) of every row and step over
the traced window's wall time x 989 TFLOP/s, in %."""

from portbench.counts.decode_flops import decode_step_flops
from portbench.peaks import BF16_FLOPS


def read(obs):
    if "depths" not in obs or not obs["trace"].device:
        return None
    flops = sum(obs["batch"] * decode_step_flops(obs["model"], obs["layout"], d)
                for d in obs["depths"])
    return 100.0 * flops / (obs["trace"].window_s * BF16_FLOPS)
