"""The whole prefill's share of the card's bf16 peak: model FLOPs
(``counts/prefill_flops.py``) of the traced prefill over its wall time x
989 TFLOP/s, in %."""

from portbench.counts.prefill_flops import prefill_flops
from portbench.peaks import BF16_FLOPS


def read(obs):
    if "prompt_len" not in obs or not obs["trace"].device:
        return None
    flops = obs["prefills"] * prefill_flops(obs["model"], obs["prompt_len"])
    return 100.0 * flops / (obs["trace"].window_s * BF16_FLOPS)
