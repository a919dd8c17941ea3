"""Kernel B's (``csrc/prefill_attention.cu``) share of its roofline over
the traced prefill: each launch's causal operations
(``counts/attn_b_flops.py``) over 989 TFLOP/s, summed, over the kernel's
device time found by name in the trace, in %."""

from portbench.counts.attn_b_flops import causal_attention_flops
from portbench.peaks import BF16_FLOPS

KERNEL = "prefill_attention_kernel"


def read(obs):
    if "prompt_len" not in obs:
        return None
    t = obs["trace"]
    secs, n = t.kernel_seconds(KERNEL), t.kernel_count(KERNEL)
    if not n:
        return None
    least = n * causal_attention_flops(obs["model"], obs["prompt_len"]) \
        / BF16_FLOPS
    return 100.0 * least / secs
