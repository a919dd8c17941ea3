"""The projections' and MLP's device time per traced decode step: busy ms
in the program's ``embed``, ``qkv`` (norm, QKV, bias, RoPE), ``tail`` (wo,
residual, MLP) and ``head`` (final norm, lm_head, sampling, the token's
record) phases (``portbench/spans.py``)."""

from portbench.spans import decode_ms_per_step


def read(obs):
    return decode_ms_per_step(obs, ("embed", "qkv", "tail", "head"))
