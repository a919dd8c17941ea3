"""Decode attention's device time per traced decode step: busy ms in the
program's ``attn`` phases, summed over layers (``portbench/spans.py``)."""

from portbench.spans import decode_ms_per_step


def read(obs):
    return decode_ms_per_step(obs, ("attn",))
