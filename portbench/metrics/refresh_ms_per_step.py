"""The sparse refresh's device time per traced decode step: busy ms in the
program's ``refresh`` phases (the misses' compaction and kernel A, or the
gather-rebuild, then the new rows' append and the selected ids' write),
summed over layers (``portbench/spans.py``)."""

from portbench.spans import decode_ms_per_step


def read(obs):
    return decode_ms_per_step(obs, ("refresh",))
