"""The sliding-window layers' device time per traced decode step: busy ms
in the program's ``swa`` phases (the ring's write and the attention over
the window), summed over layers (``portbench/spans.py``)."""

from portbench.spans import decode_ms_per_step


def read(obs):
    return decode_ms_per_step(obs, ("swa",))
