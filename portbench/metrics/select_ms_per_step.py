"""Selection's device time per traced decode step: busy ms in the
program's ``select`` phases (landmark scores, top-k, the forced ids, the
slot-stable assignment), summed over layers (``portbench/spans.py``)."""

from portbench.spans import decode_ms_per_step


def read(obs):
    return decode_ms_per_step(obs, ("select",))
