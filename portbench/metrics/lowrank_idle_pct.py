"""The card's idle time inside the traced prefill's ``lowrank`` phases
(host waits of the low-rank build, such as its ``eigh``), over the traced
window, in % (``portbench/spans.py``)."""

from portbench.spans import prefill_phase


def read(obs):
    p = prefill_phase(obs, "lowrank")
    return None if p is None else 100.0 * p.idle_s / obs["trace"].window_s
