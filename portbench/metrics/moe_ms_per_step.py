"""The MoE layers' device time per traced decode step: busy ms in the
program's ``route`` (router, sigmoid, top-k, weights) and ``experts``
(held and shared experts) phases, summed over layers
(``portbench/spans.py``)."""

from portbench.spans import decode_ms_per_step


def read(obs):
    return decode_ms_per_step(obs, ("route", "experts"))
