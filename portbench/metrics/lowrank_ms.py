"""The low-rank build's device time per traced prefill: busy ms in the
program's ``lowrank`` phases (factors and their ``eigh``, landmarks,
outliers, the seed selection and the buffer's rows), summed over layers
(``portbench/spans.py``)."""

from portbench.spans import prefill_phase


def read(obs):
    p = prefill_phase(obs, "lowrank")
    return None if p is None else 1e3 * p.busy_s / obs["prefills"]
