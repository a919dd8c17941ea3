"""The MoE layers' share of their roofline over the traced decode steps:
the least time to read, once at 3.35 TB/s, each step's held experts that
some row chose, the shared expert and the router (``counts/moe_bytes.py``,
from the routing ids the run kept), summed, over the device time of the
``route`` and ``experts`` phases, in %. The bytes follow the run's own
choices: in a cell whose batch is smaller than the deployment's load per
expert, fewer held experts are chosen than a deployment would read, so a
change that only skips unchosen experts raises this share without a
gain there; ``moe_ms_per_step`` shows what all held experts cost."""

from portbench.counts.moe_bytes import moe_layer_bytes
from portbench.peaks import HBM_BYTES
from portbench.spans import phases


def read(obs):
    if "routes" not in obs:
        return None
    p = phases(obs["trace"])
    if p is None or "experts" not in p:
        return None
    secs = sum(p[n].busy_s for n in ("route", "experts") if n in p)
    least = sum(moe_layer_bytes(obs["model"], step[m])
                for step in obs["routes"] for m in range(step.shape[0]))
    return 100.0 * least / HBM_BYTES / secs
