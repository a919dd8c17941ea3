"""The card's idle time that the engine's own host work leaves over the
traced decode steps: the device's idle gaps that begin while the host is
inside one of the program's ``skv.decode.*`` spans (a step, its begin, its
replay or eager run, a capture), over the traced window, in %
(``portbench/spans.py``)."""

from portbench.spans import DECODE_HOST, host_idle_s, phases


def read(obs):
    if "depths" not in obs:
        return None
    t = obs["trace"]
    if phases(t) is None:
        return None
    return 100.0 * host_idle_s(t, DECODE_HOST) / t.window_s
