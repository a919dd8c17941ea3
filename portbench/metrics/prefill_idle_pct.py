"""The card's idle share over the traced prefill: 1 - the union of the
device kernels' intervals over the traced window, in %."""


def read(obs):
    if "prompt_len" not in obs or not obs["trace"].device:
        return None
    t = obs["trace"]
    return 100.0 * (1.0 - t.busy_s / t.window_s)
