"""Kernel A's (``csrc/refresh.cu``) share of its roofline over the traced
decode steps: for each launch (one layer of one step) the least time of its
exact misses (``counts/refresh_bytes.py``: device bytes over 3.35 TB/s,
host-link bytes over a nominal 64 GB/s PCIe Gen5 x16, operations over 989
TFLOP/s, the largest), summed, over the kernel's device time found by name
in the trace, in %."""

from portbench.counts.refresh_bytes import refresh_bytes
from portbench.peaks import BF16_FLOPS, HBM_BYTES, PCIE_BYTES

KERNEL = "refresh_kernel"


def read(obs):
    if "depths" not in obs:
        return None
    t = obs["trace"]
    secs = t.kernel_seconds(KERNEL)
    if not t.kernel_count(KERNEL):
        return None
    md, cache, ids = obs["model"], obs["cache"], obs["ids"]
    least = 0.0
    for prev, cur in zip(ids[:-1], ids[1:]):
        for layer in range(prev.shape[0]):
            dev, host, ops = refresh_bytes(
                prev[layer], cur[layer], chunk=cache["chunk_size"],
                rank=cache["rank"], head_dim=md["head_dim"],
                quant=cache["kv_quant"] == "int8",
                v_on_host=obs["v_on_host"])
            least += max(dev / HBM_BYTES, host / PCIE_BYTES, ops / BF16_FLOPS)
    return 100.0 * least / secs
