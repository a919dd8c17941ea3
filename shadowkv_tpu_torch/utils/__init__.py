"""utils of the PyTorch/CUDA port (see the package docstring)."""

from shadowkv_tpu_torch.utils.profiling import (  # noqa: F401
    device_memory_stats,
    time_fn,
    trace,
)
