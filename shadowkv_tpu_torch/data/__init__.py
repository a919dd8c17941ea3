from shadowkv_tpu_torch.data.dataset import Dataset  # noqa: F401
from shadowkv_tpu_torch.data.metrics import (  # noqa: F401
    METRICS_FN,
    gen_len_for,
    metric_for,
)
