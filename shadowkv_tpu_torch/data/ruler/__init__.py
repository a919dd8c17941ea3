from shadowkv_tpu_torch.data.ruler.generate import (  # noqa: F401
    TASK_CONFIGS,
    generate_task,
)
