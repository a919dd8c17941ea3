"""Model FLOPs of one sparse decode step of one row: 2 x the matmul
parameters (every layer and the output head) plus the attention's 4 x
heads x head_dim per attended position and layer, where a step at gen depth
``d`` attends the local rows, the outlier chunks, the selected budget and
the ``d + 1`` generated rows of its round."""

from portbench.counts.matmul_params import (head_matmul_params,
                                            layer_matmul_params)


def decode_step_flops(model: dict, lay, depth: int) -> int:
    attended = lay.static_rows + lay.sets * lay.chunk + depth + 1
    mm = model["num_layers"] * layer_matmul_params(model) \
        + head_matmul_params(model)
    attn = 4 * model["num_heads"] * model["head_dim"] * attended \
        * model["num_layers"]
    return 2 * mm + attn
