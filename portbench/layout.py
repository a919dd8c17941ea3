"""ShadowKV's cache geometry from a prompt length (the ShadowKV paper's
layout, as its reference code builds it): the context's chunks, rounded
down to a multiple of 8 after the last ``local_chunks`` are kept dense,
and the compact buffer's regions

    [ local rows | outlier chunks | sparse budget | generated rows ].
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Layout:
    prompt_len: int
    chunk: int
    chunks: int  # context chunks: landmark and outlier candidates
    local_rows: int  # rows kept dense at the end of the prompt
    outliers: int  # outlier chunks, kept exact
    sets: int  # chunks selected per step (sparse_budget // chunk)
    gen_capacity: int

    @property
    def static_rows(self) -> int:
        """Rows every decode step attends besides the selected chunks and
        the generated rows: the local rows and the outlier chunks."""
        return self.local_rows + self.outliers * self.chunk


def layout(cache: dict, prompt_len: int) -> Layout:
    cs = cache["chunk_size"]
    chunks = prompt_len // cs - cache["local_chunks"]
    chunks -= chunks % 8
    sets = cache["sparse_budget"] // cs
    if sets + cache["outlier_chunks"] > chunks:
        raise ValueError("prompt too short for the budget and outliers")
    return Layout(prompt_len=prompt_len, chunk=cs, chunks=chunks,
                  local_rows=prompt_len - chunks * cs,
                  outliers=cache["outlier_chunks"], sets=sets,
                  gen_capacity=cache["gen_capacity"])
