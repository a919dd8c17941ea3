"""NIAH heatmap visualization.

Counterpart of the reference viz (reference data/niah/viz.py): reads the
evaluator's jsonl archive for the 'niah' dataset and renders the
(context length x needle depth) score heatmap.
"""

from __future__ import annotations

import argparse
import json
from collections import defaultdict


def load_grid(archive_path: str):
    cells = defaultdict(list)  # (ctx_len, depth) -> scores
    with open(archive_path) as f:
        for line in f:
            rec = json.loads(line)
            for ctx, depth, score in zip(
                rec["context_length"], rec["depth_percent"], rec["correct"]
            ):
                cells[(int(ctx), float(depth))].append(float(score))
    return {k: sum(v) / len(v) for k, v in cells.items()}


def render(archive_path: str, out_path: str, title: str = "NIAH"):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import numpy as np

    grid = load_grid(archive_path)
    ctxs = sorted({c for c, _ in grid})
    depths = sorted({d for _, d in grid})
    mat = np.full((len(depths), len(ctxs)), np.nan)
    for (c, d), s in grid.items():
        mat[depths.index(d), ctxs.index(c)] = s

    fig, ax = plt.subplots(figsize=(10, 5))
    im = ax.imshow(mat, aspect="auto", cmap="RdYlGn", vmin=0, vmax=1)
    ax.set_xticks(range(len(ctxs)))
    ax.set_xticklabels([f"{c // 1024}K" for c in ctxs], rotation=45)
    ax.set_yticks(range(len(depths)))
    ax.set_yticklabels([f"{d:.0f}%" for d in depths])
    ax.set_xlabel("Context length")
    ax.set_ylabel("Needle depth")
    ax.set_title(f"{title} (mean {np.nanmean(mat):.3f})")
    fig.colorbar(im, ax=ax, label="score")
    fig.tight_layout()
    fig.savefig(out_path, dpi=150)
    print(f"saved {out_path}")


def main():
    p = argparse.ArgumentParser()
    p.add_argument("archive", type=str, help="evaluator niah jsonl")
    p.add_argument("--out", type=str, default="niah_heatmap.png")
    p.add_argument("--title", type=str, default="NIAH")
    args = p.parse_args()
    render(args.archive, args.out, args.title)


if __name__ == "__main__":
    main()
