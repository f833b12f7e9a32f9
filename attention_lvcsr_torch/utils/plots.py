"""Alignment heat-map plots of the search driver's ``--report``.

Counterpart of ``attention_lvcsr_tpu/utils/plots.py``.  ``matplotlib`` is
imported when a plot is drawn, so a machine without it runs everything
else; a report that draws a plot there fails as the JAX package's does.
"""
from __future__ import annotations

import numpy as np


def save_alignment(weights, labels, path):
    """Save an attention-alignment heat map to ``path``: ``weights`` (T_out,
    L), one row per decoded symbol of ``labels`` (the y axis)."""
    import matplotlib
    matplotlib.use("Agg")
    from matplotlib import pyplot

    weights = np.asarray(weights)
    fig, ax = pyplot.subplots(figsize=(10, max(3, len(labels) * 0.25)))
    ax.imshow(weights, aspect="auto", interpolation="nearest",
              cmap="viridis")
    ax.set_yticks(range(len(labels)))
    ax.set_yticklabels(list(labels), fontsize=6)
    ax.set_xlabel("encoded frames")
    fig.tight_layout()
    fig.savefig(path, dpi=100)
    pyplot.close(fig)
