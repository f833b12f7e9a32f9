"""Analysis helpers for notebooks and reports.

The port's copy of ``attention_lvcsr_tpu/utils/notebook.py`` (the
reference's ``lvsr/notebook.py``): load a training log from a checkpoint
of either package, turn it into a DataFrame, plot its channels, play
audio and show alignments.  ``matplotlib`` and ``pandas`` are imported
inside the functions that need them.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from attention_lvcsr_torch.train.checkpoint import load_checkpoint
from attention_lvcsr_torch.train.log import TrainingLog
from attention_lvcsr_torch.utils.plots import save_alignment  # noqa: F401


def load_log(path) -> TrainingLog:
    """The training log of a checkpoint archive."""
    state = load_checkpoint(path)
    if not state.get("log_state"):
        raise ValueError(f"{path} contains no training log")
    return TrainingLog.from_state_dict(state["log_state"])


def log_to_dataframe(path):
    return load_log(path).to_dataframe()


def plot_channels(log: TrainingLog, channels: Sequence[Sequence[str]],
                  save_to: Optional[str] = None):
    """Plot channel groups, one subplot a group, like the reference's
    five-panel layout (lvsr/main.py:628-642), with matplotlib."""
    import matplotlib
    matplotlib.use("Agg")
    from matplotlib import pyplot

    fig, axes = pyplot.subplots(len(channels), 1,
                                figsize=(10, 3 * len(channels)),
                                squeeze=False)
    for ax, group in zip(axes[:, 0], channels):
        for name in group:
            times, values = log.channel(name)
            numeric = [(t, v) for t, v in zip(times, values)
                       if isinstance(v, (int, float, np.floating))]
            if numeric:
                ax.plot(*zip(*numeric), label=name)
        ax.legend(fontsize=7)
        ax.set_xlabel("iterations")
    fig.tight_layout()
    if save_to:
        fig.savefig(save_to, dpi=100)
        pyplot.close(fig)
    return fig


def wav_player(data, rate=16000):
    """Inline HTML audio player for notebooks."""
    import base64
    import io
    import wave as wave_mod
    buf = io.BytesIO()
    pcm = (np.clip(np.asarray(data, np.float64), -1, 1)
           * 32767).astype("<i2")
    with wave_mod.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes(pcm.tobytes())
    payload = base64.b64encode(buf.getvalue()).decode()
    return (f'<audio controls src="data:audio/wav;base64,{payload}">'
            '</audio>')


def show_alignment(weights, labels, bos_symbol=False):
    """Interactive variant of ``save_alignment`` (returns the figure)."""
    from matplotlib import pyplot
    weights = np.asarray(weights)
    fig, ax = pyplot.subplots(figsize=(10, max(3, len(labels) * 0.25)))
    ax.imshow(weights, aspect="auto", interpolation="nearest")
    shown = ([""] + list(labels)) if bos_symbol else list(labels)
    ax.set_yticks(range(len(shown)))
    ax.set_yticklabels(shown, fontsize=6)
    return fig
