"""History plotting: the port's copy of ``dopt.utils.plotting``.

The reference's comparison plots — ``Server.plot`` per-client grids
(servers.py:95-120) and ``servers_plot`` cross-experiment curves (P1
utils.py:29-51, P2 utils.py:26-48) — drawn from the port's ``History``
objects.  Matplotlib only, imported inside each function, so
metric-only use never loads it.
"""

from __future__ import annotations

from pathlib import Path
from typing import Mapping, Sequence

from dopt_torch.utils.metrics import History


def compare_histories(
    histories: Mapping[str, History] | Sequence[tuple[str, History]],
    *,
    metrics: Sequence[str] = ("avg_test_acc", "avg_test_loss", "avg_train_loss"),
    title: str = "",
    save: str | Path | None = None,
):
    """Cross-experiment comparison grid (the ``servers_plot`` shape:
    one panel per metric, one labelled curve per experiment)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    items = list(histories.items()) if isinstance(histories, Mapping) else list(histories)
    n = len(metrics)
    fig, axes = plt.subplots(1, n, figsize=(5 * n, 4))
    if n == 1:
        axes = [axes]
    for ax, metric in zip(axes, metrics):
        for label, h in items:
            xs = [r["round"] for r in h if metric in r]
            ys = [r[metric] for r in h if metric in r]
            if xs:
                ax.plot(xs, ys, marker="o", markersize=3, label=label)
        ax.set_xlabel("round")
        ax.set_ylabel(metric)
        ax.grid(alpha=0.3)
        ax.legend(fontsize=8)
    if title:
        fig.suptitle(title)
    fig.tight_layout()
    if save is not None:
        fig.savefig(save, dpi=120)
        plt.close(fig)
        return Path(save)
    return fig


def client_grid_plot(
    client_history: History,
    *,
    num_workers: int | None = None,
    title: str = "",
    save: str | Path | None = None,
):
    """Per-client loss/accuracy subplot grid — ``Server.plot``
    (servers.py:95-120): for each client a loss panel (train + val
    curves) stacked above an accuracy panel, laid out ceil(sqrt(N))
    wide.  Input is a trainer's ``client_history`` (per-epoch rows with
    a 'worker' column, produced when ``DataConfig.local_holdout`` is
    on); the x-axis is the flattened (round, epoch) sequence, matching
    the reference's concatenated per-epoch client history.  Unlike the
    reference's plot (which hard-codes a 100-client grid offset,
    servers.py:105), the layout adapts to any N."""
    import math

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    rows = client_history.rows
    if not rows:
        raise ValueError(
            "client_history is empty — per-client curves need "
            "DataConfig.local_holdout > 0 (the reference's 90/10 "
            "train/val split)")
    workers = sorted({r["worker"] for r in rows})
    n = num_workers or (max(workers) + 1)
    s = math.ceil(math.sqrt(n))
    rows_of_panels = 2 * math.ceil(n / s)
    fig, axs = plt.subplots(rows_of_panels, s,
                            figsize=(3 * s, 2.2 * rows_of_panels),
                            sharex=True, squeeze=False)
    per_worker: dict[int, list[dict]] = {w: [] for w in range(n)}
    for r in rows:
        per_worker.setdefault(r["worker"], []).append(r)
    for w in range(n):
        block, col = divmod(w, s)
        ax_loss = axs[2 * block][col]
        ax_acc = axs[2 * block + 1][col]
        hist = per_worker.get(w, [])
        xs = range(len(hist))
        ax_loss.set_title(f"Client #{w + 1}", fontsize=8)
        if hist:
            ax_loss.plot(xs, [r["train_loss"] for r in hist], "b",
                         label="train")
            ax_loss.plot(xs, [r["val_loss"] for r in hist], "r", label="val")
            ax_acc.plot(xs, [r["train_acc"] for r in hist], "k",
                        label="train")
            ax_acc.plot(xs, [r["val_acc"] for r in hist], "g", label="val")
            if w == 0:
                ax_loss.legend(fontsize=6)
                ax_acc.legend(fontsize=6)
        ax_loss.set_ylabel("loss", fontsize=7)
        ax_acc.set_ylabel("accuracy", fontsize=7)
        ax_acc.set_xlabel("epochs", fontsize=7)
        ax_loss.label_outer()
        ax_acc.label_outer()
    if title:
        fig.suptitle(title)
    fig.tight_layout()
    if save is not None:
        fig.savefig(save, dpi=120)
        plt.close(fig)
        return Path(save)
    return fig
