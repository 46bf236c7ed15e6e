"""Training-loop utilities: early stopping, CSV logging, metric curves.
A copy of yolosharp_tpu/utils/training.py without occupancy_hint (a hint
calibrated on a TPU).

Parity targets: Utils/EarlyStopping.cs:3-39, the log.csv writer
(YoloBaseTaskModel.cs:215-243), config.txt dump (245-257), and results.png
curves (259-288, matplotlib instead of ScottPlot).
"""

from __future__ import annotations

import csv
import os
from datetime import datetime
from typing import Sequence


class EarlyStopping:
    """Patience counter on fitness = -sum(val_loss) (EarlyStopping.cs)."""

    def __init__(self, patience: int = 50):
        self.best_fitness = 0.0
        self.best_epoch = 0
        self.patience = patience if patience > 0 else float("inf")
        self.possible_stop = False

    def should_stop(self, fitness: float, epoch: int) -> bool:
        if fitness > self.best_fitness or self.best_fitness == 0:
            self.best_epoch = epoch
            self.best_fitness = fitness
        delta = epoch - self.best_epoch
        self.possible_stop = delta >= (self.patience - 1)
        stop = delta >= self.patience
        if stop:
            print(f"Training stopped early: no improvement in the last "
                  f"{self.patience} epochs (best at epoch {self.best_epoch}).")
        return stop


class TrainLogger:
    """log.csv + config.txt + results.png, matching the reference layout."""

    def __init__(self, output_path: str, headers: str):
        self.output_path = output_path
        self.headers = [h.strip() for h in headers.split(",")]
        os.makedirs(output_path, exist_ok=True)
        self.csv_path = os.path.join(output_path, "log.csv")

    def write_config(self, config) -> None:
        with open(os.path.join(self.output_path, "config.txt"), "w") as f:
            f.write("Training Settings:\n")
            f.write(f"Date Time: {datetime.now()}\n")
            f.write(config.describe() + "\n")

    def log_epoch(self, epoch: int, seconds: float,
                  train_loss: Sequence[float], val_loss: Sequence[float],
                  metrics: Sequence[float], n_train: int, n_val: int) -> None:
        new = not os.path.exists(self.csv_path)
        with open(self.csv_path, "a", newline="") as f:
            w = csv.writer(f)
            if new:
                w.writerow(self.headers)
            row = [epoch, f"{seconds:.1f}"]
            row += [f"{v / max(n_train, 1):.5f}" for v in train_loss]
            row += [f"{v / max(n_val, 1):.5f}" for v in val_loss]
            row += [f"{v:.5f}" for v in metrics]
            row += [f"{sum(train_loss) / max(n_train, 1):.5f}",
                    f"{sum(val_loss) / max(n_val, 1):.5f}"]
            w.writerow(row)

    def draw_curves(self) -> None:
        if not os.path.exists(self.csv_path):
            return
        try:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except ImportError:
            return
        with open(self.csv_path) as f:
            rows = list(csv.reader(f))
        if len(rows) < 2:
            return
        headers, data = rows[0], rows[1:]
        cols = {h: [float(r[i]) for r in data if i < len(r)]
                for i, h in enumerate(headers)}
        epochs = cols.get(headers[0], [])
        plot_names = headers[2:-2][:10]
        n = max(len(plot_names), 1)
        ncols = (n + 1) // 2
        fig, axes = plt.subplots(2, ncols, figsize=(3 * ncols, 6))
        axes = axes.ravel() if n > 1 else [axes]
        for ax, name in zip(axes, plot_names):
            ax.plot(epochs, cols[name], marker=".")
            ax.set_title(name, fontsize=8)
        fig.tight_layout()
        fig.savefig(os.path.join(self.output_path, "results.png"), dpi=120)
        plt.close(fig)
