"""Training-loop utilities: early stopping, CSV logging, metric curves (a
copy of yolosharp_tpu/utils/training.py without occupancy_hint, a hint
calibrated on a TPU), and the train-step trace of Config.profile_dir.

Parity targets: Utils/EarlyStopping.cs:3-39, the log.csv writer
(YoloBaseTaskModel.cs:215-243), config.txt dump (245-257), and results.png
curves (259-288, matplotlib instead of ScottPlot).
"""

from __future__ import annotations

import csv
import os
from datetime import datetime
from typing import Optional, Sequence

import torch


class StepTrace:
    """A torch.profiler trace of train steps `first`..`last` (1-based) of
    one epoch, as the JAX package traces steps 2-5 of the first epoch
    (step 1 pays the warm-up): the CPU and, on a card, its CUDA kernels,
    each step under a record_function ``train step N``. The device is
    synchronised before the trace stops, and the trace is written as a
    Chrome-trace JSON ``train_<time>_steps_<first>-<n>.json`` under
    `out_dir` (n = `last`, or the last step of a shorter epoch: ``close``
    stops it cleanly)."""

    def __init__(self, out_dir: str, device: torch.device, first: int = 2,
                 last: int = 5):
        self.out_dir, self.device = out_dir, device
        self.first, self.last = first, last
        self.prof = None
        self._step = None
        self._n = 0
        self.path: Optional[str] = None

    def before_step(self, n: int) -> None:
        if n == self.first:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            self.prof = profile(activities=acts)
            self.prof.start()
        if self.prof is not None:
            self._step = torch.profiler.record_function(f"train step {n}")
            self._step.__enter__()

    def after_step(self, n: int) -> None:
        if self._step is not None:
            self._step.__exit__(None, None, None)
            self._step = None
            self._n = n
        if n == self.last:
            self.close()

    def close(self) -> None:
        """Stop and write the trace (if one runs)."""
        if self.prof is None:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.prof.stop()
        os.makedirs(self.out_dir, exist_ok=True)
        self.path = os.path.join(
            self.out_dir, f"train_{datetime.now():%y%m%d%H%M%S}_steps_"
                          f"{self.first}-{self._n}.json")
        self.prof.export_chrome_trace(self.path)
        self.prof = None
        print(f"profiler trace written to {self.path}")


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
