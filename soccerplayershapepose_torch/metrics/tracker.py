"""Training and evaluation metric trackers.

A copy of ``soccerplayershapepose_tpu/metrics/tracker.py``, which is pure
numpy; the port keeps its own so that it imports nothing of the JAX
package. The bookkeeping is the reference's:

* per-epoch accumulation of the total and per-task losses (weighted by
  samples) and of metric SUMS; the epoch history appends mean-per-sample
  values, metrics divided by their elements per sample (PVE 6890, MPJPE 14,
  joints2D 17, shape 10, pose 216);
* the save rule: an epoch's weights are kept iff EVERY tracked validation
  metric is ≤ its best so far;
* a pickled history with resume;
* the evaluation variant also keeps per-sample values for ``.npy`` export.

The per-batch update takes metric sums (``metrics.measures``): one scalar
per metric crosses to the host per batch.
"""

from __future__ import annotations

import pickle
from typing import Dict, List, Optional, Sequence

import numpy as np

_ELEMENTS_PER_SAMPLE = [
    ("pve", 6890), ("mpjpe", 14), ("joints2D", 17),
    ("shape_mse", 10), ("pose_mse", 24 * 3 * 3),
]


def _num_per_sample(metric: str) -> int:
    for key, n in _ELEMENTS_PER_SAMPLE:
        if key in metric:
            return n
    return 1


class MetricsTracker:
    """Accumulates per-batch sums; appends per-sample means per epoch."""

    def __init__(self, losses_to_track: Sequence[str],
                 metrics_to_track: Sequence[str],
                 log_path: Optional[str] = None):
        self.losses_to_track = list(losses_to_track)
        self.metrics_to_track = list(metrics_to_track)
        self.log_path = log_path
        self.history: Dict[str, List[float]] = {
            "train_losses": [], "val_losses": []}
        for split in ("train", "val"):
            for loss in self.losses_to_track:
                self.history[f"{split}_{loss}_losses"] = []
            for metric in self.metrics_to_track:
                self.history[f"{split}_{metric}"] = []
        self._reset_sums()

    def _reset_sums(self):
        self._sums = {"train_losses": 0.0, "val_losses": 0.0,
                      "train_num_samples": 0, "val_num_samples": 0}
        for split in ("train", "val"):
            for loss in self.losses_to_track:
                self._sums[f"{split}_{loss}_losses"] = 0.0
            for metric in self.metrics_to_track:
                self._sums[f"{split}_{metric}"] = 0.0

    initialise_loss_metric_sums = _reset_sums   # reference-compatible alias

    def update_per_batch(self, split: str, loss: float,
                         task_losses: Dict[str, float],
                         metric_sums: Dict[str, float],
                         num_samples: int):
        """metric_sums: {metric: per-batch SUM over samples and elements}."""
        assert split in ("train", "val")
        self._sums[f"{split}_losses"] += float(loss) * num_samples
        self._sums[f"{split}_num_samples"] += num_samples
        for loss_name in self.losses_to_track:
            if loss_name in task_losses:
                self._sums[f"{split}_{loss_name}_losses"] += \
                    float(task_losses[loss_name]) * num_samples
        for metric in self.metrics_to_track:
            if metric in metric_sums:
                self._sums[f"{split}_{metric}"] += float(metric_sums[metric])

    def update_per_epoch(self):
        for split in ("train", "val"):
            n = self._sums[f"{split}_num_samples"]
            if n:
                self.history[f"{split}_losses"].append(
                    self._sums[f"{split}_losses"] / n)
                for loss in self.losses_to_track:
                    self.history[f"{split}_{loss}_losses"].append(
                        self._sums[f"{split}_{loss}_losses"] / n)
                for metric in self.metrics_to_track:
                    self.history[f"{split}_{metric}"].append(
                        self._sums[f"{split}_{metric}"]
                        / (n * _num_per_sample(metric)))
        self._reset_sums()
        if self.log_path:
            self.save(self.log_path)

    def determine_save_model_weights_this_epoch(
            self, save_val_metrics: Sequence[str],
            best_epoch_val_metrics: Dict[str, float]) -> bool:
        """Save iff EVERY tracked val metric improved (≤ previous best)."""
        for metric in save_val_metrics:
            if self.history[f"val_{metric}"][-1] > best_epoch_val_metrics[metric]:
                return False
        return True

    def save(self, path: str):
        with open(path, "wb") as f:
            pickle.dump(self.history, f)

    def load(self, path: str, current_epoch: int):
        """Resume: truncate history to current_epoch; missing keys → zeros."""
        with open(path, "rb") as f:
            loaded = pickle.load(f)
        for key in self.history:
            if key in loaded:
                self.history[key] = list(loaded[key])[:current_epoch]
            else:
                self.history[key] = [0.0] * current_epoch


class EvalMetricsTracker:
    """Pure-eval variant keeping per-sample metric values for .npy export
    (reference eval_metrics_tracker.py:8-209)."""

    def __init__(self, metrics_to_track: Sequence[str]):
        self.metrics_to_track = list(metrics_to_track)
        self.per_sample: Dict[str, List[np.ndarray]] = {
            m: [] for m in self.metrics_to_track}

    def update_per_batch(self, metric_values: Dict[str, np.ndarray]):
        """metric_values: {metric: (B,) per-sample SUMS over elements}."""
        for m in self.metrics_to_track:
            if m in metric_values:
                vals = np.asarray(metric_values[m]) / _num_per_sample(m)
                self.per_sample[m].append(vals)

    def final_metrics(self) -> Dict[str, float]:
        return {m: float(np.concatenate(v).mean()) if v else float("nan")
                for m, v in self.per_sample.items()}

    def save_per_sample(self, folder: str):
        import os
        os.makedirs(folder, exist_ok=True)
        for m, v in self.per_sample.items():
            if v:
                np.save(os.path.join(folder, f"{m}_per_frame.npy"),
                        np.concatenate(v))
