"""Training metrics (PyTorch port of ``flexflow_tpu/metrics.py``).

``Metrics.compute`` returns per-batch sums as device tensors; the model
adds them into one device vector and fetches it once per drain.
``PerfMetrics`` holds the host-side running totals.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Sequence

import torch
import torch.nn.functional as F

LOG_MIN_VALUE = 1e-20


class MetricsType:
    ACCURACY = "accuracy"
    CATEGORICAL_CROSSENTROPY = "categorical_crossentropy"
    SPARSE_CATEGORICAL_CROSSENTROPY = "sparse_categorical_crossentropy"
    MEAN_SQUARED_ERROR = "mean_squared_error"
    ROOT_MEAN_SQUARED_ERROR = "root_mean_squared_error"
    MEAN_ABSOLUTE_ERROR = "mean_absolute_error"


@dataclasses.dataclass
class PerfMetrics:
    """Host-side running totals (reference: include/metrics_functions.h:25-39)."""

    train_all: int = 0
    train_correct: int = 0
    cce_loss: float = 0.0
    sparse_cce_loss: float = 0.0
    mse_loss: float = 0.0
    rmse_loss: float = 0.0
    mae_loss: float = 0.0

    def update(self, one: Dict[str, float]) -> None:
        self.train_all += int(one.get("train_all", 0))
        self.train_correct += int(one.get("train_correct", 0))
        self.cce_loss += float(one.get("cce_loss", 0.0))
        self.sparse_cce_loss += float(one.get("sparse_cce_loss", 0.0))
        self.mse_loss += float(one.get("mse_loss", 0.0))
        self.rmse_loss += float(one.get("rmse_loss", 0.0))
        self.mae_loss += float(one.get("mae_loss", 0.0))

    def reset(self) -> None:
        self.__init__()

    @property
    def accuracy(self) -> float:
        return self.train_correct * 100.0 / max(1, self.train_all)

    def to_string(self) -> str:
        out = "[Metrics]"
        n = max(1, self.train_all)
        if self.train_all > 0:
            out += (f" accuracy: {self.accuracy:.6f}% "
                    f"({self.train_correct} / {self.train_all})")
        if self.cce_loss > 0:
            out += f" categorical_crossentropy: {self.cce_loss / n:.6f}"
        if self.sparse_cce_loss > 0:
            out += f" sparse_categorical_crossentropy: {self.sparse_cce_loss / n:.6f}"
        if self.mse_loss > 0:
            out += f" mean_squared_error: {self.mse_loss / n:.6f}"
        if self.rmse_loss > 0:
            out += f" root_mean_squared_error: {self.rmse_loss / n:.6f}"
        if self.mae_loss > 0:
            out += f" mean_absolute_error: {self.mae_loss / n:.6f}"
        return out

    def print(self) -> None:
        print(self.to_string())


class Metrics:
    """Per-batch metric sums (reference compute kernels:
    metrics_functions.cu:57-175).  ``probs`` is the softmax output (or the
    final activation); ``labels`` is int (B,)/(B,1) when ``sparse`` else
    one-hot/regression targets (B, C)."""

    def __init__(self, loss_type: str, metrics: Sequence[str]):
        self.metrics = list(metrics)
        self.sparse = "sparse" in loss_type
        self.loss_type = loss_type

    def compute(self, probs: torch.Tensor, labels: torch.Tensor) -> Dict[str, torch.Tensor]:
        probs = probs.float()
        if probs.ndim > 2:
            probs = probs.reshape(-1, probs.shape[-1])
            labels = (labels.reshape(probs.shape[0], -1) if self.sparse
                      else labels.reshape(probs.shape))
        batch, num_classes = probs.shape[0], probs.shape[-1]
        # torch.full, not torch.tensor: a host->device copy of a scalar
        # would wait for the stream on every step
        out: Dict[str, torch.Tensor] = {
            "train_all": torch.full((), float(batch), device=probs.device)}
        m = self.metrics
        if self.sparse:
            sl = labels.reshape(batch).long()
            if MetricsType.ACCURACY in m:
                out["train_correct"] = (probs.argmax(-1) == sl).sum().float()
            if MetricsType.SPARSE_CATEGORICAL_CROSSENTROPY in m:
                p = probs.gather(1, sl[:, None])
                out["sparse_cce_loss"] = (-torch.log(p.clamp_min(LOG_MIN_VALUE))).sum()
            if (MetricsType.MEAN_SQUARED_ERROR in m
                    or MetricsType.ROOT_MEAN_SQUARED_ERROR in m
                    or MetricsType.MEAN_ABSOLUTE_ERROR in m):
                diff = probs - F.one_hot(sl, num_classes).float()
                mse = (diff * diff).sum(-1)
                if MetricsType.MEAN_SQUARED_ERROR in m:
                    out["mse_loss"] = mse.sum()
                if MetricsType.ROOT_MEAN_SQUARED_ERROR in m:
                    out["rmse_loss"] = mse.sqrt().sum()
                if MetricsType.MEAN_ABSOLUTE_ERROR in m:
                    out["mae_loss"] = diff.abs().sum()
        else:
            labels = labels.float()
            if MetricsType.ACCURACY in m:
                if num_classes == 1:
                    # one output: the reference reports 100%
                    # (metrics_functions.cu:121-126)
                    out["train_correct"] = out["train_all"].clone()
                else:
                    out["train_correct"] = (probs.argmax(-1) == labels.argmax(-1)).sum().float()
            if MetricsType.CATEGORICAL_CROSSENTROPY in m:
                cce = -labels * torch.log(probs.clamp_min(LOG_MIN_VALUE))
                out["cce_loss"] = torch.where(labels > 0.0, cce, torch.zeros_like(cce)).sum()
            diff = probs - labels
            mse = (diff * diff).sum(-1)
            if MetricsType.MEAN_SQUARED_ERROR in m:
                out["mse_loss"] = mse.sum()
            if MetricsType.ROOT_MEAN_SQUARED_ERROR in m:
                out["rmse_loss"] = mse.sqrt().sum()
            if MetricsType.MEAN_ABSOLUTE_ERROR in m:
                out["mae_loss"] = diff.abs().sum()
        return out
