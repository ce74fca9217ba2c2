"""Loss functions (PyTorch port of ``flexflow_tpu/losses.py``).

Sparse and dense CCE take the *pre-softmax* logits through
``log_softmax``, summed and divided by the batch, so that autograd's
gradient is (probs - onehot)/B, the reference's fused softmax+CE backward
(loss_functions.cu:141-150).  MSE is 0.5 * sum of squares / B, whose
gradient is (pred - label)/B.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


class LossType:
    CATEGORICAL_CROSSENTROPY = "categorical_crossentropy"
    SPARSE_CATEGORICAL_CROSSENTROPY = "sparse_categorical_crossentropy"
    MEAN_SQUARED_ERROR_AVG_REDUCE = "mean_squared_error"


_ALIASES = {
    "categorical_crossentropy": LossType.CATEGORICAL_CROSSENTROPY,
    "sparse_categorical_crossentropy": LossType.SPARSE_CATEGORICAL_CROSSENTROPY,
    "mean_squared_error": LossType.MEAN_SQUARED_ERROR_AVG_REDUCE,
    "mse": LossType.MEAN_SQUARED_ERROR_AVG_REDUCE,
}


class Loss:
    """Scalar loss over (pre-softmax logits, labels).  ``wants_logits``
    tells the model to feed the input of a trailing Softmax op."""

    def __init__(self, loss_type: str):
        if loss_type not in _ALIASES:
            raise ValueError(f"Unrecognized loss type: {loss_type}")
        self.loss_type = _ALIASES[loss_type]

    @property
    def wants_logits(self) -> bool:
        return self.loss_type in (LossType.CATEGORICAL_CROSSENTROPY,
                                  LossType.SPARSE_CATEGORICAL_CROSSENTROPY)

    def __call__(self, preds: torch.Tensor, labels: torch.Tensor,
                 parts: int = 1) -> torch.Tensor:
        """preds: (B, C) logits for CE losses, final outputs for MSE, or
        (B, T, C) sequence logits reduced per token.  With ``parts`` > 1
        the rows are one of that many equal parts of the batch, and the
        result is their share of the whole batch's loss."""
        preds = preds.float()
        if preds.ndim > 2:
            preds = preds.reshape(-1, preds.shape[-1])
            if labels.ndim > 1 and labels.numel() != preds.shape[0]:
                labels = labels.reshape(preds.shape[0], -1)
        batch = preds.shape[0]
        total = batch * parts
        if self.loss_type == LossType.SPARSE_CATEGORICAL_CROSSENTROPY:
            labels = labels.reshape(batch).long()
            logp = F.log_softmax(preds, dim=-1)
            nll = -logp.gather(1, labels[:, None])
            return nll.sum() / total
        if self.loss_type == LossType.CATEGORICAL_CROSSENTROPY:
            logp = F.log_softmax(preds, dim=-1)
            return (-labels.float() * logp).sum() / total
        diff = preds - labels.float()
        return 0.5 * (diff * diff).sum() / total
