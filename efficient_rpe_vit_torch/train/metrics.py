"""Classification metrics without sklearn.

Counterpart of `efficient_rpe_vit_tpu/train/metrics.py`: the confusion
matrix is a one-hot product on the device of the predictions (torch);
everything downstream is the JAX package's numpy, copied.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

EPS = 1e-7  # division stabiliser (reference: metrics.py:64)


def compute_confusion_matrix(predictions, targets, num_classes: int):
    """Confusion matrix M[i, j] = #(target=i, predicted=j) via one-hot matmul.

    Args:
        predictions, targets: int tensors or arrays [N]; a tensor's device
        is where the product runs.
    Returns:
        [num_classes, num_classes] int32 tensor.
    """
    p = torch.as_tensor(predictions).long()
    t = torch.as_tensor(targets).long().to(p.device)
    onehot_t = F.one_hot(t, num_classes).float()  # [N, C]
    onehot_p = F.one_hot(p, num_classes).float()
    return (onehot_t.T @ onehot_p).to(torch.int32)


def compute_metrics_from_confusion_matrix(cm) -> Dict[str, float]:
    """Macro/micro/weighted precision, recall, F1 from a confusion matrix
    (reference: metrics.py:42-110)."""
    if isinstance(cm, torch.Tensor):
        cm = cm.cpu().numpy()
    cm = np.asarray(cm, dtype=np.float64)
    tp = np.diag(cm)
    fp = cm.sum(axis=0) - tp
    fn = cm.sum(axis=1) - tp
    support = cm.sum(axis=1)

    precision = tp / (tp + fp + EPS)
    recall = tp / (tp + fn + EPS)
    f1 = 2 * precision * recall / (precision + recall + EPS)

    total = cm.sum()
    weights = support / (total + EPS)

    micro_tp, micro_fp, micro_fn = tp.sum(), fp.sum(), fn.sum()
    micro_p = micro_tp / (micro_tp + micro_fp + EPS)
    micro_r = micro_tp / (micro_tp + micro_fn + EPS)

    return {
        "accuracy": float(tp.sum() / (total + EPS)),
        "precision_macro": float(precision.mean()),
        "recall_macro": float(recall.mean()),
        "f1_macro": float(f1.mean()),
        "precision_micro": float(micro_p),
        "recall_micro": float(micro_r),
        "f1_micro": float(2 * micro_p * micro_r / (micro_p + micro_r + EPS)),
        "precision_weighted": float((precision * weights).sum()),
        "recall_weighted": float((recall * weights).sum()),
        "f1_weighted": float((f1 * weights).sum()),
        "per_class_precision": precision.tolist(),
        "per_class_recall": recall.tolist(),
        "per_class_f1": f1.tolist(),
        "support": support.tolist(),
    }


def compute_classification_metrics(
    predictions, targets, num_classes: Optional[int] = None
) -> Dict[str, float]:
    """Full metric dict from raw predictions/targets
    (reference: metrics.py:113-145)."""
    if num_classes is None:
        num_classes = int(max(int(torch.as_tensor(predictions).max()),
                              int(torch.as_tensor(targets).max())) + 1)
    cm = compute_confusion_matrix(predictions, targets, num_classes).cpu().numpy()
    metrics = compute_metrics_from_confusion_matrix(cm)
    metrics["confusion_matrix"] = cm.tolist()
    return metrics


def accuracy_score(predictions, targets) -> float:
    """Fraction correct (reference: metrics.py:148-161)."""
    p = torch.as_tensor(predictions)
    t = torch.as_tensor(targets).to(p.device)
    return float((p == t).float().mean())


def compute_information_criteria(
    mean_nll: float, num_samples: int, num_parameters: int
) -> Dict[str, float]:
    """Log-likelihood, AIC, and BIC for a classifier.

    The reference's DESIGN.md:42-58 specifies these but never implemented
    them (SURVEY.md §5.5) — delivered here. For cross-entropy training the
    mean NLL is the per-sample negative log-likelihood, so:

        log L = -mean_nll * n
        AIC   = 2k - 2 log L
        BIC   = k ln n - 2 log L
    """
    log_likelihood = -mean_nll * num_samples
    aic = 2.0 * num_parameters - 2.0 * log_likelihood
    bic = num_parameters * float(np.log(max(1, num_samples))) - 2.0 * log_likelihood
    return {
        "log_likelihood": float(log_likelihood),
        "aic": float(aic),
        "bic": float(bic),
    }


def precision_recall_fscore_support(targets, predictions, average: str = "weighted",
                                    num_classes: Optional[int] = None):
    """sklearn-compatible wrapper (reference: metrics.py:165-196)."""
    m = compute_classification_metrics(predictions, targets, num_classes)
    if average not in ("macro", "micro", "weighted"):
        raise ValueError(f"unknown average {average!r}")
    return (
        m[f"precision_{average}"],
        m[f"recall_{average}"],
        m[f"f1_{average}"],
        None,
    )
