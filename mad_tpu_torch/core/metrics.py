"""Copied from mad_tpu/core/metrics.py (numpy; sklearn optional).

Binary-classifier scoring helpers.

Parity with mad/math_utils.py:58-142 (bc_scoring, mcc_scoring,
precision_scoring, f1_scoring). These are not called by the docking pipeline
in the reference either, but are part of its public surface.
"""

from __future__ import annotations

import numpy as np

try:
    from sklearn.metrics import roc_auc_score
except ImportError:  # pragma: no cover
    roc_auc_score = None


def _confusion(y, q):
    tp = np.sum(q * y)
    tn = np.sum((1.0 - q) * (1.0 - y))
    fp = np.sum(q * (1.0 - y))
    fn = np.sum((1.0 - q) * y)
    return tp, tn, fp, fn


def bc_scoring(y, p):
    """Accuracy/PPV/TPR/TNR/MCC/AUC at the 0.5 threshold
    (mad/math_utils.py:58-86)."""
    y = np.asarray(y, dtype=float)
    p = np.asarray(p, dtype=float)
    q = np.round(p)
    tp, tn, fp, fn = _confusion(y, q)
    if np.all(y > 0.5) or np.all(y < 0.5) or np.any(np.isnan(y)) \
            or np.any(np.isnan(p)) or roc_auc_score is None:
        auc = np.nan
    else:
        auc = roc_auc_score(y, p)
    return {
        "bra": 1.0 - np.mean(y),
        "acc": (tp + tn) / (tp + tn + fp + fn + 1e-6),
        "ppv": tp / (tp + fp + 1e-6),
        "tpr": tp / (tp + fn + 1e-6),
        "tnr": tn / (tn + fp + 1e-6),
        "mcc": ((tp * tn) - (fp * fn)) / (
            np.sqrt((tp + fp) * (tp + fn) * (tn + fp) * (tn + fn)) + 1e-6),
        "auc": auc,
        "std": np.std(p),
    }


def _threshold_sweep(y, p, score_fn):
    y = np.asarray(y, dtype=float)
    p = np.asarray(p, dtype=float)
    vals, best, data = [], -np.inf, None
    for t in np.arange(0, 1.001, 0.05):
        q = (p > t).astype(float)
        tp, tn, fp, fn = _confusion(y, q)
        v = score_fn(tp, tn, fp, fn)
        vals.append(v)
        if v > best:
            best = v
            data = [tp, fp, fn, tn, v, t]
    return vals, data


def mcc_scoring(y, p):
    """Matthews correlation over thresholds (mad/math_utils.py:88-105)."""
    return _threshold_sweep(
        y, p, lambda tp, tn, fp, fn: ((tp * tn) - (fp * fn)) / (
            np.sqrt((tp + fp) * (tp + fn) * (tn + fp) * (tn + fn)) + 1e-6))


def precision_scoring(y, p):
    """Precision over thresholds (mad/math_utils.py:107-124)."""
    return _threshold_sweep(
        y, p, lambda tp, tn, fp, fn: tp / (tp + fp + 1e-6))


def f1_scoring(y, p):
    """F1 over thresholds (mad/math_utils.py:126-142)."""
    vals, _ = _threshold_sweep(
        y, p, lambda tp, tn, fp, fn: (
            2 * (tp / (tp + fp + 1e-6)) * (tp / (tp + fn + 1e-6))
            / ((tp / (tp + fp + 1e-6)) + (tp / (tp + fn + 1e-6)) + 1e-30)))
    return vals
