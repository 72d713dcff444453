"""Depth evaluation metrics (abs-rel, delta-thresholds, RMSE, ...).

The reference computed its paper tables offline from exported .mat files
(export_res.py:123-137, SURVEY.md section 6); here the standard monocular
depth metric suite is first-class so accuracy parity (ScanNet abs-rel,
delta<1.25 — the BASELINE.json north star) is measurable in-repo.

Copy of ``neuralrgbd_tpu/infer/metrics.py`` (the port imports nothing of the JAX
package); ``tests/test_torch_standalone.py`` holds it equal to the original.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np


def depth_metrics(pred: np.ndarray, gt: np.ndarray,
                  mask: Optional[np.ndarray] = None,
                  d_min: float = 1e-3, d_max: float = 1e9) -> Dict[str, float]:
    """Standard suite over valid pixels (gt > 0 within [d_min, d_max])."""
    pred = np.asarray(pred, np.float64)
    gt = np.asarray(gt, np.float64)
    valid = (gt > max(d_min, 1e-9)) & (gt <= d_max) & np.isfinite(pred)
    if mask is not None:
        valid &= mask.astype(bool)
    if valid.sum() == 0:
        return {k: float("nan") for k in
                ("abs_rel", "sq_rel", "rmse", "rmse_log", "log10",
                 "delta1", "delta2", "delta3", "n_valid")}
    p = np.clip(pred[valid], 1e-9, None)
    g = gt[valid]
    thresh = np.maximum(p / g, g / p)
    return {
        "abs_rel": float(np.mean(np.abs(p - g) / g)),
        "sq_rel": float(np.mean((p - g) ** 2 / g)),
        "rmse": float(np.sqrt(np.mean((p - g) ** 2))),
        "rmse_log": float(np.sqrt(np.mean((np.log(p) - np.log(g)) ** 2))),
        "log10": float(np.mean(np.abs(np.log10(p) - np.log10(g)))),
        "delta1": float(np.mean(thresh < 1.25)),
        "delta2": float(np.mean(thresh < 1.25 ** 2)),
        "delta3": float(np.mean(thresh < 1.25 ** 3)),
        "n_valid": int(valid.sum()),
    }


class MetricAccumulator:
    """Pixel-weighted running mean over frames."""

    def __init__(self):
        self._sums: Dict[str, float] = {}
        self._n = 0

    def update(self, m: Dict[str, float]) -> None:
        n = m.get("n_valid", 0)
        if not n or not np.isfinite(m["abs_rel"]):
            return
        for k, v in m.items():
            if k == "n_valid":
                continue
            self._sums[k] = self._sums.get(k, 0.0) + v * n
        self._n += n

    def result(self) -> Dict[str, float]:
        if self._n == 0:
            return {}
        out = {k: v / self._n for k, v in self._sums.items()}
        out["n_valid"] = self._n
        return out
