"""Logging: stdout tee + TensorBoard metrics.

Reference observability (SURVEY.md section 5): tensorboardX scalar
``data/train_error`` per iteration + depth image panels every
``TB_add_img_interv`` (train_KVNet.py:337-375), stdout teed to
``runs/<exp>/log_<ts>.txt`` (Logger.py:10-38), arg dump ``tr_paras.txt``.

Copy of ``neuralrgbd_tpu/utils/logging.py`` (the port imports nothing of the JAX
package); ``tests/test_torch_standalone.py`` holds it equal to the original.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import sys
from typing import Optional

import numpy as np


class Tee:
    """Mirror stdout to a logfile (the reference's Logger.py)."""

    def __init__(self, log_dir: str, prefix: str = "log"):
        os.makedirs(log_dir, exist_ok=True)
        ts = datetime.datetime.now().strftime("%Y%m%d_%H%M%S")
        self.path = os.path.join(log_dir, f"{prefix}_{ts}.txt")
        self._file = open(self.path, "a", buffering=1)
        self._stdout = sys.stdout

    def install(self):
        sys.stdout = self
        return self

    def write(self, msg):
        self._stdout.write(msg)
        self._file.write(msg)

    def flush(self):
        self._stdout.flush()
        self._file.flush()

    def uninstall(self):
        sys.stdout = self._stdout
        self._file.close()


class MetricsWriter:
    """Thin TensorBoard wrapper (torch.utils.tensorboard; no-op fallback)."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        try:
            from torch.utils.tensorboard import SummaryWriter

            self._w = SummaryWriter(log_dir)
        except Exception:
            self._w = None

    def scalar(self, tag: str, value: float, step: int):
        if self._w is not None:
            self._w.add_scalar(tag, float(value), step)

    def image(self, tag: str, img_hwc: np.ndarray, step: int):
        """img_hwc: (H, W) or (H, W, C) float array, auto-normalized."""
        if self._w is None:
            return
        arr = np.asarray(img_hwc, np.float32)
        rng = arr.max() - arr.min()
        arr = (arr - arr.min()) / (rng + 1e-9)
        if arr.ndim == 2:
            arr = arr[None]
        else:
            arr = arr.transpose(2, 0, 1)
        self._w.add_image(tag, arr, step)

    def close(self):
        if self._w is not None:
            self._w.close()


def save_args(path: str, args) -> None:
    """Dump config/args to a txt file (mutils/misc.py:179-192)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        if dataclasses.is_dataclass(args):
            items = dataclasses.asdict(args).items()
        elif hasattr(args, "__dict__"):
            items = vars(args).items()
        else:
            items = dict(args).items()
        for k, v in sorted(items):
            f.write(f"{k} = {v}\n")
