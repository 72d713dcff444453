"""Time the prediction kernel beside an older, coordinate-taking resample
kernel, on one card.

    python3 -m neuralrgbd_tpu_torch.tools.resample_ab OLD_RESAMPLE_CU

``OLD_RESAMPLE_CU`` is a ``resample.cu`` from this package's history whose
C entry is ``resample_launch(vol, cx, cy, cz, out, D, H, W, pad, lo, hi,
device, stream)``: one thread per voxel, sampling at three coordinate
volumes that the caller computed with ``resample_pixel_coords`` after a
``torch.linalg.inv`` of the pose. The script builds it with the package's
``nvcc`` flags, and at (64, 64, 96), (64, 64, 192) and (64, 256, 384),
N=1, prints one JSON line each: the two kernels' device times (a CUDA
graph of 100 launches) and call times, each measured in the order old,
new, new, old; the whole prediction step as each path runs it (host clock
to the sync); and the largest difference between the two outputs.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import math
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from neuralrgbd_tpu_torch.config import ModelConfig
from neuralrgbd_tpu_torch.data.synthetic import synthetic_batch
from neuralrgbd_tpu_torch.infer.step import predict_next
from neuralrgbd_tpu_torch.ops.camera import Camera
from neuralrgbd_tpu_torch.ops.cuda import build
from neuralrgbd_tpu_torch.ops.cuda import resample as kresample
from neuralrgbd_tpu_torch.utils.timing import call_ms, device_ms, host_ms

_OLD_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 3
                 + [ctypes.c_float] * 3 + [ctypes.c_int, ctypes.c_void_p])


def load_old(src: Path):
    """Build ``src`` (once per content) and return its C entry."""
    digest = hashlib.sha256(src.read_bytes() + " ".join(
        build.NVCC_FLAGS).encode()).hexdigest()[:16]
    lib = build.BUILD_DIR / f"libresample_old-{digest}.so"
    if not lib.exists():
        build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(lib),
                        str(src)], check=True)
    fn = ctypes.CDLL(str(lib)).resample_launch
    fn.argtypes = _OLD_ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def old_kernel(fn, lv, cx, cy, cz, pad):
    out = torch.empty_like(lv)
    D, H, W = lv.shape
    err = fn(lv.data_ptr(), cx.data_ptr(), cy.data_ptr(), cz.data_ptr(),
             out.data_ptr(), D, H, W, pad, -1000.0, 0.0, lv.device.index,
             torch.cuda.current_stream(lv.device).cuda_stream)
    if err:
        raise RuntimeError(f"old resample kernel: CUDA error {err}")
    return out


def old_step(fn, lv, pose, K, d, pad):
    """The prediction step as the older path ran it for one lane."""
    D, H, W = lv.shape
    cx, cy, cz = kresample.resample_pixel_coords(
        Camera(K=K), torch.linalg.inv(pose), d, H, W)
    return old_kernel(fn, lv, cx, cy, cz, pad)


def inputs(cfg, h, w, device):
    g = torch.Generator().manual_seed(0)
    lv = torch.log_softmax(torch.randn(cfg.ndepth, h, w, generator=g), 0)
    pose = synthetic_batch(cfg, seed=0)[0]["pose_next"][0]
    K = np.array([[w / 2 / math.tan(math.radians(30)), 0, w / 2],
                  [0, h / 2 / math.tan(math.radians(24)), h / 2],
                  [0, 0, 1]], np.float32)
    return (lv.to(device), torch.from_numpy(pose).to(device),
            torch.from_numpy(K).to(device),
            torch.as_tensor(cfg.d_candi, device=device))


def main(argv) -> int:
    if len(argv) != 1:
        raise SystemExit(__doc__)
    if not torch.cuda.is_available():
        raise SystemExit("resample_ab: needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    old = load_old(Path(argv[0]))
    cfg = ModelConfig()
    pad = math.log(1.0 / cfg.ndepth)
    device = torch.device("cuda", 0)
    for h, w in ((64, 96), (64, 192), (256, 384)):
        lv, pose, K, d = inputs(cfg, h, w, device)
        coords = kresample.resample_pixel_coords(
            Camera(K=K), torch.linalg.inv(pose), d, h, w)
        calls = {
            "old": lambda: old_kernel(old, lv, *coords, pad),
            "new": lambda: kresample.predict_next_cuda(
                lv[None], pose[None], K[None], d, pad)}
        steps = {
            "old": lambda: old_step(old, lv, pose, K, d, pad),
            "new": lambda: predict_next(lv[None], pose[None], K[None], d)}
        err = float((calls["old"]() - calls["new"]()[0]).abs().max())
        row = {"shape": [cfg.ndepth, h, w], "max_abs_diff": err}
        for what, timer, fns in (("device_ms", device_ms, calls),
                                 ("call_ms", call_ms, calls),
                                 ("step_ms", host_ms, steps)):
            got = {"old": [], "new": []}
            for name in ("old", "new", "new", "old"):
                got[name].append(timer(fns[name]))
            for name, ts in got.items():
                row[f"{name}_{what}"] = statistics.mean(ts)
                row[f"{name}_{what}_runs"] = ts
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
