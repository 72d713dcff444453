"""Time variants of the prediction kernel on one card.

    python3 -m neuralrgbd_tpu_torch.tools.resample_tune [CHUNK:THREADS ...]

Each variant is ``csrc/resample.cu`` built with ``-DCHUNK=c -DTHREADS=t``
(depth planes per thread, pixels per block) and the package's ``nvcc``
flags, all variants in parallel. Each one is put in place of the wrapper's
C entry, held bit for bit against the default build, and timed as
``predict_next_cuda`` (``device_ms``: a CUDA graph of 100 launches) at
(64, 64, 96) with N=1 and N=2, (64, 64, 192) and (64, 256, 384), the
variants in turns: in order, then in reverse. Prints one JSON line per
variant with its ``ptxas`` registers.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import math
import re
import statistics
import subprocess
import sys

import torch

from neuralrgbd_tpu_torch.config import ModelConfig
from neuralrgbd_tpu_torch.data.synthetic import synthetic_batch
from neuralrgbd_tpu_torch.ops.cuda import build
from neuralrgbd_tpu_torch.ops.cuda import resample as kresample
from neuralrgbd_tpu_torch.tools.resample_ab import inputs
from neuralrgbd_tpu_torch.utils.timing import device_ms

DEFAULT = ("1:128", "2:128", "4:128", "8:128", "16:128", "2:256", "4:256",
           "8:64")


def build_variants(variants):
    """{variant: (C entry, ptxas registers)}, built in parallel."""
    src = build.CSRC_DIR / "resample.cu"
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for v in variants:
        chunk, threads = v.split(":")
        flags = (*build.NVCC_FLAGS, f"-DCHUNK={chunk}", f"-DTHREADS={threads}")
        digest = hashlib.sha256(src.read_bytes() + " ".join(flags).encode()
                                ).hexdigest()[:16]
        lib = build.BUILD_DIR / f"libresample-variant-{digest}.so"
        procs[v] = (lib, subprocess.Popen(
            [build.nvcc_path(), *flags, "-o", str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    out = {}
    for v, (lib, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {v}:\n{log}")
        fn = ctypes.CDLL(str(lib)).resample_launch
        fn.argtypes = kresample._ARGTYPES
        fn.restype = ctypes.c_int
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", log)]
        out[v] = (fn, regs)
    return out


def cases(cfg, device):
    """{name: predict_next_cuda's arguments}."""
    pad = math.log(1.0 / cfg.ndepth)
    got = {}
    for h, w in ((64, 96), (64, 192), (256, 384)):
        lv, pose, K, d = inputs(cfg, h, w, device)
        got[f"{cfg.ndepth}x{h}x{w} N=1"] = (lv[None], pose[None], K[None], d,
                                             pad)
        if w == 96:
            pose2 = torch.from_numpy(
                synthetic_batch(cfg, seed=1)[0]["pose_next"][0]).to(device)
            got[f"{cfg.ndepth}x{h}x{w} N=2"] = (
                torch.stack([lv, lv.flip(0)]), torch.stack([pose, pose2]),
                torch.stack([K, K]), d, pad)
    return got


def main(argv) -> int:
    if not torch.cuda.is_available():
        raise SystemExit("resample_tune: needs a CUDA card")
    variants = argv or DEFAULT
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    device = torch.device("cuda", 0)
    args = cases(ModelConfig(), device)
    want = {name: kresample.predict_next_cuda(*a) for name, a in args.items()}
    built = build_variants(variants)
    times = {v: {name: [] for name in args} for v in variants}
    exact = {}
    for v in (*variants, *reversed(variants)):
        kresample._launch = built[v][0]
        for name, a in args.items():
            if v not in exact or name not in exact[v]:
                exact.setdefault(v, {})[name] = torch.equal(
                    kresample.predict_next_cuda(*a), want[name])
            times[v][name].append(device_ms(
                lambda: kresample.predict_next_cuda(*a)))
    kresample._launch = None
    for v in variants:
        print(json.dumps({
            "variant": v, "registers": built[v][1],
            "equal_to_default": all(exact[v].values()),
            "device_ms": {n: statistics.mean(t) for n, t in times[v].items()},
            "runs": times[v]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
