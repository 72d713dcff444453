"""Profile the exact K-Net on one card, layer class by layer class.

    python3 -m neuralrgbd_tpu_torch.tools.knet_ab [--out FILE]
        [--shapes 64x64x96,64x64x192,32x64x96]

For each (D, H, W) volume, in the step's numerics
(``infer.step.step_numerics``: TF32 off, deterministic cuDNN), no grad, a
K-Net of 16 input channels and feature_dim 64:

- each conv class (16 -> 64, 64 -> 64) on the fp32-accurate conv kernel
  (``ops.cuda.conv3d_f32``: the conv with its statistics and their
  finalize): device ms (a CUDA graph of repeated calls between events,
  ``utils.timing.device_ms``), host us a call, its two bounds (the 3xTF32
  products at 495 TFLOP/s, the fp32 FLOPs at 67 TFLOP/s), the plain twin
  on the card, and cuDNN fp32's conv alone (the module path's);
- the split pass (the pending BatchNorm and ReLU, with and without the
  residual skip) and its bytes' bound at 3.35 TB/s; the last conv (64 -> 1)
  on the head kernel, its bound, and cuDNN fp32's (the module path's);
- the whole K-Net as one CUDA graph, device ms, on the modules and on the
  kernel path, the kernel path's conv launches a call, its top device
  kernels in one profiled call, and the two paths' largest output
  difference.

Prints one JSON line per volume and writes every number to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from neuralrgbd_tpu_torch.infer.step import step_numerics
from neuralrgbd_tpu_torch.models.knet import KNet
from neuralrgbd_tpu_torch.models.layers import reference_init_
from neuralrgbd_tpu_torch.ops.cuda import build
from neuralrgbd_tpu_torch.ops.cuda import conv3d_f32 as k3
from neuralrgbd_tpu_torch.tools.dnet_ab import _device_kernels
from neuralrgbd_tpu_torch.utils.timing import device_ms, host_us


def _split_bound_ms(P: int, C: int, skip: bool) -> float:
    """The split's bytes at 3.35 TB/s: the raw input once, the skip's
    two parts once where there is one, the two parts out."""
    return 1e3 * 4.0 * P * C * (1 + 2 + (2 if skip else 0)) / 3.35e12


def profile(D: int, H: int, W: int, dev) -> dict:
    knet = reference_init_(KNet(16, 64, device=dev), 0)
    g = torch.Generator().manual_seed(1)
    vol = torch.randn((1, 16, D, H, W), generator=g).to(dev)
    P = D * H * W
    out = {"shape": [D, H, W], "card": torch.cuda.get_device_name(dev),
           "classes": {}}
    with torch.no_grad(), step_numerics(False):
        for cin, layer in ((16, knet.dres0[0]), (64, knet.dres1[0])):
            conv, bn = layer
            x = torch.relu(torch.randn((D, H, W, cin), generator=g)).to(dev)
            s = k3.split(k3.Act(x))
            flops = 2.0 * 27 * cin * 64 * P
            xn = x.permute(3, 0, 1, 2)[None].contiguous()
            out["classes"][f"{cin}->64"] = {
                "gflop": flops / 1e9,
                "kernel_ms": device_ms(lambda: k3.conv_kernel(s, conv, bn),
                                       calls=20, replays=3),
                "host_us": host_us(lambda: k3.conv_kernel(s, conv, bn)),
                "bound_3xtf32_ms": 3 * flops / 495e9,
                "bound_ffma_ms": flops / 67e9,
                "plain_ms": device_ms(lambda: k3.conv_plain(s, conv, bn),
                                      calls=3, replays=3),
                "cudnn_ms": device_ms(lambda: conv(xn), calls=10, replays=3),
            }
        y = torch.randn((D, H, W, 64), generator=g).to(dev)
        pend = torch.stack([torch.zeros(64), torch.ones(64),
                            torch.zeros(64)]).to(dev)
        skip = k3.split(k3.Act(y))
        out["split_ms"] = device_ms(lambda: k3.split(k3.Act(y, pend, True)),
                                    calls=20, replays=3)
        out["split_skip_ms"] = device_ms(
            lambda: k3.split(k3.Act(y, pend, False, skip)), calls=20,
            replays=3)
        out["split_bound_ms"] = _split_bound_ms(P, 64, False)
        out["split_skip_bound_ms"] = _split_bound_ms(P, 64, True)
        last = knet.classify[2]
        act = k3.Act(y, pend, True)
        out["head_ms"] = device_ms(lambda: k3.head(act, last), calls=20,
                                   replays=3)
        out["head_bound_ms"] = max(2.0 * 27 * 64 * P / 67e9,
                                   1e3 * 4.0 * P * 65 / 3.35e12)
        zn = k3.apply_pending(act).permute(3, 0, 1, 2)[None].contiguous()
        out["head_cudnn_ms"] = device_ms(lambda: last(zn), calls=10,
                                         replays=3)
        out["module_ms"] = device_ms(lambda: knet(vol, kernels=False),
                                     calls=2, replays=3)
        before = k3.launches
        got = knet(vol, kernels=True)
        out["launches_a_call"] = k3.launches - before
        out["kernel_ms"] = device_ms(lambda: knet(vol, kernels=True),
                                     calls=5, replays=3)
        out["kernel_host_us"] = host_us(lambda: knet(vol, kernels=True),
                                        calls=10)
        out["kernel_top"] = [[k[:120], round(us, 1)] for k, us in
                             _device_kernels(lambda: knet(vol))[:12]]
        out["module_top"] = [[k[:120], round(us, 1)] for k, us in
                             _device_kernels(lambda: knet(vol, False))[:12]]
        out["max_abs_diff"] = float((got - knet(vol, kernels=False))
                                    .abs().max())
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write every number here (JSON)")
    ap.add_argument("--shapes", default="64x64x96,64x64x192,32x64x96")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("knet_ab: needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    for name, log in build.build(("conv3d_f32",)).items():
        print(f"nvcc {name}:\n" + "\n".join(
            ln for ln in log.splitlines()
            if "registers" in ln or "spill" in ln), file=sys.stderr)
    lines = []
    for shape in args.shapes.split(","):
        D, H, W = (int(v) for v in shape.split("x"))
        line = profile(D, H, W, dev)
        print(json.dumps(line), flush=True)
        lines.append(line)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(lines, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
