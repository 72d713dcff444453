"""Profile the D-Net's feature extractor on one card, conv by conv.

    python3 -m neuralrgbd_tpu_torch.tools.dnet_ab [--out FILE] [--batches 5,1]
        [--hw 256,384] [--sweep]

For each batch size B, on a (B, 3, H, W) fp32 input in the step's numerics
(``infer.step.step_numerics``: TF32 off, deterministic cuDNN), no grad:

- every convolution of the module path alone, grouped by class (input and
  output channels, kernel, stride, dilation, input size): the device
  kernels cuDNN runs for it (from ``torch.profiler``), whether one of them
  is an FFT, and its device ms (a CUDA graph of repeated calls between
  events, ``utils.timing.device_ms``);
- the same conv on the fp32 conv kernel (``ops.cuda.conv2d_bn``: the conv
  with its statistics and their finalize, in ``config_for``'s tiles, and
  with ``--sweep`` in every tile configuration), its plain twin on the
  card, and its bound (fp32 FLOPs at 67 TFLOP/s, or its bytes at 3.35
  TB/s);
- the whole extractor as one CUDA graph, device ms, and its top device
  kernels by summed time in one profiled eager call, on the modules and on
  the kernel path (``FeatureExtractor.forward(x, kernels=True)``), and the
  two paths' largest output difference.

Prints a JSON line and a line per class for each batch size, and writes
every number to ``--out`` if given.
"""

from __future__ import annotations

import argparse
import json
import sys
from collections import defaultdict

import torch

from neuralrgbd_tpu_torch.infer.step import step_numerics
from neuralrgbd_tpu_torch.models.feature_extractor import FeatureExtractor
from neuralrgbd_tpu_torch.models.layers import reference_init_
from neuralrgbd_tpu_torch.ops.cuda import build
from neuralrgbd_tpu_torch.ops.cuda import conv2d_bn as kconv
from neuralrgbd_tpu_torch.utils.timing import device_ms

_FFT = ("fft", "FFT", "cf32", "region_transform")


def _conv_inputs(fe: FeatureExtractor, x: torch.Tensor) -> list:
    """[(name, conv module, its input)] of one module-path call."""
    seen = []
    hooks = [m.register_forward_pre_hook(
        lambda mod, args, name=name: seen.append((name, mod,
                                                  args[0].clone())))
        for name, m in fe.named_modules() if isinstance(m, torch.nn.Conv2d)]
    try:
        fe(x, kernels=False)
    finally:
        for h in hooks:
            h.remove()
    return seen


def _device_kernels(fn) -> list:
    """[(device kernel name, us)] of one call of ``fn``."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sorted(((e.key, e.self_device_time_total)
                   for e in prof.key_averages()
                   if e.self_device_time_total > 0), key=lambda kv: -kv[1])


def _cls(mod: torch.nn.Conv2d, x: torch.Tensor) -> str:
    return (f"{mod.in_channels}->{mod.out_channels} k{mod.kernel_size[0]} "
            f"s{mod.stride[0]} d{mod.dilation[0]} at "
            f"{x.shape[-2]}x{x.shape[-1]}")


def _out_pixels(mod: torch.nn.Conv2d, x: torch.Tensor) -> int:
    k, s, d, p = (mod.kernel_size[0], mod.stride[0], mod.dilation[0],
                  mod.padding[0])
    Ho, Wo = ((n + 2 * p - d * (k - 1) - 1) // s + 1 for n in x.shape[-2:])
    return Ho * Wo


def _bound_ms(mod, x, flops) -> tuple:
    """The least time: fp32 FLOPs at 67 TFLOP/s or the input, output and
    weights once at 3.35 TB/s, whichever is larger."""
    nbytes = 4.0 * (x.numel() + x.shape[0] * mod.out_channels
                    * _out_pixels(mod, x) + mod.weight.numel())
    t_ops, t_bytes = flops / 67e12, nbytes / 3.35e12
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def _kernel_inputs(fe, name: str, mod, x) -> tuple:
    """The kernel's inputs for the conv ``name`` as the kernel path runs
    it: x with a pending BatchNorm and ReLU where the path has one (every
    conv but the first and ``lastconv``'s 3x3, whose inputs are
    materialised), and its BatchNorm (none for the last 1x1)."""
    C = x.shape[1]
    pending = None
    if name not in ("firstconv.0.0", "lastconv.0.0"):
        pending = torch.stack([torch.zeros(C), torch.ones(C),
                               torch.zeros(C)]).to(x.device)
    bn = dict(fe.named_modules()).get(name[:-1] + "1")
    if not isinstance(bn, torch.nn.BatchNorm2d):
        bn = None
    return kconv.Act(x, pending, True), bn


def profile(B: int, H: int, W: int, dev, sweep: bool = False) -> dict:
    fe = reference_init_(FeatureExtractor(64, device=dev), 0).eval()
    x = torch.randn((B, 3, H, W), generator=torch.Generator().manual_seed(1)
                    ).to(dev)
    out = {"batch": B, "hw": [H, W], "card": torch.cuda.get_device_name(dev),
           "classes": {}}
    with torch.no_grad(), step_numerics(False):
        classes = defaultdict(lambda: {"count": 0})
        for name, mod, xin in _conv_inputs(fe, x):
            c = classes[_cls(mod, xin)]
            c.setdefault("names", []).append(name)
            c["count"] += 1
            if "cudnn_ms" in c:
                continue
            c["example"] = name
            ks = _device_kernels(lambda: mod(xin))
            c["cudnn_kernels"] = [[k[:120], round(us, 1)] for k, us in ks]
            c["fft"] = any(t in k for k, _ in ks for t in _FFT)
            c["cudnn_ms"] = device_ms(lambda: mod(xin), calls=5, replays=3)
            flops = (2.0 * mod.in_channels * mod.out_channels
                     * mod.kernel_size[0] * mod.kernel_size[1] * B
                     * _out_pixels(mod, xin))
            c["gflop"] = flops / 1e9
            c["bound_ms"], c["bound_by"] = _bound_ms(mod, xin, flops)
            if not name.startswith("branch"):
                a, bn = _kernel_inputs(fe, name, mod, xin)
                c["kernel_ms"] = device_ms(
                    lambda: kconv.conv_bn(a, mod, bn), calls=20, replays=3)
                if sweep:
                    c["kernel_ms_by_config"] = {
                        str(kconv.TILES[i]): device_ms(
                            lambda: kconv.conv_bn(a, mod, bn, config=i),
                            calls=20, replays=3)
                        for i in range(len(kconv.TILES))
                        if kconv.TILES[i][1] <= max(32, mod.out_channels)}
                c["plain_ms"] = device_ms(
                    lambda: kconv.conv_plain(a, mod, bn is not None),
                    calls=5, replays=3)
                c["kernel_tflops"] = flops / c["kernel_ms"] / 1e9
        for c in classes.values():
            for k in ("cudnn_ms", "kernel_ms", "bound_ms"):
                if k in c:
                    c[k + "_all"] = c[k] * c["count"]
        out["classes"] = dict(classes)
        out["fft_ms"] = sum(c["cudnn_ms_all"] for c in classes.values()
                            if c["fft"])
        out["conv_ms"] = sum(c["cudnn_ms_all"] for c in classes.values())
        def modules():
            return fe(x, kernels=False)

        out["module_ms"] = device_ms(modules, calls=2, replays=3)
        out["module_top"] = [[k[:120], round(us, 1)] for k, us in
                             _device_kernels(modules)[:12]]
        out["kernel_conv_ms"] = sum(c.get("kernel_ms_all", 0.0)
                                    for c in classes.values())
        out["kernel_ms"] = device_ms(lambda: fe(x, kernels=True), calls=5,
                                     replays=3)
        out["kernel_top"] = [[k[:120], round(us, 1)] for k, us in
                             _device_kernels(lambda: fe(x, kernels=True))[:12]]
        out["max_abs_diff"] = [float((a - b).abs().max()) for a, b in
                               zip(modules(), fe(x, kernels=True))]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write every number here (JSON)")
    ap.add_argument("--batches", default="5,1")
    ap.add_argument("--hw", default="256,384")
    ap.add_argument("--sweep", action="store_true",
                    help="time each conv class in every tile configuration")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("dnet_ab: needs a CUDA card", file=sys.stderr)
        return 1
    H, W = (int(v) for v in args.hw.split(","))
    dev = torch.device("cuda")
    for name, log in build.build().items():   # ptxas' register report
        print(f"nvcc {name}:\n" + "\n".join(
            ln for ln in log.splitlines() if "conv_kernel" in ln
            or "registers" in ln or "spill" in ln), file=sys.stderr)
    lines = []
    for B in (int(b) for b in args.batches.split(",")):
        line = profile(B, H, W, dev, args.sweep)
        print(json.dumps({k: v for k, v in line.items()
                          if k not in ("classes", "module_top")}), flush=True)
        for k, c in line["classes"].items():
            print(f"  {k}: x{c['count']} fft {c['fft']} cuDNN "
                  f"{c['cudnn_ms']:.4f} kernel {c.get('kernel_ms', 0):.4f} "
                  f"plain {c.get('plain_ms', 0):.4f} bound "
                  f"{c['bound_ms']:.4f} ms", flush=True)
            for cfg, ms in c.get("kernel_ms_by_config", {}).items():
                print(f"    {cfg} {ms:.4f}", flush=True)
        lines.append(line)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(lines, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
