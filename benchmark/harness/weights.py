"""The weights of a run, made from its seed on its device in one draw:
every parameter of a ``param_spec`` from one ``torch.randn`` of a
generator on that device, split and scaled by kind. Conv weights are He
normal (std sqrt(2 / (taps x out channels)), the reference's initialiser);
biases N(0, 0.01^2); BatchNorm scales 1 + N(0, 0.1^2) and shifts
N(0, 0.1^2), so that every parameter enters the result. The same dict goes
to the program (``load_state_dict``) and to the reference.
"""

from __future__ import annotations

import math

import torch


def make(spec: list, seed: int, device) -> dict:
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    sizes = [math.prod(shape) for _, shape, _ in spec]
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    out = {}
    for (name, shape, kind), x in zip(spec, flat.split(sizes)):
        x = x.view(shape)
        if kind in ("conv", "deconv"):
            out_ch = shape[1] if kind == "deconv" else shape[0]
            x = x * math.sqrt(2.0 / (math.prod(shape[2:]) * out_ch))
        elif kind == "bias":
            x = x * 0.01
        elif kind == "bn_weight":
            x = 1.0 + 0.1 * x
        elif kind == "bn_bias":
            x = 0.1 * x
        else:
            raise ValueError(f"unknown parameter kind {kind!r}")
        out[name] = x.contiguous()
    return out
