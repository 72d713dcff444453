"""The train step's fixed-order backwards (``ops.sampling.
deterministic_backward``, the repair of ROADMAP C2): on the card the
backwards of ``F.grid_sample`` and bilinear ``F.interpolate`` add with
atomics in an order that changes run to run; inside the context the two
image gradients are summed in a fixed order instead. On the CPU they are
held against autograd through the plain calls:

- the forwards are the same calls: equal bit for bit;
- the image gradients within atol 1e-6 (``grid_sample``: the same tap
  weights, summed in another order) and rtol 1e-5 of the largest
  (``interpolate``: two matrix products instead of per-tap adds); the
  grid's gradient is torch's own, equal;
- the context restores the caller's setting, also when the body raises,
  and does nothing where no gradient is needed;
- the train step runs both backwards in fixed order.

The card's side (two runs bit for bit) is ``chip_smoke.py`` phase 19.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from neuralrgbd_tpu_torch.config import ModelConfig, TrainConfig
from neuralrgbd_tpu_torch.data.synthetic import synthetic_batch
from neuralrgbd_tpu_torch.models import layers
from neuralrgbd_tpu_torch.models.kvnet import KVNet
from neuralrgbd_tpu_torch.ops import sampling
from neuralrgbd_tpu_torch.train.loop import upload_batch
from neuralrgbd_tpu_torch.train.step import (create_train_state,
                                             make_train_step)


def _grads(fn, *inputs):
    xs = [x.clone().requires_grad_(True) for x in inputs]
    out = fn(*xs)
    out.backward(torch.from_numpy(np.random.RandomState(1).randn(
        *out.shape).astype(np.float32)))
    return out.detach(), [x.grad for x in xs]


@pytest.mark.parametrize("padding", ["zeros", "border"])
def test_grid_sample_fixed_order_matches_autograd(padding):
    rng = np.random.RandomState(0)
    img = torch.from_numpy(rng.randn(3, 11, 15, 5).astype(np.float32))
    coords = torch.from_numpy(np.stack(
        [rng.uniform(-2, 16, (3, 40, 6)), rng.uniform(-2, 12, (3, 40, 6))],
        -1).astype(np.float32))

    def fixed(i, c):
        with sampling.deterministic_backward():
            return sampling.grid_sample_2d(i, c, padding)

    want, (g_img, g_c) = _grads(
        lambda i, c: sampling.grid_sample_2d(i, c, padding), img, coords)
    got, (f_img, f_c) = _grads(fixed, img, coords)
    assert torch.equal(got, want)
    torch.testing.assert_close(f_img, g_img, rtol=0, atol=1e-6)
    assert torch.equal(f_c, g_c)


@pytest.mark.parametrize("shape,size", [((2, 4, 8, 12), (64, 96)),
                                        ((1, 3, 1, 1), (5, 7)),
                                        ((1, 2, 5, 7), (5, 7))])
def test_upsample_fixed_order_matches_autograd(shape, size):
    x = torch.from_numpy(np.random.RandomState(2).randn(*shape).astype(
        np.float32))

    def fixed(v):
        with sampling.deterministic_backward():
            return layers.upsample_bilinear_ac(v, size)

    want, (g,) = _grads(lambda v: layers.upsample_bilinear_ac(v, size), x)
    got, (f,) = _grads(fixed, x)
    assert torch.equal(got, want)
    torch.testing.assert_close(f, g, rtol=0,
                               atol=1e-5 * float(g.abs().max()))


def test_context_restores_and_needs_a_gradient():
    x = torch.zeros(2, requires_grad=True)
    assert not sampling.fixed_order_wanted(x)
    with pytest.raises(RuntimeError, match="inside"):
        with sampling.deterministic_backward():
            assert sampling.fixed_order_wanted(x)
            with torch.no_grad():
                assert not sampling.fixed_order_wanted(x)
            assert not sampling.fixed_order_wanted(x.detach())
            raise RuntimeError("inside")
    assert not sampling.fixed_order_wanted(x)


def test_train_step_uses_the_fixed_order_backwards(monkeypatch):
    calls = {"grid": 0, "upsample": 0}
    for name, cls in (("grid", sampling.GridSample2dFixedOrder),
                      ("upsample", layers.UpsampleBilinearFixedOrder)):
        real = cls.apply

        def counted(*a, _real=real, _name=name):
            calls[_name] += 1
            return _real(*a)
        monkeypatch.setattr(cls, "apply", counted)
    cfg = ModelConfig(feature_dim=16, kv_feature_dim=16, ndepth=8,
                      d_min=0.5, d_max=4.0)
    state = create_train_state(cfg, TrainConfig(lr=1e-4), model=KVNet(
        cfg, device="cpu", seed=0))
    batch, _ = synthetic_batch(cfg, n_lanes=1, img_hw=(64, 96), seed=0)
    del batch["dmap_up4_imgsize_digit"]
    carry = torch.full((1, 8, 16, 24), -float(np.log(8)))
    out = make_train_step(cfg, TrainConfig(lr=1e-4))(
        state, upload_batch(batch, torch.device("cpu")), carry, [True])
    assert bool(torch.isfinite(out.loss))
    # the sweep's warp once, the extractor's 4 pooled branches once
    assert calls == {"grid": 1, "upsample": 4}
    assert not sampling.fixed_order_wanted(
        torch.zeros(1, requires_grad=True))
