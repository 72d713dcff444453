"""The plain reference of the KV-Net (Neural RGB->D Sensing, CVPR 2019):
the D-Net's plane sweep, the K-Net's gain, the R-Net's refinement, the
depth and confidence maps and the DPV prediction carried from frame to
frame, in plain PyTorch (``F.conv*``, ``F.grid_sample``, ``F.batch_norm``)
and float32, one window at a time.

It is frozen: it imports nothing of the program under test and nothing of
JAX, and it reads the scene files itself (``benchmark/reference/scenes.py``).
Parameters come in as a dict of tensors under the reference KVNET's
state_dict names (``param_spec``), made by the benchmark from the seed.

``precision``: "fp32" runs every conv and matmul in float32 (TF32 off,
deterministic cuDNN); "tf32" is the control: on a card with cuDNN's and
cuBLAS's TF32 switches on; on the CPU, where TF32 does not exist, each conv's
input and weight rounded to TF32's 10-bit mantissa first (float32
accumulation), which is what the card's TF32 convs compute.

Departures from the reference network, each also the program's:
BatchNorm on batch statistics (``track_running_stats=False``), the
spatial-pyramid pools clamped to the feature map, the sweep's samples at
align_corners pixel coordinates with zero padding.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
import torch.nn.functional as F

POOLS = (64, 32, 16, 8)
# (name, inplanes, planes, blocks, stride, dilation)
FE_LAYERS = (("layer1", 32, 32, 3, 1, 1), ("layer2", 32, 64, 16, 2, 1),
             ("layer3", 64, 128, 3, 1, 1), ("layer4", 128, 128, 3, 1, 2))
FE = "feature_extractor.feature_extraction"
IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def param_spec(m: dict) -> list:
    """``[(name, shape, kind)]`` of every parameter of the KV-Net with the
    DPV R-Net (one refinement), in a fixed order; ``kind`` is "conv" (He
    normal over kernel taps x out channels), "deconv" (the same, out
    channels second), "bias", "bn_weight" or "bn_bias". ``m`` is a
    configuration's ``model`` section."""
    spec = []

    def conv(name, shape, kind="conv"):
        spec.append((f"{name}.weight", tuple(shape), kind))

    def bn(name, c):
        spec.append((f"{name}.weight", (c,), "bn_weight"))
        spec.append((f"{name}.bias", (c,), "bn_bias"))

    def convbn(name, cin, cout, k):
        conv(f"{name}.0", (cout, cin, k, k))
        bn(f"{name}.1", cout)

    F_, V = m["feature_dim"], 2 * m["t_win_r"]
    for i, cin in zip((0, 2, 4), (3, 32, 32)):
        convbn(f"{FE}.firstconv.{i}", cin, 32, 3)
    for name, inp, planes, blocks, stride, _ in FE_LAYERS:
        for b in range(blocks):
            cin = inp if b == 0 else planes
            convbn(f"{FE}.{name}.{b}.conv1.0", cin, planes, 3)
            convbn(f"{FE}.{name}.{b}.conv2", planes, planes, 3)
            if b == 0 and (stride != 1 or inp != planes):
                convbn(f"{FE}.{name}.{b}.downsample", inp, planes, 1)
    for i in range(len(POOLS)):
        convbn(f"{FE}.branch{i + 1}.1", 128, 32, 1)
    convbn(f"{FE}.lastconv.0", 320, 128, 3)
    conv(f"{FE}.lastconv.2", (F_, 128, 1, 1))

    f, cin = m["kv_feature_dim"], 3 * (V + 1) + 1
    for i in range(5):
        for j, c_in in ((0, cin if i == 0 else f), (2, f)):
            conv(f"kv_net.dres{i}.{j}.0", (f, c_in, 3, 3, 3))
            bn(f"kv_net.dres{i}.{j}.1", f)
    conv("kv_net.classify.0.0", (f, f, 3, 3, 3))
    bn("kv_net.classify.0.1", f)
    conv("kv_net.classify.2", (1, f, 3, 3, 3))

    D, c2 = m["ndepth"], m["refine_channel"]
    c0, c1, c2 = D + F_, D + 32, D + c2
    for name, cin, cout, deconv in (
            ("conv0", c0, c0, False), ("conv0_1", c0, c0, False),
            ("trans_conv0", c0, D, True), ("conv1", c1, c1, False),
            ("conv1_1", c1, c1, False), ("trans_conv1", c1, D, True),
            ("conv2", c2, c2, False), ("conv2_1", c2, D, False),
            ("conv2_2", D, D, False)):
        p = f"r_net.{name}" + ("" if name == "conv2_2" else ".0")
        if deconv:
            conv(p, (cin, cout, 4, 4), "deconv")
        else:
            conv(p, (cout, cin, 3, 3))
        spec.append((f"{p}.bias", (cout,), "bias"))
    return spec


def _round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10-bit mantissa (nearest, ties to even)."""
    bits = x.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    return ((bits + 0xFFF + lsb) & ~0x1FFF).view(torch.float32)


class Reference:
    """The KV-Net forward and the DPV prediction on ``device``."""

    def __init__(self, weights: dict, m: dict, device, precision="fp32"):
        if precision not in ("fp32", "tf32"):
            raise ValueError(f"unknown precision {precision!r}")
        self.w = {k: v.to(device=device, dtype=torch.float32)
                  for k, v in weights.items()}
        self.m, self.device = m, torch.device(device)
        self.precision = precision
        self.emulate = precision == "tf32" and self.device.type != "cuda"
        self.d_candi = torch.from_numpy(np.linspace(
            m["d_min"], m["d_max"], m["ndepth"]).astype(np.float32)).to(device)
        self._mean = torch.from_numpy(IMAGENET_MEAN).to(device)
        self._std = torch.from_numpy(IMAGENET_STD).to(device)
        self._255 = torch.tensor(255.0, device=device)

    # ---- layers ----
    def _c(self, x, w):
        return (_round_tf32(x), _round_tf32(w)) if self.emulate else (x, w)

    def conv2d(self, x, name, stride=1, pad=0, dil=1, bias=False):
        x, w = self._c(x, self.w[f"{name}.weight"])
        return F.conv2d(x, w, self.w[f"{name}.bias"] if bias else None,
                        stride, pad, dil)

    def deconv2d(self, x, name):
        x, w = self._c(x, self.w[f"{name}.weight"])
        return F.conv_transpose2d(x, w, self.w[f"{name}.bias"], 2, 1)

    def conv3d(self, x, name):
        x, w = self._c(x, self.w[f"{name}.weight"])
        return F.conv3d(x, w, None, 1, 1)

    def bn(self, x, name):
        return F.batch_norm(x, None, None, self.w[f"{name}.weight"],
                            self.w[f"{name}.bias"], True, 0.0, 1e-5)

    def convbn(self, x, name, stride, pad, dil=1):
        pad = dil if dil > 1 else pad
        return self.bn(self.conv2d(x, f"{name}.0", stride, pad, dil),
                       f"{name}.1")

    # ---- networks ----
    def features(self, x):
        """(B, 3, H, W) -> (layer1 (B, 32, H/2, W/2), feat (B, F, H/4, W/4)),
        BatchNorm over the B frames jointly."""
        for i, s in zip((0, 2, 4), (2, 1, 1)):
            x = F.relu(self.convbn(x, f"{FE}.firstconv.{i}", s, 1))
        outs = {}
        for name, inp, planes, blocks, stride, dil in FE_LAYERS:
            for b in range(blocks):
                p = f"{FE}.{name}.{b}"
                s = stride if b == 0 else 1
                out = F.relu(self.convbn(x, f"{p}.conv1.0", s, 1, dil))
                out = self.convbn(out, f"{p}.conv2", 1, 1, dil)
                if b == 0 and (stride != 1 or inp != planes):
                    x = self.convbn(x, f"{p}.downsample", s, 0)
                x = out + x
            outs[name] = x
        raw, skip = outs["layer2"], outs["layer4"]
        H, W = skip.shape[-2:]
        branches = []
        for i, pool in enumerate(POOLS):
            pool = min(pool, H, W)
            b = F.relu(self.convbn(F.avg_pool2d(skip, pool),
                                   f"{FE}.branch{i + 1}.1", 1, 0))
            branches.append(F.interpolate(b, size=(H, W), mode="bilinear",
                                          align_corners=True))
        feat = torch.cat([raw, skip, *branches[::-1]], 1)
        feat = F.relu(self.convbn(feat, f"{FE}.lastconv.0", 1, 1))
        return outs["layer1"], self.conv2d(feat, f"{FE}.lastconv.2")

    def knet(self, vol):
        """(1, C, D, h, w) -> the gain (D, h, w)."""
        def cbr(x, p, relu=True):
            y = self.bn(self.conv3d(x, f"{p}.0"), f"{p}.1")
            return F.relu(y) if relu else y
        cost = cbr(cbr(vol, "kv_net.dres0.0"), "kv_net.dres0.2")
        for i in range(1, 5):
            p = f"kv_net.dres{i}"
            cost = cbr(cbr(cost, f"{p}.0"), f"{p}.2", relu=False) + cost
        out = cbr(cost, "kv_net.classify.0")
        return self.conv3d(out, "kv_net.classify.2")[0, 0]

    def rnet(self, prob, feat_q, feat_h, img):
        def c(x, name):
            return F.leaky_relu(self.conv2d(x, f"r_net.{name}.0", 1, 1,
                                            bias=True))
        x = torch.cat([prob, feat_q], 1)
        x = F.leaky_relu(self.deconv2d(c(c(x, "conv0"), "conv0_1"),
                                       "r_net.trans_conv0.0"))
        x = torch.cat([x, feat_h], 1)
        x = F.leaky_relu(self.deconv2d(c(c(x, "conv1"), "conv1_1"),
                                       "r_net.trans_conv1.0"))
        x = torch.cat([x, img], 1)
        x = self.conv2d(c(c(x, "conv2"), "conv2_1"), "r_net.conv2_2", 1, 1,
                        bias=True)
        return F.log_softmax(x, 1)

    # ---- geometry ----
    @staticmethod
    def _rays(K, h, w):
        dev = K.device
        xs = torch.arange(w, dtype=torch.float32, device=dev) + 0.5
        ys = torch.arange(h, dtype=torch.float32, device=dev) + 0.5
        gy, gx = torch.meshgrid(ys, xs, indexing="ij")
        rx = (gx.reshape(-1) - K[0, 2]) / K[0, 0]
        ry = (gy.reshape(-1) - K[1, 2]) / K[1, 1]
        return torch.stack([rx, ry, torch.ones_like(rx)])

    def sweep(self, ref, srcs, Rs, ts, K):
        """ref (h, w, C), srcs (V, h, w, C) -> cost (D, h, w) and the warped
        last 3 channels (V, D, h, w, 3)."""
        V, h, w, C = srcs.shape
        d = self.d_candi
        rays = self._rays(K, h, w)
        p = ((K @ ts[..., None])[:, None] + (K @ Rs @ rays)[:, None]
             * d.reshape(-1, 1, 1))                          # (V, D, 3, hw)
        z = p[:, :, 2] + 1e-10
        px = p[:, :, 0] / z * ((w - 1) / 2.0) / K[0, 2]
        py = p[:, :, 1] / z * ((h - 1) / 2.0) / K[1, 2]
        g = torch.stack([px * (2.0 / (w - 1)) - 1.0,
                         py * (2.0 / (h - 1)) - 1.0], -1)    # (V, D, hw, 2)
        warped = F.grid_sample(srcs.permute(0, 3, 1, 2),
                               g.reshape(V, 1, -1, 2), mode="bilinear",
                               padding_mode="zeros", align_corners=True)
        warped = warped[:, :, 0].transpose(1, 2).reshape(V, -1, h * w, C)
        diff = warped - ref.reshape(1, 1, h * w, C)
        cost = ((diff * diff).sum(-1) / self.m["sigma_soft_max"]).sum(0)
        D = d.shape[0]
        return cost.reshape(D, h, w), warped[..., C - 3:].reshape(
            V, D, h, w, 3)

    def predict(self, dpv, pose_next, K):
        """The posterior (D, h, w) resampled into the next view's frustum:
        through the inverse of ``pose_next``, faces at log(1/D), border
        padding, clamped to [-1000, 0]."""
        D, h, w = dpv.shape
        d = self.d_candi
        rel = torch.linalg.inv(pose_next)
        rays = self._rays(K, h, w)
        pts = rays[None] * d.reshape(-1, 1, 1)
        p = torch.einsum("ij,djn->din", rel[:3, :3], pts) \
            + rel[:3, 3].reshape(1, 3, 1)
        z = p[:, 2] + 1e-10
        zmin, zmax = d.min(), d.max()
        gx = p[:, 0] / z / (K[0, 2] / K[0, 0])
        gy = p[:, 1] / z / (K[1, 2] / K[1, 1])
        gz = (p[:, 2] - (zmax + zmin) * 0.5) / ((zmax - zmin) * 0.5)
        pix = [(g + 1.0) * 0.5 * (s - 1) for g, s in ((gx, w), (gy, h),
                                                       (gz, D))]
        g = torch.stack([q * (2.0 / (s - 1)) - 1.0
                         for q, s in zip(pix, (w, h, D))], -1)
        vol = dpv.clone()
        pad = math.log(1.0 / D)
        vol[[0, -1]] = pad
        vol[:, [0, -1]] = pad
        vol[:, :, [0, -1]] = pad
        out = F.grid_sample(vol[None, None], g.reshape(1, 1, 1, -1, 3),
                            mode="bilinear", padding_mode="border",
                            align_corners=True).reshape(D, h, w)
        return out.clamp(-1000.0, 0.0)

    # ---- one window ----
    def normalize(self, u8: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(np.array(u8)).to(self.device)
        return (t.to(torch.float32) / self._255 - self._mean) / self._std

    def step(self, ref, srcs, poses, K, pose_next, carry):
        """One frame: ref (H, W, 3) and srcs (V, H, W, 3) normalized, poses
        (V, 4, 4) ref -> src, K (3, 3) at the DPV's size, pose_next (4, 4);
        ``carry`` the prediction (D, h, w) or None. Returns (depth (H, W)
        in metres, confidence (H, W), the next carry)."""
        V, H, W, _ = srcs.shape
        frames = torch.cat([srcs, ref[None]]).permute(0, 3, 1, 2)
        layer1, feat = self.features(frames.contiguous())
        h, w = feat.shape[-2:]
        ints = F.avg_pool2d(frames, W // w)
        sw = torch.cat([feat, ints], 1).permute(0, 2, 3, 1)
        cost, warped_rgb = self.sweep(sw[-1], sw[:-1], poses[:, :3, :3],
                                      poses[:, :3, 3], K)
        bv_cur = F.log_softmax(-cost, 0)
        if carry is None:
            dpv = bv_cur
        else:
            D = bv_cur.shape[0]
            vol = torch.cat([
                warped_rgb.permute(0, 4, 1, 2, 3).reshape(V * 3, D, h, w),
                ints[-1][:, None].expand(3, D, h, w),
                (bv_cur - carry)[None]])
            dpv = F.log_softmax(self.knet(vol[None]) + carry, 0)
        refined = self.rnet(dpv.exp()[None], feat[-1:], layer1[-1:],
                            frames[-1:])[0]
        depth = torch.einsum("dhw,d->hw", refined.exp(), self.d_candi)
        conf = refined.amax(0).exp()
        return depth, conf, self.predict(dpv, pose_next, K)

    def run(self, scene, frames=None):
        """Every reference frame of ``scene`` (``scenes.Scene``) in order,
        the prediction carried as the loop carries it (reset on a window
        with a non-finite pose): yields (frame number, depth mm, confidence
        x 1000, steps), the maps (H, W) uint16 numpy, quantized as the
        export is, and ``steps`` the frames the carry has run through,
        this one included (1 on a fresh start).
        ``frames``: stop after this many. Run it inside
        ``numerics(self.precision)``."""
        t = self.m["t_win_r"]
        n = len(scene.img_paths)
        decoded: dict = {}

        def img(i):
            if i not in decoded:
                decoded[i] = self.normalize(scene.load(i))
                for old in [k for k in decoded if k < i - 2 * t]:
                    del decoded[old]
            return decoded[i]

        K = torch.from_numpy(scene.K_dpv).to(self.device)
        carry, steps = None, 0
        with torch.no_grad():
            for cnt, r in enumerate(range(t, n - t - 1)):
                if frames is not None and cnt >= frames:
                    return
                idxs = ([r + i for i in range(-t, 0)]
                        + [r + i for i in range(1, t + 1)])
                if not all(np.isfinite(scene.exts[i]).all()
                           for i in (r, *idxs)):
                    carry, steps = None, 0
                    continue
                poses = np.stack([rel_pose(scene.exts[r], scene.exts[i])
                                  for i in idxs])
                nxt = rel_pose(scene.exts[r], scene.exts[min(r + 1, n - 1)])
                depth, conf, carry = self.step(
                    img(r), torch.stack([img(i) for i in idxs]),
                    torch.from_numpy(poses).to(self.device), K,
                    torch.from_numpy(nxt).to(self.device), carry)
                steps += 1
                yield cnt, quantize(depth), quantize(conf), steps


@contextlib.contextmanager
def numerics(precision: str):
    """The process's cuDNN and cuBLAS switches for a reference of
    ``precision`` (TF32 on only for "tf32"; cuDNN's algorithms
    deterministic), given back after the block. They are global: set them
    once around every reference of one precision, also those that run on
    several threads."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = cudnn.allow_tf32, matmul.allow_tf32, cudnn.deterministic
    cudnn.allow_tf32 = matmul.allow_tf32 = precision == "tf32"
    cudnn.deterministic = True
    try:
        yield
    finally:
        cudnn.allow_tf32, matmul.allow_tf32, cudnn.deterministic = saved


def rel_pose(ext_ref: np.ndarray, ext_src: np.ndarray) -> np.ndarray:
    """ext_src @ inv(ext_ref), float64 then float32."""
    return (ext_src @ np.linalg.inv(ext_ref)).astype(np.float32)


def quantize(x: torch.Tensor) -> np.ndarray:
    """The export's contract: (x * 1000) clamped to [0, 65535], truncated
    to uint16."""
    q = torch.clamp(x * 1000.0, 0.0, 65535.0).to(torch.int32)
    return q.cpu().numpy().astype(np.uint16)
