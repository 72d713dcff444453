"""The port's host-side tools and the packing flags, against the JAX
package's.

- ``infer/avi.py`` (a copy): JAX's ``tests/test_avi.py`` on the port's
  functions (round trip, container invariants, the norm modes, mixed
  sizes), and ``results_to_avi`` on a port CLI's output directory, byte
  for byte JAX's on the same directory.
- ``data/sens_writer.py`` and ``cli/decode_sens.py`` (copies): JAX's
  ``tests/test_sensreader.py`` round trip through the port's writer, the
  port's CLI on its ``DEFAULT_BIN`` (the shared ``native/sensreader``
  binary, built by ``make`` as JAX's fixture builds it, skipped only if
  the build fails) and the port's ScanNet loader; the files the JAX
  writer writes, byte for byte; the decoder's failure path.
- ``utils/profiler.py``: ``trace`` writes a Chrome trace holding a
  ``span``'s region (the spans themselves: ``test_torch_spans.py``).
- ``paired_knet`` / ``packed_fe``: JAX's step with each flag on (its TPU
  lane packings, run on the CPU) against the port's step with the same
  flag (the plain modules), within JAX's own flag-vs-native tolerance
  (``tests/test_knet_paired.py``, ``tests/test_fe_packed.py``: rtol and
  atol 1e-3 on depth and the carry), with a valid carry so that the
  K-Net runs; the port's rollout with the flags equals it without them.
"""

import json
import os
import struct
import subprocess

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from neuralrgbd_tpu.data.sens_writer import write_sens as jwrite_sens
from neuralrgbd_tpu.infer.avi import results_to_avi as jresults_to_avi
from neuralrgbd_tpu.infer.step import make_infer_step as jmake_infer_step
from neuralrgbd_tpu.data.synthetic import synthetic_batch as jsynthetic_batch

from neuralrgbd_tpu_torch.cli import decode_sens
from neuralrgbd_tpu_torch.cli.test_kvnet import main as port_cli
from neuralrgbd_tpu_torch.data.scannet import make_trajectory, read_info_txt
from neuralrgbd_tpu_torch.data.sens_writer import jpeg_bytes, write_sens
from neuralrgbd_tpu_torch.data.synthetic import write_scannet_scene
from neuralrgbd_tpu_torch.infer.avi import (read_avi_mjpeg, results_to_avi,
                                            write_avi, write_video)
from neuralrgbd_tpu_torch.infer.rollout import make_rollout
from neuralrgbd_tpu_torch.infer.step import make_infer_step
from neuralrgbd_tpu_torch.models.kvnet import KVNet
from neuralrgbd_tpu_torch.utils import profiler
from neuralrgbd_tpu_torch.utils.profiler import trace

from tests.test_torch_rollout import IMG_HW, _frames, weights  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NATIVE_DIR = os.path.join(REPO, "native", "sensreader")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch CPU thread for this module's tests (the suite runs files
    in parallel worker processes), the caller's count restored."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------------ avi

def _frames_u8(n=6, h=48, w=64):
    fs = []
    for i in range(n):
        y, x = np.mgrid[0:h, 0:w]
        f = ((y * 3 + x * 2 + i * 17) % 256).astype(np.uint8)
        fs.append(np.repeat(f[..., None], 3, axis=-1))
    return fs


def test_avi_roundtrip(tmp_path):
    path = str(tmp_path / "t.avi")
    frames = _frames_u8()
    assert write_avi(frames, path, fps=15) == 6
    out, fps = read_avi_mjpeg(path)
    assert fps == 15 and len(out) == 6
    for a, b in zip(out, frames):
        assert a.shape == b.shape
        assert np.abs(a.astype(float) - b.astype(float)).mean() < 3.0  # JPEG
    data = open(path, "rb").read()
    assert data[:4] == b"RIFF" and data[8:12] == b"AVI "
    assert len(data) == 8 + struct.unpack("<I", data[4:8])[0]
    assert b"idx1" in data and b"MJPG" in data and b"vids" in data


def test_avi_write_video_norm_modes(tmp_path):
    floats = [np.full((16, 16), 2.0), np.full((16, 16), 4.0)]
    p0 = str(tmp_path / "m0.avi")
    write_video(floats, p0, norm_m=0, max_v=4.0)
    out, _ = read_avi_mjpeg(p0)
    assert abs(int(np.asarray(out[0]).mean()) - 127) < 8
    assert int(np.asarray(out[1]).mean()) > 245
    p1 = str(tmp_path / "m1.avi")
    write_video(floats, p1, norm_m=1)
    out, _ = read_avi_mjpeg(p1)
    assert all(int(np.asarray(f).mean()) > 245 for f in out)
    with pytest.raises(ValueError):
        write_avi([np.zeros((8, 8, 3), np.uint8),
                   np.zeros((9, 8, 3), np.uint8)], str(tmp_path / "x.avi"))


def test_results_to_avi_on_a_port_cli_run(tmp_path):
    """The port's CLI on a 10-frame scene at 96x64 (random weights), then
    ``results_to_avi`` on its output directory: 5 frames at 15 fps of the
    exported depth maps, the file byte for byte JAX's."""
    write_scannet_scene(str(tmp_path / "scenes"), n_frames=10)
    port_cli(["--dataset", "scannet", "--dataset_path",
              str(tmp_path / "scenes"), "--ndepth", "8", "--feature_dim",
              "16", "--d_min", "0.5", "--d_max", "4.0", "--img_width", "96",
              "--img_height", "64", "--res_dir", str(tmp_path / "res"),
              "--exp_name", "t", "--device", "cpu"])
    res = str(tmp_path / "res" / "t_0")
    assert results_to_avi(res, str(tmp_path / "port.avi")) == 5
    assert jresults_to_avi(res, str(tmp_path / "jax.avi")) == 5
    out, fps = read_avi_mjpeg(str(tmp_path / "port.avi"))
    assert fps == 15 and len(out) == 5 and out[0].shape[:2] == (64, 96)
    assert (tmp_path / "port.avi").read_bytes() == \
        (tmp_path / "jax.avi").read_bytes()
    with pytest.raises(FileNotFoundError):
        results_to_avi(str(tmp_path), str(tmp_path / "none.avi"))


# ------------------------------------------------------------ .sens

@pytest.fixture(scope="module")
def sens_binary():
    binp = os.path.join(NATIVE_DIR, "sens_decode")
    r = subprocess.run(["make", "-C", NATIVE_DIR], capture_output=True,
                       text=True)
    if r.returncode != 0 or not os.path.exists(binp):
        pytest.skip(f"cannot build sens_decode: {r.stderr[-300:]}")
    return binp


def _sens_inputs():
    rng = np.random.RandomState(0)
    W, H, n = 64, 48, 11
    K = np.eye(4)
    K[0, 0] = K[1, 1] = 60.0
    K[0, 2], K[1, 2] = 32.2, 23.8
    colors, depths, poses = [], [], []
    for i in range(n):
        colors.append(jpeg_bytes((rng.rand(H, W, 3) * 255).astype(np.uint8)))
        depths.append((1000 + 50 * i + np.zeros((H, W))).astype(np.uint16))
        p = np.eye(4, dtype=np.float32)
        p[0, 3] = 0.1 * i
        poses.append(p)
    return (colors, depths, poses, K), dict(color_wh=(W, H), depth_wh=(W, H))


def test_decode_sens_default_bin_is_the_shared_binary():
    assert os.path.realpath(decode_sens.DEFAULT_BIN) == os.path.realpath(
        os.path.join(NATIVE_DIR, "sens_decode"))


def test_sens_roundtrip_through_the_port(sens_binary, tmp_path, capsys):
    args, kw = _sens_inputs()
    W, H = kw["color_wh"]
    root = tmp_path / "sens"
    root.mkdir()
    write_sens(str(root / "scene0000_00.sens"), *args, **kw)
    jwrite_sens(str(tmp_path / "jax.sens"), *args, **kw)
    assert (root / "scene0000_00.sens").read_bytes() == \
        (tmp_path / "jax.sens").read_bytes()

    out_root = tmp_path / "decoded"
    decode_sens.main(["--sens_root", str(root), "--out_root", str(out_root),
                      "--jobs", "1"])
    assert "decoded 1/1 scenes" in capsys.readouterr().out
    out = out_root / "scene0000_00"
    files = sorted(os.listdir(out))
    assert "_info.txt" in files and "frame-000001.color.jpg" not in files
    for i in (0, 5, 10):
        for suffix in ("color.jpg", "depth.pgm", "pose.txt"):
            assert f"frame-{i:06d}.{suffix}" in files

    K_parsed, (w, h) = read_info_txt(str(out / "_info.txt"))
    np.testing.assert_allclose(K_parsed[0, 0], 60.0)
    assert (w, h) == (W, H)
    d_candi = np.linspace(0.5, 4.0, 8).astype(np.float32)
    traj = make_trajectory(0, 5, str(out_root), img_size_wh=(W, H),
                           d_candi=d_candi)
    assert len(traj) == 3
    rec = traj.frame(1)  # original frame 5
    np.testing.assert_allclose(rec.dmap.mean(), 1.25, atol=1e-3)  # 1250 mm
    np.testing.assert_allclose(rec.ext_M[0, 3], -0.5, atol=1e-5)  # inv pose
    assert rec.img.shape == (H, W, 3)


def test_decode_sens_failure_paths(sens_binary, tmp_path, capsys):
    bad = tmp_path / "bad"
    bad.mkdir()
    with open(bad / "scene0009_00.sens", "wb") as f:
        f.write(b"\x07\x00\x00\x00garbage")
    decode_sens.main(["--sens_root", str(bad), "--out_root",
                      str(tmp_path / "o"), "--jobs", "1"])
    out = capsys.readouterr().out
    assert "scene0009_00: FAILED(1)" in out and "decoded 0/1" in out
    with pytest.raises(SystemExit, match="no .sens files"):
        decode_sens.main(["--sens_root", str(tmp_path / "o"), "--out_root",
                          str(tmp_path / "o2")])


# --------------------------------------------------------------- profiler

def test_trace_writes_a_chrome_trace_with_the_region(tmp_path):
    profiler.enable()
    try:
        with trace(str(tmp_path)) as prof:
            with profiler.span("kvnet_region"):
                torch.randn(64, 64) @ torch.randn(64, 64)
    finally:
        profiler.take()
    names = [p for p in os.listdir(tmp_path) if p.endswith(".pt.trace.json")]
    assert len(names) == 1
    with open(tmp_path / names[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "kvnet_region" for e in events)
    assert "kvnet_region" in [e.key for e in prof.key_averages()]


# ------------------------------------------------------- packing flags

@pytest.mark.parametrize("flag", ["paired_knet", "packed_fe"])
def test_packing_flags_match_jax(weights, flag):  # noqa: F811
    variables, model = weights
    cfg = model.cfg
    batch = {k: v for k, v in jsynthetic_batch(cfg, n_lanes=1, img_hw=IMG_HW,
                                               seed=2, baseline=0.08)[0]
             .items() if k in ("ref", "srcs", "poses", "K", "pose_next")}
    h, w = IMG_HW[0] // 4, IMG_HW[1] // 4
    rng = np.random.RandomState(4)
    bvp = np.log(np.asarray(torch.softmax(torch.from_numpy(rng.randn(
        1, cfg.ndepth, h, w).astype(np.float32)), 1)))
    jout = jmake_infer_step(cfg, fast_sweep=False, **{flag: True})(
        variables, {k: jnp.asarray(v) for k, v in batch.items()},
        jnp.asarray(bvp), jnp.ones((1,), bool))
    port = KVNet(model.cfg, device="cpu", single_refine=True, **{flag: True})
    port.load_state_dict(model.state_dict(), strict=True)
    assert getattr(port, flag)
    out = make_infer_step(cfg, **{flag: True})(
        port, {k: torch.from_numpy(v) for k, v in batch.items()},
        torch.from_numpy(bvp), [True])
    for got, want in ((out.depth, jout.depth),
                      (out.bv_predict, jout.bv_predict)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-3,
                                   atol=1e-3)

    frames = {k: torch.from_numpy(v) for k, v in _frames().items()}
    bv0 = torch.from_numpy(bvp)
    plain = make_rollout(cfg)(model, frames, bv0, [True])
    flagged = make_rollout(cfg, **{flag: True})(port, frames, bv0, [True])
    for a, b in zip(flagged, plain):
        assert torch.equal(a, b)
