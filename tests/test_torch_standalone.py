"""The port stands alone: it imports nothing of JAX or of the JAX package,
its copies of the JAX package's numpy-only code equal the originals, and
its model is built on the card unless the caller asks for the CPU.

- ``neuralrgbd_tpu_torch.config.ModelConfig``: the same fields and defaults
  (``dataclasses.asdict``) and the same properties, at the defaults and at
  a test configuration; ``TrainConfig`` the same way;
- ``neuralrgbd_tpu_torch.data.synthetic.synthetic_batch``: array for array
  equal to the original at two seeds;
- ``neuralrgbd_tpu_torch.utils.torch_import.build_name_map``: dict-equal
  for the 'DPV' and 'DGF' heads;
- the data layer and export: ``ops.camera.rescale_K`` and
  ``intrinsics_for_size``; ``data.preprocess`` on one image and one depth
  file; the scene writers of ``data.synthetic``, byte for byte on 4-frame
  scenes, and ``synthetic_dataset``; ``data.scannet``'s parsers (with the
  nan and missing-file poses), ``data.sevenscenes`` and the
  ``Trajectory``/``window_batch`` arrays; ``infer.export``'s files;
  ``infer.metrics``; ``infer.loop.resolve_cache_features``' four cases;
- the training data and logging: ``data.batch_loader``'s groups, offsets
  and batches (plain and augmented), ``data.augment``'s functions, and
  ``utils.logging``'s files (``save_args``, ``Tee``, ``MetricsWriter``);
  ``data.kitti``: ``tests/test_torch_kitti.py``;
- the pose-free pipeline's copies: ``pose.dso`` equal to the original
  file, and ``data.mdata`` equal to it but for the import of the port's
  own ``data.trajectory`` (their behaviour against the originals:
  ``tests/test_torch_lba.py``);
- hygiene: no ``.py`` file of the port, nor ``chip_smoke.py``, imports
  ``jax``, ``flax`` or ``neuralrgbd_tpu`` (checked on the syntax tree), and
  importing every port module leaves ``jax`` and ``neuralrgbd_tpu`` out of
  ``sys.modules``.
"""

import ast
import dataclasses
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import neuralrgbd_tpu.data.augment as jaugment
import neuralrgbd_tpu.data.batch_loader as jbatch_loader
import neuralrgbd_tpu.data.preprocess as jpp
import neuralrgbd_tpu.data.scannet as jscannet
import neuralrgbd_tpu.data.sevenscenes as jsevenscenes
import neuralrgbd_tpu.data.synthetic as jsynthetic
import neuralrgbd_tpu.infer.export as jexport
import neuralrgbd_tpu.infer.loop as jloop
import neuralrgbd_tpu.infer.metrics as jmetrics
import neuralrgbd_tpu.ops.camera as jcamera
import neuralrgbd_tpu.utils.logging as jlogging
from neuralrgbd_tpu.config import ModelConfig as JModelConfig
from neuralrgbd_tpu.config import TrainConfig as JTrainConfig
from neuralrgbd_tpu.data.synthetic import synthetic_batch as jsynthetic_batch
from neuralrgbd_tpu.data.trajectory import window_batch as jwindow_batch
from neuralrgbd_tpu.utils.torch_import import build_name_map as jbuild_name_map

import neuralrgbd_tpu_torch.data.augment as augment
import neuralrgbd_tpu_torch.data.batch_loader as batch_loader
import neuralrgbd_tpu_torch.data.preprocess as pp
import neuralrgbd_tpu_torch.data.scannet as scannet
import neuralrgbd_tpu_torch.data.sevenscenes as sevenscenes
import neuralrgbd_tpu_torch.data.synthetic as synthetic
import neuralrgbd_tpu_torch.infer.export as export
import neuralrgbd_tpu_torch.infer.metrics as metrics
import neuralrgbd_tpu_torch.ops.camera as camera
import neuralrgbd_tpu_torch.utils.logging as logging_
from neuralrgbd_tpu_torch.config import ModelConfig, TrainConfig
from neuralrgbd_tpu_torch.data.synthetic import synthetic_batch
from neuralrgbd_tpu_torch.data.trajectory import window_batch
from neuralrgbd_tpu_torch.infer.loop import resolve_cache_features
from neuralrgbd_tpu_torch.models.kvnet import KVNet
from neuralrgbd_tpu_torch.utils.torch_import import build_name_map

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((REPO / "neuralrgbd_tpu_torch").rglob("*.py"))
SMALL = dict(feature_dim=16, kv_feature_dim=16, ndepth=8, d_min=0.5,
             d_max=4.0, t_win_r=1)
PROPERTIES = ("d_candi", "d_candi_up4", "n_views", "kvnet_in_channels")


@pytest.mark.parametrize("fields", [{}, SMALL], ids=["defaults", "small"])
def test_model_config_copy_equals_original(fields):
    got, want = ModelConfig(**fields), JModelConfig(**fields)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    for name in PROPERTIES:
        a, b = getattr(got, name), getattr(want, name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b, err_msg=name)
        else:
            assert a == b, name


@pytest.mark.parametrize("fields", [
    {}, dict(lr=3e-4, lr_schedule="cosine", lr_decay_steps=50,
             lr_warmup_steps=5, grad_clip_max=2.0, loss_type="L1")],
    ids=["defaults", "custom"])
def test_train_config_copy_equals_original(fields):
    assert dataclasses.asdict(TrainConfig(**fields)) == dataclasses.asdict(
        JTrainConfig(**fields))


@pytest.mark.parametrize("seed", [0, 7])
def test_synthetic_batch_copy_equals_original(seed):
    kw = dict(n_lanes=2, img_hw=(32, 48), seed=seed, baseline=0.08)
    got, got_K = synthetic_batch(ModelConfig(**SMALL), **kw)
    want, want_K = jsynthetic_batch(JModelConfig(**SMALL), **kw)
    np.testing.assert_array_equal(got_K, want_K)
    assert got.keys() == want.keys()
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


@pytest.mark.parametrize("refine_net", ["DPV", "DGF"])
def test_build_name_map_copy_equals_original(refine_net):
    assert build_name_map(refine_net) == jbuild_name_map(refine_net)


def assert_trees_equal(got, want, where=""):
    """Equal values, dtypes and structure (dicts, sequences, dataclasses,
    arrays)."""
    if dataclasses.is_dataclass(want):
        want, got = dataclasses.asdict(want), dataclasses.asdict(got)
    if isinstance(want, dict):
        assert got.keys() == want.keys(), where
        for k in want:
            assert_trees_equal(got[k], want[k], f"{where}/{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), where
        for i, (a, b) in enumerate(zip(got, want)):
            assert_trees_equal(a, b, f"{where}[{i}]")
    elif isinstance(want, np.ndarray) or isinstance(got, np.ndarray):
        assert got.dtype == want.dtype, where
        np.testing.assert_array_equal(got, want, err_msg=where)
    else:
        assert got == want or (got != got and want != want), where


def assert_dirs_equal(got: pathlib.Path, want: pathlib.Path):
    """The same relative file names, byte for byte."""
    names = sorted(p.relative_to(want) for p in want.rglob("*") if p.is_file())
    assert names and names == sorted(
        p.relative_to(got) for p in got.rglob("*") if p.is_file())
    for name in names:
        assert (got / name).read_bytes() == (want / name).read_bytes(), name


K_OFF = np.array([[585.0, 0, 323.7], [0, 585.0, 237.9], [0, 0, 1]])


@pytest.mark.parametrize("new_wh", [(384, 256), (96, 64), (24, 16)])
def test_rescale_K_copy_equals_original(new_wh):
    got = camera.rescale_K(K_OFF, (640, 480), new_wh)
    want = jcamera.rescale_K(K_OFF, (640, 480), new_wh)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_intrinsics_for_size_copy_equals_original():
    got = camera.intrinsics_for_size(K_OFF, (640, 480), (384, 256), 0.25)
    want = jcamera.intrinsics_for_size(K_OFF, (640, 480), (384, 256), 0.25)
    for g, w in zip(got, want):
        assert isinstance(g, camera.Camera)
        np.testing.assert_array_equal(g.K.numpy(), np.asarray(w.K))


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """A 10-frame write_scannet_scene (the JAX e2e test's) and a 7-Scenes
    layout of 6 frames made from it (png colour, 16-bit png depth with
    65535 holes, one pose file missing and one nan)."""
    import PIL.Image

    root = tmp_path_factory.mktemp("scannet")
    jsynthetic.write_scannet_scene(str(root), n_frames=10)
    seq = tmp_path_factory.mktemp("7scenes") / "chess" / "seq-01"
    seq.mkdir(parents=True)
    src = root / "scene0000_00"
    for i in range(6):
        stem = f"frame-{i:06d}"
        PIL.Image.open(src / f"frame-{5 * i:06d}.color.jpg").save(
            seq / f"{stem}.color.png")
        depth = np.asarray(PIL.Image.open(src / f"frame-{5 * i:06d}.depth.pgm"))
        depth = np.where(depth > 2900, 65535, depth).astype(np.uint16)
        PIL.Image.fromarray(depth).save(seq / f"{stem}.depth.png")
        if i != 4:
            pose = (src / f"frame-{5 * i:06d}.pose.txt").read_text()
            (seq / f"{stem}.pose.txt").write_text(
                pose if i != 2 else pose.replace("1.0000000", "nan", 1))
    return root, seq.parent.parent


def test_preprocess_copy_equals_original(scene):
    root = scene[0] / "scene0000_00"
    img, dep = str(root / "frame-000005.color.jpg"), str(
        root / "frame-000005.depth.pgm")
    for name in ("IMAGENET_MEAN", "IMAGENET_STD"):
        assert_trees_equal(getattr(pp, name), getattr(jpp, name), name)
    for size in (None, (96, 64)):
        assert_trees_equal(pp.load_image(img, size), jpp.load_image(img, size))
        assert_trees_equal(pp.load_image(img, size, normalize=False),
                           jpp.load_image(img, size, normalize=False))
    assert_trees_equal(pp.load_raw(img, (96, 64), crop_w=64),
                       jpp.load_raw(img, (96, 64), crop_w=64))
    raw = jpp.load_raw(img, (96, 64))
    norm = jpp.load_image(img, (96, 64))[0]
    assert_trees_equal(pp.unnormalize_image(norm), jpp.unnormalize_image(norm))
    d = jpp.load_depth(dep)
    assert_trees_equal(pp.load_depth(dep), d)
    assert_trees_equal(pp.load_depth(dep, 0.001, 2900),
                       jpp.load_depth(dep, 0.001, 2900))
    assert_trees_equal(pp.resize_nearest(d, (24, 16)),
                       jpp.resize_nearest(d, (24, 16)))
    d_candi = np.linspace(0.5, 4.0, 8).astype(np.float32)
    assert_trees_equal(pp.digitize_depth(d, d_candi),
                       jpp.digitize_depth(d, d_candi))
    assert_trees_equal(pp.apply_invalid_mask(d, d < 1.0),
                       jpp.apply_invalid_mask(d, d < 1.0))
    assert raw.dtype == np.uint8


def test_scannet_parsers_copy_equal_original(scene, tmp_path):
    root = str(scene[0])
    assert_trees_equal(scannet.get_paths(0, 5, root),
                       jscannet.get_paths(0, 5, root))
    info = str(scene[0] / "scene0000_00" / "_info.txt")
    assert_trees_equal(scannet.read_info_txt(info),
                       jscannet.read_info_txt(info))
    bad = tmp_path / "bad.txt"
    bad.write_text("1 2 3\n")
    nan = tmp_path / "nan.txt"
    nan.write_text(" ".join(["nan"] * 16))
    for path in [scene[0] / "scene0000_00" / "frame-000010.pose.txt", nan,
                 bad, tmp_path / "missing.txt"]:
        assert_trees_equal(scannet.read_pose_txt(str(path)),
                           jscannet.read_pose_txt(str(path)), str(path))
    split = tmp_path / "split.txt"
    split.write_text("scene0000_00\n\n")
    assert_trees_equal(scannet.read_split_file(str(split)),
                       jscannet.read_split_file(str(split)))
    assert scannet.n_trajectories(root) == jscannet.n_trajectories(root) == 1
    assert scannet.n_trajectories(root, str(split)) == 1
    for fn in (scannet.get_paths, jscannet.get_paths):
        with pytest.raises(IndexError):
            fn(1, 5, root)


def _trajectories(scene, kind):
    d_candi = np.linspace(0.5, 4.0, 8).astype(np.float32)
    if kind == "scannet":
        return [m.make_trajectory(0, 5, str(scene[0]), img_size_wh=(96, 64),
                                  d_candi=d_candi, up4_labels=True)
                for m in (scannet, jscannet)]
    return [m.make_trajectory(0, str(scene[1]), 1, img_size_wh=(96, 64),
                              d_candi=d_candi) for m in (sevenscenes,
                                                         jsevenscenes)]


@pytest.mark.parametrize("kind", ["scannet", "7scenes"])
def test_trajectory_and_window_batch_copy_equal_original(scene, kind):
    got, want = _trajectories(scene, kind)
    assert len(got) == len(want)
    for attr in ("img_paths", "dmap_paths", "K_orig", "orig_wh", "K_dpv",
                 "K_img", "dpv_size_wh", "d_candi_up4", "name"):
        assert_trees_equal(getattr(got, attr), getattr(want, attr), attr)
    for i in range(len(want)):
        assert got.frame(i).pose_valid == want.frame(i).pose_valid
        assert_trees_equal(got.frame(i), want.frame(i), f"frame {i}")
    for ref in range(2, len(want) - 3):
        assert_trees_equal(window_batch(got, ref, 2, with_labels=True),
                           jwindow_batch(want, ref, 2, with_labels=True),
                           f"window {ref}")
    assert sevenscenes.get_seq_dirs(str(scene[1])) == \
        jsevenscenes.get_seq_dirs(str(scene[1]))


@pytest.mark.parametrize("writer", ["write_scannet_scene", "write_plane_scene",
                                    "write_multiplane_scene",
                                    "write_curved_scene"])
def test_scene_writers_copy_equal_original(writer, tmp_path):
    kw = dict(n_frames=4, orig_wh=(160, 120))
    if writer == "write_scannet_scene":
        kw["invalid_pose_at"] = 2
    else:
        kw["scene_idx"] = 3
    getattr(synthetic, writer)(str(tmp_path / "port"), **kw)
    getattr(jsynthetic, writer)(str(tmp_path / "jax"), **kw)
    assert_dirs_equal(tmp_path / "port", tmp_path / "jax")


def test_synthetic_dataset_copy_equals_original(tmp_path):
    """The writers are held above; this holds the factory (its scenes are
    640x480, so it writes two frames of one)."""
    kw = dict(img_size_wh=(96, 64), n_scenes=1, n_frames=2)
    make, n = synthetic.synthetic_dataset(ModelConfig(**SMALL),
                                          root=str(tmp_path / "port"), **kw)
    jmake, jn = jsynthetic.synthetic_dataset(JModelConfig(**SMALL),
                                             root=str(tmp_path / "jax"), **kw)
    assert n == jn == 1
    assert_dirs_equal(tmp_path / "port", tmp_path / "jax")
    got, want = make(0), jmake(0)
    assert_trees_equal(got.K_dpv, want.K_dpv)
    assert_trees_equal(got.frame(1).img_raw, want.frame(1).img_raw)


def test_export_copy_equals_original(tmp_path):
    rng = np.random.RandomState(0)
    raw = rng.randint(0, 256, (16, 24, 3)).astype(np.uint8)
    depth = rng.uniform(0.1, 5.0, (16, 24)).astype(np.float32)
    conf = rng.uniform(0.0, 1.0, (16, 24)).astype(np.float32)
    rows = [["scene0000_00"], [0, "a/frame-000010.color.jpg"]]
    for mod, name in ((export, "port"), (jexport, "jax")):
        out = tmp_path / name
        mod.export_frame(str(out), 0, raw, depth, conf)
        mod.export_frame(str(out), 1, raw, (depth * 1000).astype(np.uint16),
                         (conf * 1000).astype(np.uint16))
        mod.save_scene_path_info(str(out / "scene_path_info.txt"), rows)
        mod.export_pfm(str(out / "d.pfm"), depth)
    assert_dirs_equal(tmp_path / "port", tmp_path / "jax")
    pgm = str(tmp_path / "port" / "d_00000.pgm")
    assert_trees_equal(export.read_pgm(pgm), jexport.read_pgm(pgm))
    pfm = str(tmp_path / "port" / "d.pfm")
    assert_trees_equal(export.read_pfm(pfm), jexport.read_pfm(pfm))


def test_metrics_copy_equal_original():
    rng = np.random.RandomState(0)
    acc, jacc = metrics.MetricAccumulator(), jmetrics.MetricAccumulator()
    for i in range(3):
        gt = rng.uniform(0.0, 5.0, (16, 24)).astype(np.float32)
        gt[:2] = 0.0
        pred = gt * rng.uniform(0.8, 1.25, gt.shape).astype(np.float32)
        kw = dict(d_min=0.5, d_max=4.0) if i else {}
        m = metrics.depth_metrics(pred, gt, **kw)
        assert_trees_equal(m, jmetrics.depth_metrics(pred, gt, **kw))
        acc.update(m)
        jacc.update(m)
    empty = metrics.depth_metrics(gt, np.zeros_like(gt))
    assert_trees_equal(empty, jmetrics.depth_metrics(gt, np.zeros_like(gt)))
    acc.update(empty)
    jacc.update(empty)
    assert_trees_equal(acc.result(), jacc.result())
    assert metrics.MetricAccumulator().result() == {}


@pytest.mark.parametrize("requested", [None, True, False])
@pytest.mark.parametrize("torch_imported", [False, True])
def test_resolve_cache_features_copy_equals_original(requested,
                                                     torch_imported):
    assert resolve_cache_features(requested, torch_imported) == \
        jloop.resolve_cache_features(requested, torch_imported)


def test_kvnet_builds_on_the_card_by_default():
    """No fallback to the CPU: without a card the default build raises."""
    cfg = ModelConfig(**SMALL)
    if torch.cuda.is_available():
        assert all(p.is_cuda for p in KVNet(cfg).parameters())
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            KVNet(cfg)
    assert all(p.device.type == "cpu"
               for p in KVNet(cfg, device="cpu").parameters())


def _imported_modules(path: pathlib.Path) -> list[str]:
    names = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names += [alias.name for alias in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module)
    return names


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "flax", "neuralrgbd_tpu")


@pytest.mark.parametrize(
    "path", PORT_FILES + [REPO / "chip_smoke.py"],
    ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_import_in_source(path):
    bad = [n for n in _imported_modules(path) if _forbidden(n)]
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def test_forbidden_names():
    assert _forbidden("neuralrgbd_tpu") and _forbidden("neuralrgbd_tpu.config")
    assert _forbidden("jax.numpy") and _forbidden("flax.linen")
    assert not _forbidden("neuralrgbd_tpu_torch.config")


def test_importing_the_port_loads_no_jax():
    mods = [".".join(p.relative_to(REPO).with_suffix("").parts)
            .removesuffix(".__init__") for p in PORT_FILES]
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'neuralrgbd_tpu'))\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=120)


@pytest.mark.parametrize("augmented", [False, True], ids=["plain", "augment"])
def test_batch_loader_copy_equals_original(scene, augmented):
    """Two epochs' worth of groups (3 trajectories in lanes of 2, the
    ragged one dropped): the order, the offsets, the lengths and the
    labelled batches of the first group's frames."""
    d_candi = np.linspace(0.5, 4.0, 8).astype(np.float32)

    def factory(mod):
        return lambda i: mod.make_trajectory(0, 5, str(scene[0]),
                                             img_size_wh=(96, 64),
                                             d_candi=d_candi)

    for seed in (0, 1):
        got = batch_loader.BatchScheduler(factory(scannet), 3, 2, seed=seed,
                                          augment=augmented)
        want = jbatch_loader.BatchScheduler(factory(jscannet), 3, 2,
                                            seed=seed, augment=augmented)
        assert len(got) == len(want) == 1 and got.groups == want.groups
        g, w = next(iter(got)), next(iter(want))
        assert (g.traj_len, g.offsets) == (w.traj_len, w.offsets)
        for t in (0, g.traj_len - 1):
            assert_trees_equal(g.frame_batch(t), w.frame_batch(t), f"t {t}")


def test_augment_copy_equals_original(scene):
    img = np.random.RandomState(0).rand(16, 24, 3).astype(np.float32)
    for name in ("lighting", "saturation", "brightness", "contrast"):
        args = (0.3,) if name != "lighting" else ()
        got = getattr(augment, name)(img, np.random.RandomState(1), *args)
        want = getattr(jaugment, name)(img, np.random.RandomState(1), *args)
        assert_trees_equal(got, want, name)
    assert_trees_equal(augment.grayscale(img), jaugment.grayscale(img))
    for order in (None, [2, 0, 1]):
        assert_trees_equal(
            augment.color_jitter(img, np.random.RandomState(2), order=order),
            jaugment.color_jitter(img, np.random.RandomState(2), order=order))
    for name in ("IMAGENET_PCA_EIGVAL", "IMAGENET_PCA_EIGVEC"):
        assert_trees_equal(getattr(augment, name), getattr(jaugment, name))
    traj = scannet.make_trajectory(0, 5, str(scene[0]), img_size_wh=(96, 64))
    rec = traj.frame(1)
    assert_trees_equal(augment.make_window_augment(7)(rec),
                       jaugment.make_window_augment(7)(rec))


def test_logging_copy_equals_original(tmp_path, capsys):
    args = TrainConfig(lr=2e-4)
    logging_.save_args(str(tmp_path / "port" / "a.txt"), args)
    jlogging.save_args(str(tmp_path / "jax" / "a.txt"), args)
    ns = {"b": 1, "a": "x"}
    logging_.save_args(str(tmp_path / "port" / "b.txt"), ns)
    jlogging.save_args(str(tmp_path / "jax" / "b.txt"), ns)
    assert_dirs_equal(tmp_path / "port", tmp_path / "jax")
    for mod, name in ((logging_, "port_tee"), (jlogging, "jax_tee")):
        tee = mod.Tee(str(tmp_path / name)).install()
        try:
            print("step 1 loss 2.5")
        finally:
            tee.uninstall()
        assert open(tee.path).read() == "step 1 loss 2.5\n"
    assert capsys.readouterr().out == "step 1 loss 2.5\n" * 2
    got = logging_.MetricsWriter(str(tmp_path / "port_tb"))
    want = jlogging.MetricsWriter(str(tmp_path / "jax_tb"))
    assert (got._w is None) == (want._w is None)
    for writer in (got, want):
        writer.scalar("data/train_error", 1.5, 1)
        writer.image("train/depth", np.ones((4, 6), np.float32), 1)
        writer.close()


@pytest.mark.parametrize("copy,original,imports", [
    ("neuralrgbd_tpu_torch/pose/dso.py", "neuralrgbd_tpu/pose/dso.py", ()),
    ("neuralrgbd_tpu_torch/data/mdata.py", "neuralrgbd_tpu/data/mdata.py",
     ("data.trajectory",))], ids=["pose.dso", "data.mdata"])
def test_pose_free_copies_equal_originals(copy, original, imports):
    """The copy's text is the original's, each named import of the JAX
    package pointed at the port's module of the same name."""
    want = (REPO / original).read_text()
    for name in imports:
        want = want.replace(f"from neuralrgbd_tpu.{name} ",
                            f"from neuralrgbd_tpu_torch.{name} ")
    assert (REPO / copy).read_text() == want
