"""Photometric augmentation (reference: utils/preprocess.py:93-185).

The reference ships an AlexNet-style PCA lighting + grayscale/saturation/
brightness/contrast ColorJitter suite but never imports it into its train
loop. Re-implemented here in numpy over (H, W, 3) float images in [0, 1]
(the reference's tensor ops, channels-last). NOTE: random per-frame
photometric jitter breaks the multi-view photoconsistency the plane-sweep
volume measures — if enabled for training, draw ONE parameter set per
trajectory window (pass the same rng state for all frames of a window),
which is why these are pure functions of an explicit ``rng``.

Copy of ``neuralrgbd_tpu/data/augment.py`` (the port imports nothing of the JAX
package); ``tests/test_torch_standalone.py`` holds it equal to the original.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

# ImageNet PCA eigen-decomposition (the standard AlexNet values the
# reference's get_transform uses, utils/preprocess.py:14-22)
IMAGENET_PCA_EIGVAL = np.array([0.2175, 0.0188, 0.0045], np.float32)
IMAGENET_PCA_EIGVEC = np.array(
    [[-0.5675, 0.7192, 0.4009],
     [-0.5808, -0.0045, -0.8140],
     [-0.5836, -0.6948, 0.4203]], np.float32)


def lighting(img: np.ndarray, rng: np.random.RandomState,
             alphastd: float = 0.1,
             eigval: np.ndarray = IMAGENET_PCA_EIGVAL,
             eigvec: np.ndarray = IMAGENET_PCA_EIGVEC) -> np.ndarray:
    """PCA lighting noise (preprocess.py:93-111)."""
    if alphastd == 0:
        return img
    alpha = rng.normal(0, alphastd, size=3).astype(np.float32)
    rgb = (eigvec * alpha[None, :] * eigval[None, :]).sum(axis=1)
    return img + rgb[None, None, :]


def grayscale(img: np.ndarray) -> np.ndarray:
    """ITU-R 601 luma, replicated to 3 channels (preprocess.py:114-121)."""
    gs = img[..., 0] * 0.299 + img[..., 1] * 0.587 + img[..., 2] * 0.114
    return np.repeat(gs[..., None], 3, axis=-1)


def _lerp(a: np.ndarray, b: np.ndarray, t: float) -> np.ndarray:
    return a + (b - a) * t


def saturation(img: np.ndarray, rng: np.random.RandomState,
               var: float) -> np.ndarray:
    return _lerp(img, grayscale(img), rng.uniform(0, var))


def brightness(img: np.ndarray, rng: np.random.RandomState,
               var: float) -> np.ndarray:
    return _lerp(img, np.zeros_like(img), rng.uniform(0, var))


def contrast(img: np.ndarray, rng: np.random.RandomState,
             var: float) -> np.ndarray:
    gs = grayscale(img)
    return _lerp(img, np.full_like(img, gs.mean()), rng.uniform(0, var))


def make_window_augment(seed: int, alphastd: float = 0.1,
                        jitter_var: float = 0.4):
    """One photoconsistent augmentation: FrameRecord -> normalized image.

    Re-seeds a fresh RandomState per application, so every frame the
    returned function touches gets the IDENTICAL jitter + lighting draw —
    the window-consistency requirement from the module docstring (the
    plane-sweep cost volume compares frames against each other). Pipeline
    order matches the reference's inception_color_preproccess
    (utils/preprocess.py:67-77): ColorJitter -> Lighting -> Normalize.
    """
    from neuralrgbd_tpu_torch.data import preprocess as pp

    def apply(rec) -> np.ndarray:
        img01 = rec.img_raw.astype(np.float32) / 255.0
        r = np.random.RandomState(seed)
        img01 = color_jitter(img01, r, jitter_var, jitter_var, jitter_var)
        img01 = lighting(img01, r, alphastd)
        return ((img01 - pp.IMAGENET_MEAN) / pp.IMAGENET_STD).astype(
            np.float32)

    return apply


def color_jitter(img: np.ndarray, rng: np.random.RandomState,
                 brightness_var: float = 0.4, contrast_var: float = 0.4,
                 saturation_var: float = 0.4,
                 order: Optional[Sequence[int]] = None) -> np.ndarray:
    """Random-order brightness/contrast/saturation (preprocess.py:158-185).

    ``order`` pins the permutation (pass the same order + rng draws for
    every frame of a window to keep photoconsistency)."""
    ops = []
    if brightness_var:
        ops.append(lambda x, r: brightness(x, r, brightness_var))
    if contrast_var:
        ops.append(lambda x, r: contrast(x, r, contrast_var))
    if saturation_var:
        ops.append(lambda x, r: saturation(x, r, saturation_var))
    idxs = rng.permutation(len(ops)) if order is None else order
    for i in idxs:
        img = ops[i](img, rng)
    return img
