"""Checkpoint save and restore (counterpart of
``neuralrgbd_tpu/utils/checkpoint.py``, in the port's own format).

Reference contract (train_KVNet.py:339-348, utils/models.py:39-59):
periodic checkpoints carrying {iter, state_dict, optimizer, loss}, and a
filtered partial restore. Here each ``<base>/ckpt_{step:08d}/`` holds one
``torch.save`` file, ``state.pt``, of ``{"model": state_dict, "optimizer":
optimizer state_dict, "step": int, "extra": dict}`` (``extra``: the loop's
cursor), tensors on the CPU. The model's keys are the reference KVNET's
(``feature_extractor.*``, ``kv_net.*``, ``r_net.*``).

The JAX package writes orbax directories, which need orbax; the port
does not read them (``NotImplementedError``). ``convert_jax_checkpoint.py``
at the repository's root, run where the JAX package and orbax import,
turns one into this format: the weights, Adam's moments, the step and the
loop's cursor.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

FILE = "state.pt"


def _ckpt_dir(base: str, step: int) -> str:
    return os.path.join(os.path.abspath(base), f"ckpt_{step:08d}")


def _load(path: str) -> dict:
    """The payload of the checkpoint directory ``path``, on the CPU."""
    f = os.path.join(path, FILE)
    if not os.path.isfile(f):
        raise NotImplementedError(
            f"{path!r} holds no {FILE}: not a checkpoint of this port. For "
            f"an orbax checkpoint directory of the JAX package, run "
            f"convert_jax_checkpoint.py (where the JAX package and orbax "
            f"import) and give the port its output")
    # our own files: the payload holds tensors, ints and the loop's cursor
    return torch.load(f, map_location="cpu", weights_only=True)


def save_checkpoint(base_dir: str, step: int, state,
                    extra: Optional[dict] = None) -> str:
    """Save the model, the optimizer and the step (+ the loop's cursor in
    ``extra``) as ``<base_dir>/ckpt_{step:08d}/state.pt``; returns the
    directory. The file is written whole and then renamed into place."""
    path = _ckpt_dir(base_dir, step)
    os.makedirs(path, exist_ok=True)
    payload = {
        "model": {k: v.detach().cpu()
                  for k, v in state.model.state_dict().items()},
        "optimizer": state.optimizer.state_dict(),
        "step": int(state.step),
        "extra": dict(extra or {}),
    }
    tmp = os.path.join(path, FILE + ".tmp")
    torch.save(payload, tmp)
    os.replace(tmp, os.path.join(path, FILE))
    return path


def latest_checkpoint(base_dir: str) -> Optional[str]:
    if not os.path.isdir(base_dir):
        return None
    cands = sorted(d for d in os.listdir(base_dir) if d.startswith("ckpt_"))
    return os.path.join(os.path.abspath(base_dir), cands[-1]) if cands else None


def restore_checkpoint(path: str, state):
    """Restore the model, the optimizer and the step into ``state`` (a
    ``TrainState`` of the same model), in place; returns ``(state,
    extra)``. The model loads strictly; the optimizer's tensors move to
    the parameters' device."""
    payload = _load(path)
    state.model.load_state_dict(payload["model"], strict=True)
    state.optimizer.load_state_dict(payload["optimizer"])
    state.step = int(payload["step"])
    return state, payload.get("extra", {})


def restore_params_only(path: str, state):
    """Restore ONLY the model (+ the step, read from the directory's name)
    into ``state``, leaving the optimizer as it is: for consumers that do
    not train on, tolerant of an optimizer that changed between save and
    restore. Raises unless every tensor of the model was found with its
    shape."""
    _, n_hit = restore_params_partial(path, state.model)
    n_total = len(state.model.state_dict())
    if n_hit != n_total:
        raise ValueError(
            f"params-only restore from {path}: matched {n_hit}/{n_total} "
            "tensors: the checkpoint does not cover the model")
    tail = os.path.basename(os.path.normpath(path))
    state.step = int(tail.split("_")[-1]) if tail.startswith("ckpt_") else 0
    return state


@torch.no_grad()
def restore_params_partial(path: str, model: torch.nn.Module):
    """Filtered partial restore into ``model``, in place: every tensor of
    the model whose key the checkpoint has with the same shape takes the
    checkpoint's value; the others keep theirs (the semantics of
    ``load_pretrained_model``'s filtered state-dict load,
    utils/models.py:39-59). Each tensor is copied to the model's device
    once, here. Returns ``(model, n_hit)``."""
    loaded = _load(path)["model"]
    n_hit = 0
    for key, own in model.state_dict().items():
        val = loaded.get(key)
        if val is not None and tuple(val.shape) == tuple(own.shape):
            own.copy_(val)
            n_hit += 1
    return model, n_hit
