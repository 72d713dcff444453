"""The weight bridge from the JAX package to the port (counterpart of
``neuralrgbd_tpu/utils/torch_import.py``).

The JAX package imports the reference's torch state_dicts with
``build_name_map`` (torch key -> flax path) and ``_transform`` (torch ->
flax layout). ``state_dict_from_jax`` runs both backwards: from a flax
variables tree (numpy leaves) to a state_dict with the reference KVNET's
keys, which the port's ``KVNet`` loads with ``load_state_dict(strict=True)``,
for every head: the default DPV head (with ``refine_dup`` the same keys at
other shapes), DGF (``refine_net='DGF'``), ``refine_costv``'s ``d_net.*``
and ``dnet_bayes`` (no ``kv_net.*``). ``refine_head_state_dict_from_jax``
does the same for a standalone legacy head (``models/refine_legacy.py``)
with ``build_refine_head_map``'s bare keys.
``build_name_map``, ``build_refine_head_map`` and their two helpers are
copies of the JAX module's (``neuralrgbd_tpu/utils/torch_import.py:26-156``),
held equal to it by ``tests/test_torch_standalone.py``: the port imports
nothing of the JAX package. So are ``_strip_prefix`` and ``load_torch_checkpoint``, which
read the reference's released checkpoints (``kvnet_scannet.tar``);
``load_reference_state_dict`` loads one into the port's ``KVNet``.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch


def _convbn(torch_prefix: str, flax_prefix: str, dims: int = 2):
    """convbn/convbn_3d Sequential(conv, bn)."""
    return {
        f"{torch_prefix}.0.weight": (f"{flax_prefix}/conv/kernel",
                                     "conv3d" if dims == 3 else "conv2d"),
        f"{torch_prefix}.1.weight": (f"{flax_prefix}/bn/scale", "copy"),
        f"{torch_prefix}.1.bias": (f"{flax_prefix}/bn/bias", "copy"),
    }


def _conv_bias(torch_prefix: str, flax_prefix: str):
    return {
        f"{torch_prefix}.weight": (f"{flax_prefix}/kernel", "conv2d"),
        f"{torch_prefix}.bias": (f"{flax_prefix}/bias", "copy"),
    }


def build_name_map(refine_net: str = "DPV") -> dict[str, tuple[str, str]]:
    """torch state_dict key -> (flax path 'a/b/c/leaf', transform).

    ``refine_net`` selects the r_net section: 'DPV' (RefineNet_DPV_upsample)
    or 'DGF' (RefineNet_DGF, Refine.py:587-641)."""
    m: dict[str, tuple[str, str]] = {}

    # ---- feature extractor (psm_submodule.feature_extraction) ----
    fe_t = "feature_extractor.feature_extraction"
    fe_f = "feature_extractor"
    for i, j in ((0, 0), (2, 1), (4, 2)):
        m.update(_convbn(f"{fe_t}.firstconv.{i}", f"{fe_f}/first{j}"))

    layer_blocks = {"layer1": 3, "layer2": 16, "layer3": 3, "layer4": 3}
    for lname, nblocks in layer_blocks.items():
        for b in range(nblocks):
            t = f"{fe_t}.{lname}.{b}"
            f = f"{fe_f}/{lname}_{b}"
            # BasicBlock: conv1 = Sequential(convbn, ReLU) => conv1.0.*
            m.update(_convbn(f"{t}.conv1.0", f"{f}/conv1"))
            m.update(_convbn(f"{t}.conv2", f"{f}/conv2"))
            # downsample = Sequential(Conv2d, BN) on the first block when
            # stride/channels change (layer2_0, layer3_0)
            m[f"{t}.downsample.0.weight"] = (f"{f}/down_conv/kernel", "conv2d")
            m[f"{t}.downsample.1.weight"] = (f"{f}/down_bn/scale", "copy")
            m[f"{t}.downsample.1.bias"] = (f"{f}/down_bn/bias", "copy")

    for k in range(4):  # torch branch1..4 == our branch0..3
        m.update(_convbn(f"{fe_t}.branch{k + 1}.1", f"{fe_f}/branch{k}"))
    m.update(_convbn(f"{fe_t}.lastconv.0", f"{fe_f}/last0"))
    m[f"{fe_t}.lastconv.2.weight"] = (f"{fe_f}/last1/kernel", "conv2d")

    # ---- D-Net optional costV refinement convs (basic.py:189-196) ----
    # present only when the model was built with refine_costv; entries for
    # an absent branch land in the report's missing_flax_keys
    m.update(_conv_bias("d_net.conv0.0", "costv_conv0"))
    m.update(_conv_bias("d_net.conv0_1.0", "costv_conv0_1"))
    m.update(_conv_bias("d_net.conv0_2", "costv_conv0_2"))

    # ---- K-Net (basic.KV_NET_BASIC) ----
    kv_t, kv_f = "kv_net", "kv_net"
    for d in range(5):
        for i, j in ((0, 0), (2, 1)):
            m.update(_convbn(f"{kv_t}.dres{d}.{i}", f"{kv_f}/dres{d}_{j}",
                             dims=3))
    m.update(_convbn(f"{kv_t}.classify.0", f"{kv_f}/classify_0", dims=3))
    m[f"{kv_t}.classify.2.weight"] = (f"{kv_f}/classify_1/kernel", "conv3d")

    # ---- R-Net ----
    r_t, r_f = "r_net", "r_net"
    if refine_net == "DGF":
        # RefineNet_DGF.feature_ext = Sequential(Conv2d(3,64,1), ReLU,
        # Conv2d(64,1,1)) (Refine.py:598-601)
        m.update(_conv_bias(f"{r_t}.feature_ext.0", f"{r_f}/feature_ext_0"))
        m.update(_conv_bias(f"{r_t}.feature_ext.2", f"{r_f}/feature_ext_2"))
        return m
    # Refine.RefineNet_DPV_upsample
    for name in ("conv0", "conv0_1", "conv1", "conv1_1", "conv2", "conv2_1"):
        m.update(_conv_bias(f"{r_t}.{name}.0", f"{r_f}/{name}"))
    m.update(_conv_bias(f"{r_t}.conv2_2", f"{r_f}/conv2_2"))
    for name in ("trans_conv0", "trans_conv1"):
        m[f"{r_t}.{name}.0.weight"] = (f"{r_f}/{name}/kernel", "deconv2d")
        m[f"{r_t}.{name}.0.bias"] = (f"{r_f}/{name}/bias", "copy")
    return m


def build_refine_head_map(head: str) -> dict[str, tuple[str, str]]:
    """Name map for a STANDALONE legacy refine head's bare state_dict
    (models/refine_legacy.py vs Refine.py:135-585). ``head`` in
    {'unet2d', 'demon', '3d', '3d_nearest', 'unet3d_res', 'unet3d'}."""
    m: dict[str, tuple[str, str]] = {}

    def convbn3(tp, fp):
        m[f"{tp}.0.0.weight"] = (f"{fp}/conv/kernel", "conv3d")
        m[f"{tp}.0.0.bias"] = (f"{fp}/conv/bias", "copy")   # _bias variant
        m[f"{tp}.0.1.weight"] = (f"{fp}/bn/scale", "copy")
        m[f"{tp}.0.1.bias"] = (f"{fp}/bn/bias", "copy")

    if head in ("unet2d", "demon"):
        m.update(_conv_bias("conv0.0", "conv0"))
        if head == "unet2d":
            m.update(_conv_bias("conv0_1.0", "conv0_1"))
        for name in ("conv1", "conv1_1", "conv2", "conv2_1", "conv3"):
            m.update(_conv_bias(f"{name}.0", f"core/{name}"))
        for name in ("trans_conv0", "trans_conv1"):
            m[f"{name}.0.weight"] = (f"core/{name}/kernel", "deconv2d")
            m[f"{name}.0.bias"] = (f"core/{name}/bias", "copy")
        m.update(_conv_bias("conv3_1", "core/conv3_1"))
        return m

    if head in ("3d", "3d_nearest"):
        for name in ("conv1", "conv2", "conv3", "conv4"):
            convbn3(name, name)
        if head == "3d":
            for name in ("conv5", "conv6"):
                m[f"{name}.0.weight"] = (f"{name}/kernel", "deconv3d")
                m[f"{name}.1.weight"] = (f"{name}_bn/scale", "copy")
                m[f"{name}.1.bias"] = (f"{name}_bn/bias", "copy")
        else:  # Sequential(Upsample, convbn_3d) -> index 1
            for name in ("conv5", "conv6"):
                m[f"{name}.1.0.weight"] = (f"{name}/conv/kernel", "conv3d")
                m[f"{name}.1.1.weight"] = (f"{name}/bn/scale", "copy")
                m[f"{name}.1.1.bias"] = (f"{name}/bn/bias", "copy")
        convbn3("classif1", "classif1_0")
        m["classif1.2.weight"] = ("classif1_1/kernel", "conv3d")
        return m

    if head in ("unet3d_res", "unet3d"):
        for name in ("conv1", "conv2", "conv3", "conv4", "conv5",
                     "conv5_r", "conv6", "conv6_r", "conv7"):
            convbn3(name, name)
        return m

    raise ValueError(head)


def _flatten(tree, prefix: str = "") -> dict[str, np.ndarray]:
    flat = {}
    for key, val in tree.items():
        path = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(val, Mapping):
            flat.update(_flatten(val, path))
        else:
            flat[path] = np.asarray(val)
    return flat


def _to_torch_layout(arr: np.ndarray, kind: str) -> np.ndarray:
    """Inverse of the JAX importer's ``_transform``."""
    if kind == "copy":
        return arr
    if kind == "conv2d":        # (kh, kw, I, O) -> (O, I, kh, kw)
        return arr.transpose(3, 2, 0, 1)
    if kind == "conv3d":        # (kd, kh, kw, I, O) -> (O, I, kd, kh, kw)
        return arr.transpose(4, 3, 0, 1, 2)
    if kind == "deconv2d":      # flipped (kh, kw, I, O) -> (I, O, kh, kw)
        return arr.transpose(2, 3, 0, 1)[:, :, ::-1, ::-1]
    if kind == "deconv3d":      # flipped (kd, kh, kw, I, O) -> (I, O, kd, kh, kw)
        return arr.transpose(3, 4, 0, 1, 2)[:, :, ::-1, ::-1, ::-1]
    raise ValueError(f"no torch layout for {kind}")


def state_dict_from_jax(variables, refine_net: str = "DPV"
                        ) -> dict[str, torch.Tensor]:
    """Flax variables (``{"params": ...}`` or the params tree itself, numpy
    leaves) -> torch state_dict with the reference KVNET's keys.
    ``refine_net``: the head the variables were built with ('DPV', also
    under ``refine_dup``, or 'DGF'); ``refine_costv`` and ``dnet_bayes``
    need no argument (their keys are mapped, or absent, either way).

    Raises if a flax parameter has no torch key, so nothing is dropped.
    One state_dict serves every setting of the inference deviations
    (``knet_coarse_d``, ``fe_per_frame_bn`` with cached features, ``dtype``):
    none of them adds a parameter, in JAX or in the port.
    """
    return _state_dict_with_map(variables, build_name_map(refine_net))


def refine_head_state_dict_from_jax(variables, head: str
                                    ) -> dict[str, torch.Tensor]:
    """Flax variables of a legacy refine head (``neuralrgbd_tpu/models/
    refine_legacy.py``) -> the bare state_dict of the port's head of the
    same kind (``models/refine_legacy.py``); ``head`` as for
    ``build_refine_head_map``. Raises on an unmapped flax parameter."""
    return _state_dict_with_map(variables, build_refine_head_map(head))


def _state_dict_with_map(variables, name_map) -> dict[str, torch.Tensor]:
    params = variables.get("params", variables)
    flat = _flatten(params)
    sd, used = {}, set()
    for tkey, (fkey, kind) in name_map.items():
        if fkey in flat:
            arr = _to_torch_layout(flat[fkey], kind).astype(np.float32)
            sd[tkey] = torch.from_numpy(np.ascontiguousarray(arr))
            used.add(fkey)
    unmapped = sorted(set(flat) - used)
    if unmapped:
        raise ValueError(f"flax parameters without a torch key: {unmapped}")
    return sd


def _strip_prefix(key: str) -> str:
    for pre in ("module.", "model."):
        if key.startswith(pre):
            key = key[len(pre):]
    return key


def load_torch_checkpoint(path: str):
    """Load a reference .tar checkpoint -> numpy state_dict (CPU torch)."""
    payload = torch.load(path, map_location="cpu", weights_only=False)
    sd = payload.get("state_dict", payload)
    return {k: v.numpy() if hasattr(v, "numpy") else np.asarray(v)
            for k, v in sd.items()}


def load_reference_state_dict(model: torch.nn.Module, state_dict) -> dict:
    """Load a reference KVNET state_dict (tensors or arrays) into the port's
    ``KVNet``, strictly, whatever its head (the keys are the model's own).

    The keys are filtered as the JAX importer filters them
    (``neuralrgbd_tpu/utils/torch_import.py:242-247``): ``module.`` and
    ``model.`` prefixes stripped; ``running_*`` and ``num_batches_tracked``
    (batch-statistics BN keeps none) and the D-Net's
    ``d_net.feature_extraction.*`` aliases of ``feature_extractor.*``
    dropped. Prints JAX's report line. Raises if a parameter of the model
    would stay unloaded, or (``load_state_dict``) on a shape mismatch;
    checkpoint keys the model has no parameter for are reported, not
    loaded. Returns the report.
    """
    own = model.state_dict()
    kept, skipped = {}, []
    for tkey, tval in state_dict.items():
        key = _strip_prefix(str(tkey))
        if key.startswith("d_net.feature_extraction."):
            continue  # alias of feature_extractor.*
        if "num_batches_tracked" in key or "running_" in key:
            continue
        if key not in own:
            skipped.append(key)
            continue
        kept[key] = torch.as_tensor(np.asarray(tval))
    print(f"imported {len(kept)}/{len(own)} tensors from the torch "
          f"checkpoint")
    if skipped:
        print(f"  unmatched torch keys: {skipped[:8]} ...")
    missing = sorted(set(own) - set(kept))
    if missing:
        raise KeyError(f"the checkpoint leaves {len(missing)} parameter(s) "
                       f"of the model unloaded: {missing[:8]}")
    model.load_state_dict(kept, strict=True)
    return {"n_imported": len(kept), "n_params_total": len(own),
            "unmatched_torch_keys": skipped}


@torch.no_grad()
def import_psmnet_state_dict(state_dict, model: torch.nn.Module):
    """Warm-start the feature extractor from a PSMNet checkpoint, in place
    (JAX: ``neuralrgbd_tpu/utils/torch_import.py:281``; the reference's
    ``load_pretrained_PSMNet``, utils/models.py:12-37).

    A partial load: every checkpoint tensor named ``feature_extraction.*``
    (``module.``/``model.`` prefixes stripped) whose key, under the model's
    ``feature_extractor.`` prefix, exists with the same shape is copied in;
    everything else keeps its value. PSMNet's ``running_*`` and
    ``num_batches_tracked`` entries have no counterpart (batch-statistics
    BatchNorm). Returns ``(model, report)`` with JAX's report keys.
    """
    own = model.state_dict()
    used, skipped, mismatched = [], [], []
    for tkey, tval in state_dict.items():
        key = _strip_prefix(str(tkey))
        if not key.startswith("feature_extraction."):
            continue
        key = "feature_extractor." + key
        if "num_batches_tracked" in key or "running_" in key:
            continue
        if key not in own:
            skipped.append(key)
            continue
        val = torch.as_tensor(np.asarray(tval), dtype=torch.float32)
        if tuple(val.shape) != tuple(own[key].shape):
            mismatched.append((key, tuple(val.shape), tuple(own[key].shape)))
            continue
        own[key].copy_(val)
        used.append(key)
    report = {
        "n_imported": len(used),
        "n_params_total": len(own),
        "unmatched_torch_keys": skipped,
        "shape_mismatches": mismatched,
    }
    return model, report
