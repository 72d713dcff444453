"""The inference step as a captured program: the counterpart of what
``jax.jit`` does for JAX's step (``neuralrgbd_tpu/infer/step.py:102``,
``jit=True``), its scanned rollout and its chunked loop runners.

JAX compiles a step, or a chunk of steps, into one device program that the
host issues once. The port's eager step issues thousands of PyTorch
launches a frame (the 5-frame feature extractor alone 8,570), and the host
issuing them is what bounds it on the card. ``StepGraph`` captures the
eager step once per key in a CUDA graph (``torch.cuda.CUDAGraph``) and
replays it per frame: one launch of the whole step from the host.

A ``StepGraph`` wraps ``fn(model, inputs, static) -> outputs``: ``inputs``
is a tree (dicts, tuples, lists) of tensors, ``outputs`` a tuple or
NamedTuple of tensors, ``static`` a hashable value the function branches
on in Python (the step's per-lane carry validity). It owns, per key:

- static input buffers, into which each call copies its inputs;
- the static outputs, which each call returns: the caller consumes or
  copies them before the next call with the same key overwrites them;
- the graph, and the kernels' launch tally of its capture
  (``ops.cuda.recording``): each replay adds it to the kernels'
  ``launches``.

The key is the model, the device, ``static``, the inputs' shapes and
dtypes and whether tracing is on (``utils.profiler.enabled``): for the
step, the lane count N, the tuple of per-lane validity and whether
features come precomputed; a key captured while tracing is on holds the
step's device stamps, one captured while it is off none. The graphs of
one ``StepGraph`` on one device share one memory pool
(``torch.cuda.graph_pool_handle``); a graph replays in whatever order,
since it holds its own inputs and outputs. A key is captured on a stream
of its own device, so the lockstep loop's replicas, one per card, each
capture and replay their own graphs.

The first call of a key runs ``fn`` eagerly on the static inputs: that
warm-up fills the one-time caches (``d_candi`` on the device, the
interpolation matrices, the packed and cast weights, the kernels' build
and load) and is this call's result, copied into the static outputs. Then
the key is captured (the work is not run again), under whatever numerics
``fn`` sets (``infer/step.step_numerics``: TF32 off and deterministic
cuDNN hold in the captured algorithms). So each call runs the step's work
once, and the kernels' counts stay one a frame. The capture is
``thread_local``: the loop's export threads may wait on the card while
the main thread captures (the training graphs capture autograd's
backward so too). On a CUDA tensor a failed capture or replay
raises; there is no eager fallback.

A graph reads the parameters, and the caches built from them (the packed
conv weights of ``fast_knet``, the bf16 casts), by address. How a call
checks them is the ``check`` of the ``StepGraph``:

- ``"versions"`` (the inference graphs): the parameters' versions against
  those at capture. After a write in place (``load_state_dict``, an
  optimizer step) the model's graphs are dropped and captured anew. A
  parameter rebound to a new tensor is not seen (the graph goes on reading
  the old one): build a new step after that.
- ``"addresses"`` (the training graphs, ``train.step.make_train_step(
  graph=True)``): the optimizer writes the weights in place on every step,
  and the graphs read them, and write the gradients into each ``p.grad``,
  by address. A call checks that every parameter and its ``.grad`` is
  still the tensor of the capture (``data_ptr`` and shape); a write in
  place, an optimizer step or a ``load_state_dict``, keeps the graphs
  valid. A rebound parameter or gradient raises: build a new step.

The inference loop graphs by default at ``chunk_t > 1``; the trainer, the
training campaign and the LBA CLI graph by default on the card. The
deviation gate's evaluation steps eagerly.

A function may take no tensors (``inputs`` an empty tuple): its graph
reads and writes the model's tensors by address, as the training step's
gradient clip does, and runs on the model's device.

On CPU tensors there is no graph: a call copies its inputs into the same
static buffers, runs ``fn`` on them and copies the result into the same
static outputs. So the CPU tests run the copy-in, copy-out and aliasing
logic that the card runs.

With tracing on (``utils.profiler``) a call records its spans: a key's
first call ``graph.capture`` (its key and device as attributes) around
``graph.warmup`` (the eager run) and ``graph.record`` (the capture; on the
CPU, the static outputs made), every later call ``graph.copy_in`` and
``graph.replay`` (on the CPU, ``fn`` run on the static inputs).
"""

from __future__ import annotations

import time
from typing import Any, Callable, NamedTuple

import torch

from neuralrgbd_tpu_torch.ops.cuda import recording, replayed
from neuralrgbd_tpu_torch.utils import profiler


def _leaves(tree) -> list:
    """The tensors of a tree of dicts (by sorted key), tuples and lists."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [t for x in tree for t in _leaves(x)]
    return []


def _clone(tree):
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_clone(x) for x in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_clone(x) for x in tree)
    return tree


def _copy_into(dst, src) -> None:
    for d, s in zip(_leaves(dst), _leaves(src), strict=True):
        d.copy_(s)


def _versions(params: list) -> tuple:
    return tuple(p._version for p in params)


def _addresses(model: torch.nn.Module) -> tuple:
    """Where each parameter and its ``.grad`` live (``data_ptr``, shape)."""
    return tuple((p.data_ptr(), p.shape,
                  None if p.grad is None else (p.grad.data_ptr(),
                                               p.grad.shape))
                 for p in model.parameters())


class _Entry(NamedTuple):
    model: torch.nn.Module    # held, so that its id is not reused
    params: list              # its parameters, and their versions at
    versions: tuple           # capture (a traversal per call costs ~1 ms)
    inputs: Any               # static inputs
    outputs: Any              # static outputs
    graph: Any                # torch.cuda.CUDAGraph, None on the CPU
    tally: Any                # the capture's kernel launches


class Capture(NamedTuple):
    """One captured key: the device, ``static``, the inputs' shapes, and
    the host ms of its first call (the eager warm-up and the capture)."""

    device: torch.device
    static: Any
    shapes: tuple
    ms: float


# every key captured in this process, in order: a run's captures are the
# entries it added
captures: list[Capture] = []
# one warm-up and one capture stream per device: cuBLAS keeps a workspace
# per stream it has run on (32 MiB), so a new stream per capture would keep
# adding them; and ``torch.cuda.graph``'s own capture stream is one for
# the process, made on the card current at its first capture, where a
# capture of another card's work would record none of it
_streams: dict = {}


class StepGraph:
    """``graph(model, inputs, static)`` -> the static outputs of
    ``fn(model, inputs, static)`` (module docstring). ``model`` may be
    None for a function of its inputs alone (the LBA's programs)."""

    def __init__(self, fn: Callable, check: str = "versions"):
        if check not in ("versions", "addresses"):
            raise ValueError(f"unknown check: {check!r}")
        self._fn = fn
        self._check = check
        self._entries: dict = {}
        self._pools: dict = {}            # device -> graph pool handle
        self._addresses: dict = {}        # id(model) -> _addresses at capture

    def __len__(self) -> int:
        """The keys captured and live."""
        return len(self._entries)

    def __call__(self, model: torch.nn.Module, inputs, static=()):
        leaves = _leaves(inputs)
        device = (leaves[0] if leaves else next(model.parameters())).device
        shapes = tuple((tuple(t.shape), t.dtype) for t in leaves)
        key = (id(model), device, static, shapes, profiler.enabled())
        entry = self._entries.get(key)
        if self._check == "addresses" and model is not None:
            now = _addresses(model)
            if now != self._addresses.setdefault(id(model), now):
                raise RuntimeError(
                    "a parameter or its .grad was rebound since this step's "
                    "graphs were captured (they read and write the tensors "
                    "of the capture by address): build a new step")
        elif entry is not None and _versions(entry.params) != entry.versions:
            # the weights were written since the capture
            self._entries = {k: e for k, e in self._entries.items()
                             if k[0] != id(model)}
            entry = None
        if entry is None:
            with profiler.span("graph.capture", device=device, key=static):
                t0 = time.perf_counter()
                entry = self._entries[key] = self._capture(model, inputs,
                                                           static)
                captures.append(Capture(device, static, shapes,
                                        1e3 * (time.perf_counter() - t0)))
            return entry.outputs
        with profiler.span("graph.copy_in"):
            _copy_into(entry.inputs, inputs)
        with profiler.span("graph.replay"):
            if entry.graph is None:
                _copy_into(entry.outputs,
                           self._fn(model, entry.inputs, static))
            else:
                entry.graph.replay()
                replayed(entry.tally)
        return entry.outputs

    def _capture(self, model, inputs, static) -> _Entry:
        leaves = _leaves(inputs)
        device = (leaves[0] if leaves else next(model.parameters())).device
        params = [] if model is None else list(model.parameters())
        versions = _versions(params)
        ins = _clone(inputs)
        if device.type != "cuda":
            with profiler.span("graph.warmup"):
                first = self._fn(model, ins, static)
            # no graph: the static outputs are buffers of their own
            with profiler.span("graph.record"):
                outs = _clone(first)
            return _Entry(model, params, versions, ins, outs, None, None)
        # the warm-up on a side stream; it is this call's result
        if device not in _streams:
            _streams[device] = (torch.cuda.Stream(device),
                                torch.cuda.Stream(device))
        side, capture = _streams[device]
        side.wait_stream(torch.cuda.current_stream(device))
        with profiler.span("graph.warmup"), torch.cuda.stream(side):
            first = self._fn(model, ins, static)
        torch.cuda.current_stream(device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with profiler.span("graph.record"), torch.cuda.device(device):
            pool = self._pools.setdefault(device,
                                          torch.cuda.graph_pool_handle())
            with recording() as tally, \
                    torch.cuda.graph(graph, pool=pool, stream=capture,
                                     capture_error_mode="thread_local"):
                outs = self._fn(model, ins, static)
        current = torch.cuda.current_stream(device)
        _copy_into(outs, first)
        for t in _leaves(first):      # freed only once the copy has run
            t.record_stream(current)
        return _Entry(model, params, versions, ins, outs, graph, tally)
