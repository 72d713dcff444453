"""The measured window, read from the files the timed path wrote.

The loop exports each device's maps in chunks: every ``chunk_t`` frames
queued on a device go to the host in one copy and are written by one export
thread (``infer.loop.ChunkExporter``). Each call's lanes are laid out as the
loop lays them, ``per_dev`` consecutive lanes a device; entry e = frame x
per_dev + the lane's place on its device, and chunk = e // chunk_t. That
holds where every lane of a call has every frame, as the traffic's scenes
do. A chunk is complete when the last of its ``d_*.pgm`` and ``conf_*.pgm``
is written (the files' mtimes).

The window opens once every device has completed the first chunk of the
first timed call: at the last of those first chunks, so that no chunk
holding frames from before the opening counts on any device. It closes at
the last chunk completed within ``seconds`` of the opening. The rate is
every frame of the chunks completed after the opening and by the close,
over the time between the two completions.
"""

from __future__ import annotations

import os
from typing import NamedTuple


class Chunk(NamedTuple):
    call: int
    device: int        # the device's place among the call's devices
    done: float        # wall clock: the last of its files written
    frames: int


def frame_done(res_dir: str, frame: int) -> float:
    """When frame ``frame``'s depth and confidence files were both written
    (wall clock); inf if one is missing."""
    t = 0.0
    for kind in ("d", "conf"):
        try:
            t = max(t, os.stat(os.path.join(
                res_dir, f"{kind}_{frame:05d}.pgm")).st_mtime_ns / 1e9)
        except FileNotFoundError:
            return float("inf")
    return t


def chunks(call: int, res_dirs: list, frames: int, per_dev: int,
           chunk_t: int) -> list:
    """The chunks of one call whose lanes (``res_dirs``) each exported
    ``frames`` frames."""
    out = []
    for first in range(0, len(res_dirs), per_dev):
        lanes = res_dirs[first:first + per_dev]
        done: dict = {}
        for f in range(frames):
            for q, res_dir in enumerate(lanes):
                c = (f * len(lanes) + q) // chunk_t
                t, n = done.get(c, (0.0, 0))
                done[c] = (max(t, frame_done(res_dir, f)), n + 1)
        out += [Chunk(call, first // per_dev, t, n)
                for t, n in done.values()]
    return out


def opening(all_chunks: list) -> float:
    """The last device's first completed chunk of call 0."""
    first: dict = {}
    for c in all_chunks:
        if c.call == 0:
            first[c.device] = min(first.get(c.device, c.done), c.done)
    return max(first.values())


class Window(NamedTuple):
    open: float
    close: float
    frames: int

    @property
    def seconds(self) -> float:
        return self.close - self.open

    @property
    def rate(self) -> float:
        return self.frames / self.seconds


def window(all_chunks: list, seconds: float) -> Window:
    """The window over ``all_chunks`` (every timed call's)."""
    t_open = opening(all_chunks)
    closes = [c.done for c in all_chunks
              if t_open < c.done <= t_open + seconds]
    if not closes:
        raise RuntimeError("no chunk completed inside the window")
    close = max(closes)
    return Window(t_open, close, sum(c.frames for c in all_chunks
                                     if t_open < c.done <= close))
