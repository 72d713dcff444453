"""Dependency-free MJPEG-AVI video writer.

The reference assembles result videos with ``imageio``/ffmpeg
(``code/mio/vidIO.py:169-206`` ``writeVideo`` and the
``re_write_video_from_img_res*`` helpers, :102-166). No video encoder is
bundled in this environment, so this module writes the AVI RIFF container
by hand with Motion-JPEG frames (every frame an independent JPEG, encoded
by PIL) — a format every stock player/ffmpeg build decodes. The GIF path
(``export.results_to_gif``) remains as a fallback for quick previews.

Layout written (AVI 1.0, single 'vids' stream, idx1 index):

    RIFF 'AVI '
      LIST 'hdrl' [ avih, LIST 'strl' [ strh('vids'/'MJPG'), strf(BIH) ] ]
      LIST 'movi' [ '00dc' <jpeg>, ... ]
      idx1 [ 16-byte entries ]
"""

from __future__ import annotations

import io
import os
import struct
from typing import Iterable, Optional, Sequence

import numpy as np
import PIL.Image


def _fourcc(s: str) -> bytes:
    return s.encode("ascii")


def _chunk(fcc: str, payload: bytes) -> bytes:
    pad = b"\x00" if len(payload) % 2 else b""
    return _fourcc(fcc) + struct.pack("<I", len(payload)) + payload + pad


def _list(kind: str, payload: bytes) -> bytes:
    body = _fourcc(kind) + payload
    return _chunk("LIST", body)


def _encode_jpeg(frame: np.ndarray, quality: int) -> bytes:
    if frame.ndim == 2:
        frame = np.repeat(frame[..., None], 3, axis=-1)
    buf = io.BytesIO()
    PIL.Image.fromarray(frame[..., :3]).save(buf, "JPEG", quality=quality)
    return buf.getvalue()


def write_avi(frames: Iterable[np.ndarray], path: str, fps: int = 30,
              quality: int = 90) -> int:
    """Write uint8 frames ((H, W, 3) or (H, W)) as an MJPEG AVI.

    All frames must share one size. Returns the frame count.
    """
    jpegs = []
    w = h = None
    for f in frames:
        f = np.ascontiguousarray(f)
        if f.dtype != np.uint8:
            raise ValueError("write_avi expects uint8 frames; normalize "
                             "first (see write_video)")
        if w is None:
            h, w = f.shape[:2]
        elif f.shape[:2] != (h, w):
            raise ValueError(f"frame size changed: {f.shape[:2]} != {(h, w)}")
        jpegs.append(_encode_jpeg(f, quality))
    if not jpegs:
        raise ValueError("no frames")

    n = len(jpegs)
    max_bytes = max(len(j) for j in jpegs)

    # main AVI header (56-byte avih payload)
    AVIF_HASINDEX = 0x10
    avih = struct.pack(
        "<IIIIIIIIIIIIII",
        int(1e6 / fps),          # dwMicroSecPerFrame
        max_bytes * fps,         # dwMaxBytesPerSec
        0,                       # dwPaddingGranularity
        AVIF_HASINDEX,           # dwFlags
        n,                       # dwTotalFrames
        0,                       # dwInitialFrames
        1,                       # dwStreams
        max_bytes,               # dwSuggestedBufferSize
        w, h,
        0, 0, 0, 0,              # dwReserved
    )
    strh = struct.pack(
        "<4s4sIHHIIIIIIIi4H",
        _fourcc("vids"), _fourcc("MJPG"),
        0, 0, 0,                 # flags, priority, language
        0,                       # initial frames
        1, fps,                  # scale, rate => fps frames/s
        0, n,                    # start, length
        max_bytes,               # suggested buffer size
        10000,                   # quality
        0,                       # sample size
        0, 0, w, h,              # rcFrame
    )
    strf = struct.pack(
        "<IiiHH4sIiiII",
        40, w, h, 1, 24, _fourcc("MJPG"), w * h * 3, 0, 0, 0, 0,
    )
    hdrl = _list("hdrl", _chunk("avih", avih)
                 + _list("strl", _chunk("strh", strh) + _chunk("strf", strf)))

    movi_payload = b""
    idx_entries = []
    AVIIF_KEYFRAME = 0x10
    for j in jpegs:
        # idx1 offsets are relative to the 'movi' fourcc position
        idx_entries.append((4 + len(movi_payload), len(j)))
        movi_payload += _chunk("00dc", j)
    movi = _list("movi", movi_payload)

    idx1 = b"".join(
        _fourcc("00dc") + struct.pack("<III", AVIIF_KEYFRAME, off, size)
        for off, size in idx_entries)
    body = _fourcc("AVI ") + hdrl + movi + _chunk("idx1", idx1)

    with open(path, "wb") as f:
        f.write(_chunk("RIFF", body))
    return n


def write_video(frames: Sequence[np.ndarray], path: str, fps: int = 30,
                max_v: Optional[float] = None, norm_m: Optional[int] = None,
                quality: int = 90) -> int:
    """``vidIO.writeVideo`` surface (mio/vidIO.py:169-206): float frames
    with the same normalization modes — norm_m=0 scales all frames by
    ``max_v``, norm_m=1 per-frame by its own max, None casts directly."""
    out = []
    for im in frames:
        im = np.asarray(im)
        if norm_m == 0:
            imn = np.clip(im / max_v, 0.0, 1.0)
            out.append(np.uint8(imn * 255.0))
        elif norm_m == 1:
            out.append(np.uint8(im / max(float(im.max()), 1e-12) * 255.0))
        else:
            out.append(np.uint8(im))
    return write_avi(out, path, fps=fps, quality=quality)


def results_to_avi(res_dir: str, out_path: str, pattern: str = "d_",
                   fps: int = 15, quality: int = 90) -> int:
    """Assemble exported pgm results into res.avi — the
    ``re_write_video_from_img_res_1`` counterpart (vidIO.py:126-166; their
    pgm branch also normalizes the 16-bit maps before writing)."""
    import glob as _glob

    paths = sorted(_glob.glob(os.path.join(res_dir, f"{pattern}*.pgm")))
    if not paths:
        raise FileNotFoundError(f"no {pattern}*.pgm under {res_dir}")
    frames = []
    for p in paths:
        arr = np.asarray(PIL.Image.open(p), np.float32)
        frames.append(arr / max(float(arr.max()), 1.0) * 255.0)
    return write_video([f for f in frames], out_path, fps=fps, norm_m=None,
                       quality=quality)


def read_avi_mjpeg(path: str):
    """Minimal reader for MJPEG AVIs written by ``write_avi`` (round-trip
    testing without external decoders). Returns (frames, fps)."""
    with open(path, "rb") as f:
        data = f.read()
    assert data[:4] == b"RIFF" and data[8:12] == b"AVI ", "not an AVI"
    frames = []
    fps = None
    pos = 12
    end = 8 + struct.unpack("<I", data[4:8])[0]

    def walk(pos, end):
        nonlocal fps
        while pos + 8 <= end:
            fcc = data[pos:pos + 4]
            size = struct.unpack("<I", data[pos + 4:pos + 8])[0]
            body = pos + 8
            if fcc == b"LIST":
                walk(body + 4, body + size)
            elif fcc == b"avih":
                fps = round(1e6 / struct.unpack("<I", data[body:body + 4])[0])
            elif fcc == b"00dc":
                frames.append(np.asarray(PIL.Image.open(
                    io.BytesIO(data[body:body + size]))))
            pos = body + size + (size % 2)

    walk(pos, end)
    return frames, fps
