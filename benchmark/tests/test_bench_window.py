"""The measured window read from the files' mtimes: chunks grouped as the
loop's exporter groups them, the window opening once every device has
completed its first chunk of call 0 and closing at the last chunk
completed within the seconds."""

import os

from benchmark.harness import window as win


def _frames(res_dir, times):
    os.makedirs(res_dir, exist_ok=True)
    for f, t in enumerate(times):
        for kind in ("d", "conf"):
            p = os.path.join(res_dir, f"{kind}_{f:05d}.pgm")
            open(p, "wb").close()
            os.utime(p, (t, t))


def test_chunks_of_one_lane_and_of_lanes_per_device(tmp_path):
    _frames(tmp_path / "a", [10.0 + f for f in range(10)])
    got = win.chunks(0, [str(tmp_path / "a")], 10, 1, 4)
    assert [(c.device, c.done, c.frames) for c in got] == [
        (0, 13.0, 4), (0, 17.0, 4), (0, 19.0, 2)]
    # two lanes on one device: entries alternate lane by lane
    _frames(tmp_path / "b", [20.0 + f for f in range(4)])
    got = win.chunks(1, [str(tmp_path / "a"), str(tmp_path / "b")], 4, 2, 4)
    assert [(c.device, c.done, c.frames) for c in got] == [
        (0, 21.0, 4), (0, 23.0, 4)]
    # the same two lanes a device each
    got = win.chunks(1, [str(tmp_path / "a"), str(tmp_path / "b")], 4, 1, 4)
    assert [(c.device, c.done, c.frames) for c in got] == [
        (0, 13.0, 4), (1, 23.0, 4)]
    # a missing file never completes
    os.remove(tmp_path / "b" / "conf_00003.pgm")
    got = win.chunks(1, [str(tmp_path / "b")], 4, 1, 2)
    assert got[-1].done == float("inf")


def test_window_closes_at_the_last_chunk_within_the_seconds():
    C = win.Chunk
    chunks = [C(0, 0, 10.0, 4), C(0, 0, 12.0, 4), C(0, 0, 13.0, 2),
              C(1, 0, 16.0, 4), C(1, 0, 18.0, 4), C(1, 0, 19.0, 2),
              C(2, 0, 22.0, 4), C(2, 0, 24.0, 4)]
    w = win.window(chunks, 13.0)
    assert (w.open, w.close, w.frames) == (10.0, 22.0, 20)
    assert w.rate == 20 / 12.0
    w = win.window(chunks, 14.0)
    assert (w.close, w.frames) == (24.0, 24)


def test_window_opens_after_every_devices_first_chunk():
    # four devices finish their first chunk of call 0 at 10.0-10.75: the
    # window opens at 10.75, and none of the four first chunks counts
    C = win.Chunk
    chunks = [C(0, d, 10.0 + 0.25 * d, 4) for d in range(4)]
    chunks += [C(0, d, 12.0 + 0.25 * d, 4) for d in range(4)]
    chunks += [C(1, d, 15.0 + 0.25 * d, 4) for d in range(4)]
    w = win.window(chunks, 4.5)
    assert w.open == 10.75
    assert w.close == 15.25 and w.frames == 4 * 4 + 2 * 4
    # a device's second chunk done before the opening does not count
    chunks.append(C(0, 0, 10.5, 4))
    assert win.opening(chunks) == 10.75
    assert win.window(chunks, 4.5).frames == w.frames
