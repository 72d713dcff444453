"""The check that decides ``correct`` fails a run whose timed path is
broken underneath: a tiny cell on the CPU, the harness's look for a card
skipped, driven end to end with one fault planted in the program at a
time, and held to a real cell's limits.

The faults a cell of this benchmark can have: a step that returns its
state (the carried prediction) unchanged; an answer (a frame's depth)
altered where it is produced; in lockstep, half of a step's lanes left
out, their maps taken from the other half. No cell exchanges anything
between cards (each lane runs on one card), so there is no exchange to
leave out.
"""

import json
import time

import pytest
import torch

from benchmark.harness import drive
from conftest import write_tiny


def _run(bench, cell, bench_dir, seed=2**31 + 11):
    return drive.run_cell(bench, cell, seed, 8.0, False, time.time(),
                          device="cpu", bench_dir=bench_dir)


def _fault(monkeypatch, wrap):
    """Wrap every step the loop makes: ``wrap(n, args, out) -> out``."""
    from neuralrgbd_tpu_torch.infer import loop

    make = loop.make_infer_step

    def faulty(*a, **k):
        step = make(*a, **k)
        calls = [0]

        def stepped(*args):
            out = step(*args)
            calls[0] += 1
            return wrap(calls[0], args, out)
        return stepped
    monkeypatch.setattr(loop, "make_infer_step", faulty)


def test_sound_run_is_correct(tiny):
    r = _run(*tiny)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] > 0


def test_state_returned_unchanged(tiny, monkeypatch):
    _fault(monkeypatch, lambda n, args, out: out._replace(
        bv_predict=args[2].clone()))
    r = _run(*tiny)
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("frame,metres", [(3, 0.1), (6, 0.02)])
def test_answer_altered(tiny, monkeypatch, frame, metres):
    # one frame deeper: in the scene's first chunk (4 frames), held by the
    # raw gap, or after it, held per frame of carry
    def wrap(n, args, out):
        if n == frame:
            out.depth[0] += metres
        return out
    _fault(monkeypatch, wrap)
    r = _run(*tiny)
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("broken", [False, True])
def test_half_the_lanes_left_out(tmp_path, monkeypatch, broken):
    import tempfile
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    bench, cell = write_tiny(tmp_path / "benchmark",
                             entry="run_trajectories_parallel", lanes=4,
                             limits_of="scannet_stream")
    # every lane of every call in the window checked, the broken half
    # among them whatever the seed draws
    tr = tmp_path / "benchmark" / "traffic" / "tiny.json"
    tr.write_text(json.dumps(dict(json.loads(tr.read_text()),
                                  check_lanes=10**6)))
    if broken:
        def wrap(n, args, out):
            half = len(args[3]) // 2
            return out._replace(**{
                k: torch.cat([getattr(out, k)[:half]] * 2)[:len(args[3])]
                for k in ("depth", "confidence", "bv_predict")})
        _fault(monkeypatch, wrap)
    r = _run(bench, cell, tmp_path / "benchmark")
    assert r["correct"] is not broken, r["checks"]
