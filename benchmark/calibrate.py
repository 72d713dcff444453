"""The readings that a cell's limits are set from, for many seeds in one
process:

    python3 benchmark/calibrate.py --workload <name> --seeds <n> ... \\
        [--control <n> ...]

For each seed: the traffic's scenes of the first call and the weights, as a
run makes them; one call of the program's entry on them, at the cell's
settings (the timed path); then the plain reference in fp32 over the lanes
that a run samples, against the program's files: the lower readings. For
each ``--control`` seed also the control: the reference in TF32, put in the
program's place, against the fp32 reference: the upper readings. One JSON
line a seed on standard output; the run's check takes the same numbers
(``harness/check.py``).
"""

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control", type=int, nargs="*", default=[])
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from benchmark.harness import check, drive, spec
    from benchmark.harness import weights as weights_mod
    from benchmark.reference import kvnet as ref_kvnet
    from benchmark.reference.kvnet import param_spec
    from benchmark.traffic import scenes

    cell = spec.cell(spec.benchmark(), args.workload)
    cfg, tr = spec.config(cell["config"]), spec.traffic(cell["traffic"])
    devices = drive.devices_for(cell["chips"])
    home, kind = devices[0], cfg["data"]["kind"]
    for seed in dict.fromkeys(args.seeds + args.control):
        # every seed has its lower reading; --control seeds the control too
        t0 = time.perf_counter()
        work = tempfile.mkdtemp(prefix="kvnet_calib_")
        try:
            root = os.path.join(work, "scenes")
            scenes.write(kind, root, tr["lanes"], tr["scene_frames"][kind],
                         cfg["data"]["orig_wh"], seed, home)
            weights = weights_mod.make(param_spec(cfg["model"]), seed, home)
            program = drive.Program(cfg, tr, weights, home)
            res = [os.path.join(work, "out", f"l{j}")
                   for j in range(tr["lanes"])]
            program.call([program.trajectory(root, j)
                          for j in range(tr["lanes"])], res)
            cards = drive._cards(program)
            del program
            if home.type == "cuda":
                torch.cuda.empty_cache()
            picks = list(range(0, tr["lanes"],
                               max(1, tr["lanes"] // tr["check_lanes"])))
            picks = picks[:tr["check_lanes"]]

            def maps(precision):
                """Each picked lane's maps by the reference."""
                with ref_kvnet.numerics(precision):
                    r = ref_kvnet.Reference(weights, cfg["model"], cards[0],
                                            precision)
                    return {j: list(r.run(check.reference_scene(
                        cfg, root, j))) for j in picks}

            fp32 = maps("fp32")
            line = {"workload": args.workload, "seed": seed}
            runs = {"lower": {j: check.files_of(res[j]) for j in picks}}
            if seed in args.control:
                # the control in the program's place
                runs["control"] = {j: {f: (d, c) for f, d, c, _ in lane}.get
                                   for j, lane in maps("tf32").items()}
            for name, got in runs.items():
                stats, missing = [], 0
                for j in picks:
                    st, mi = check.compare(fp32[j], got[j])
                    stats, missing = stats + st, missing + mi
                line[name] = _summary(stats, missing, tr["chunk_t"])
        finally:
            shutil.rmtree(work, ignore_errors=True)
        line["seconds"] = time.perf_counter() - t0
        print(json.dumps(line), flush=True)
    return 0


def _summary(stats: list, missing: int, chunk_t: int) -> dict:
    """The run's compared numbers (``check.judge``), candidates beside
    them, and every frame's gaps, for the look at where a reading comes
    from."""
    import numpy as np

    from benchmark.harness import check
    nums = check.judge(stats, missing, {k: 0.0 for k in check.NAMES},
                       chunk_t)
    out = {k: v for k, (v, _) in nums.items()}
    out["frames"] = len(stats)
    out["depth_mm_worst_frame"] = max(d for _, d, _, _ in stats)
    out["per_frame"] = [[f, round(d, 5), round(c, 5)]
                        for f, d, c, _ in stats]
    return out


if __name__ == "__main__":
    sys.exit(main())
