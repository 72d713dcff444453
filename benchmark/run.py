"""Run one cell of the benchmark once, from the root of a checkout:

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

The cell (``BENCHMARK.json``'s ``workloads``) names a configuration
(``benchmark/configs/``) and a traffic mix (``benchmark/traffic/``). With
``--trace 0`` the last line of standard output is the result with the
cell's end-to-end metrics; with ``--trace 1``, a run with the probes and a
profiler slice, its per-layer metrics. The numbers that decide ``correct``
are printed, each beside its limit, as the last lines of standard error
and under ``checks``, the result's last key.

Exits non-zero, printing no result, without as many CUDA cards as the cell
asks for, or if JAX or the JAX package was loaded.
"""

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "neuralrgbd_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's, jaxlib's, flax's or
    the JAX package's, compared whole."""
    return sorted({name.split(".")[0] for name in sys.modules}
                  & set(FORBIDDEN))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    # CUDA's JIT cache inside the checkout, at a fixed path
    os.environ.setdefault("CUDA_CACHE_PATH",
                          os.path.join(ROOT, ".bench_cache", "nv"))
    sys.path.insert(0, ROOT)
    import torch

    from benchmark.harness import drive, spec

    bench = spec.benchmark()
    cell = spec.cell(bench, args.workload)
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA card(s); this "
              f"process sees {cards}", file=sys.stderr)
        return 2
    result = drive.run_cell(bench, cell, args.seed, args.seconds,
                            bool(args.trace), T_START)
    found = forbidden_modules()
    if found:
        print(f"loaded in this process: {', '.join(found)}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
