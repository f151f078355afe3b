"""Run one cell of the benchmark on the card this process is started on.

    python3 hmc_bench/run.py --workload demo64.gen --seed 7 --seconds 20 --trace 0

from the root of a checkout. The last line of standard output is the
result: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer metrics),
``device``, with ``--trace 1`` a ``breakdown``, and last ``checks``, each
compared number beside its limit; standard error ends with the same
numbers. Without a CUDA card, or with fewer cards than the cell asks for,
it exits with 2 and prints no result; with a module of JAX or of the JAX
package loaded once the window has closed, with 3.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "schwingermodel_tpu"}


def forbidden_modules(names) -> list:
    """The loaded modules whose top-level name (before the first dot) is
    JAX's or the JAX package's, compared whole."""
    return sorted({n for n in names if n.split(".", 1)[0] in FORBIDDEN})


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch

    sys.path.insert(0, str(ROOT))
    from hmc_bench import harness, registry

    cell = registry.cell(ROOT, args.workload)
    chips = registry.chips(ROOT, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"error: the cell needs {chips} CUDA card(s); "
              f"torch.cuda.is_available() = {torch.cuda.is_available()}",
              file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    line, checks = harness.run_cell(cell, args.seed, args.seconds,
                                    bool(args.trace), "cuda", T_START)
    bad = forbidden_modules(sys.modules)
    if bad:
        print(f"error: modules of JAX or the JAX package loaded: {bad}",
              file=sys.stderr)
        return 3
    print(json.dumps(line), flush=True)
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
