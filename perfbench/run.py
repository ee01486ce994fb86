"""Run one cell of the benchmark once, from the root of a checkout:

    python3 -m perfbench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Set-up (inputs and weights from the seed, the program's state, its first
steps, which are the warm-up) counts as setup_s, from process start to the
first timed step.  Then the window: closed-loop steps or requests for
`--seconds` seconds, ended by a synchronize.  With --trace 1 a stretch of
steady steps inside the window runs under torch.profiler and the run
reports the cell's per-layer metrics instead of its end-to-end ones.
After the window the reference follows the program and decides `correct`.

The last line of standard output is the result's JSON object; the last
lines of standard error name each number compared beside its limit.  No
result is printed, and the exit code is not 0, without a CUDA card (or
with fewer than the cell asks for), or when the process has loaded JAX,
its libraries or the JAX package.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

# Top-level module names that the process that prints a result may not
# hold: JAX, its libraries, and the JAX package (the port's name begins
# with it, so names are compared whole).
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "motionpriorcmax_tpu")


def forbidden_modules(modules=None) -> list:
    names = {name.split(".", 1)[0] for name in (modules or sys.modules)}
    return sorted(names & set(FORBIDDEN))


def parse_args(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def compared_lines(result: dict) -> list:
    return [f"compared {name} {c['value']!r} limit {c['limit']!r}"
            for name, c in result["compared"].items()]


def main(argv=None) -> int:
    args = parse_args(argv)
    import torch

    from . import harness

    if not torch.cuda.is_available():
        print("perfbench: no CUDA card (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    bench = harness.load_benchmark()
    cell = harness.find_cell(bench, args.workload)
    if torch.cuda.device_count() < int(cell["chips"]):
        print(f"perfbench: {args.workload} needs {cell['chips']} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    result = harness.run_cell(bench, cell, args.seed, args.seconds,
                              bool(args.trace), "cuda", T0)
    bad = forbidden_modules()
    if bad:
        print(f"perfbench: the process loaded {', '.join(bad)}",
              file=sys.stderr)
        return 3
    details = result.pop("details")
    print(json.dumps({"details": details}, default=str), file=sys.stderr)
    for line in compared_lines(result):
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
