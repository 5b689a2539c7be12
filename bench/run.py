"""The benchmark of the PyTorch and CUDA port (``repro_torch``) on one
NVIDIA card: one run of one cell.

    python3 bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The last line of standard output is the
result (``correct``, ``attempted``, ``failed``, ``metrics``, ``device``;
with ``--trace 1`` the per-layer metrics and a ``breakdown``), and the
last lines of standard error give each compared number beside its limit.
The run refuses (exit 2, no result) without as many CUDA cards as the
cell asks for, and fails (exit 3, no result) if JAX or the JAX package
was loaded.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / ".bench_cache"
HOST_THREAD_VARS = ("OMP_NUM_THREADS", "MKL_NUM_THREADS",
                    "OPENBLAS_NUM_THREADS")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    if args.seed < 0:
        p.error("--seed must be a whole number >= 0")

    # one host thread for the libraries' own pools: the window is paced by
    # one Python thread dispatching to the card, and set-up's host work is
    # numpy's, so more threads only add load on a shared host
    for var in HOST_THREAD_VARS:
        os.environ[var] = "1"
    # every cache a compiler may keep, at fixed paths inside the checkout
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("PYTORCH_KERNEL_CACHE_PATH", "torch_kernels")):
        os.environ[var] = str(CACHE / sub)
    # the checkout's root (for ``bench``) and ``src`` (the program), and not
    # this directory, so no file here shadows a library module
    sys.path[:1] = [str(ROOT), str(ROOT / "src")]

    chips = next((w["chips"] for w in json.loads(
        (ROOT / "BENCHMARK.json").read_text())["workloads"]
        if w["name"] == args.workload), None)
    if chips is None:
        p.error(f"no workload {args.workload!r} in BENCHMARK.json")
    import torch
    torch.set_num_threads(1)
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < chips:
        print(f"bench: the cell needs {chips} CUDA card(s), {found} found",
              file=sys.stderr)
        return 2

    from bench import harness
    line = harness.run_cell(ROOT, args.workload, args.seed, args.seconds,
                            bool(args.trace), "cuda", t_process=T_PROCESS)
    bad = harness.loaded_forbidden()
    if bad:
        print(f"bench: JAX or the JAX package was loaded: {bad}",
              file=sys.stderr)
        return 3
    for name, c in line["checks"].items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr,
              flush=True)
    print(json.dumps(line, allow_nan=False), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
