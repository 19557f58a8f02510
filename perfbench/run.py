"""The benchmark of ``justrelax_tpu_torch`` on one card.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

runs one cell (``perfbench/workloads/<cell>.json``) once from the root of a
checkout: the model's own set-up and first step (the warm-up, ``setup_s``),
then whole model steps until ``--seconds`` have passed, then the check of
what the window's sampled step produced against the plain reference. The
last line of standard output is the result's JSON object; the numbers
compared, each with its limit, are the last lines of standard error.
``--trace 1`` profiles one of the window's steps and reports the cell's
per-layer metrics instead of its end-to-end ones. Without a CUDA card it
exits with an error and prints no result.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / "perfbench" / "_cache"
# build and kernel caches at fixed places inside the checkout
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                 ("CUDA_CACHE_PATH", "cuda")):
    os.environ[var] = str(CACHE / sub)
os.environ.setdefault("USE_FLAX", "0")
# one process, few threads: the host's dispatch of eager kernels sets the
# pace of some cells, and idle thread pools only contend with it
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[var] = "1"
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def finite(x):
    """``x`` with every non-finite number as 1e308 (strict JSON)."""
    if isinstance(x, dict):
        return {k: finite(v) for k, v in x.items()}
    if isinstance(x, list):
        return [finite(v) for v in x]
    if isinstance(x, float) and not (abs(x) <= 1e308):
        return 1e308
    return x


def main(argv=None):
    args = parse(argv)
    import torch

    import justrelax_tpu_torch  # noqa: F401  (a checkout without the port stops here)
    from perfbench.core import harness

    chips = int(harness.benchmark_cell(args.workload).get("chips", 1))
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"perfbench: {args.workload} needs {chips} CUDA device(s), found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    result, worst = harness.run_cell(args.workload, args.seed, args.seconds, args.trace,
                                     "cuda:0", T_PROCESS)
    print(json.dumps(finite(result)), flush=True)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r} (worst: {worst.get(name)})",
              file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
