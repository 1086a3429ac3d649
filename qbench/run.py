"""Run one benchmark cell once:

    python3 qbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  Prints one JSON line last on stdout (see
``harness.py``); exits non-zero, printing no result, without enough CUDA
devices, without the program under ``src/``, or when JAX or the JAX package
was loaded.
"""
import time

T0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# every kernel cache of the run at a fixed place inside the checkout, so
# only a checkout's first run builds (the port's nvcc build is already
# under build/repro_torch)
for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("CUDA_CACHE_PATH", "nv_compute_cache")):
    os.environ[var] = str(ROOT / "build" / sub)
sys.path.insert(0, str(ROOT))

from qbench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], root=ROOT, t0=T0))
