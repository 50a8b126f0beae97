"""One run of one cell of ``BENCHMARK.json``: ``python3 benchmark/run.py --workload <cell>
--seed <n> --seconds <s> --trace <0|1>``.

Prints one JSON line last on standard output (see ``benchmark/README.md``).
Exits with 2 and no result where no GPU (or too few) is found or a file of
the cell is missing, and with 3 where the process loaded JAX or the JAX
package.
"""

import time

T_PROCESS = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
CACHE = os.path.join(BENCH, ".cache")  # every build and kernel cache, inside the checkout
for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TORCHINDUCTOR_CACHE_DIR", "inductor"), ("CUDA_CACHE_PATH", "nv")):
    os.environ[var] = os.path.join(CACHE, sub)
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"
if sys.path[0] != ROOT:
    sys.path.insert(0, ROOT)

from benchmark.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t_process=T_PROCESS))
