"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the NVIDIA cards the cell
asks for (``BENCHMARK.json``). The last line of standard output is the
result's JSON object; the last lines of standard error give each number
compared with its limit. Without a card, or with too few, it prints no
result and exits with 2.
"""

import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
BUILD = ROOT / "build"

# every build and kernel cache inside the checkout, at fixed paths, set
# before torch is imported (the port builds its kernels under build/kernels)
os.environ["TRITON_CACHE_DIR"] = str(BUILD / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(BUILD / "torch_extensions")
os.environ["CUDA_CACHE_PATH"] = str(BUILD / "cuda_cache")

# the checkout's root, not this directory, leads the import path: the
# benchmark is the package ``benchmark`` and the program is found beside it
sys.path[0] = str(ROOT)

from benchmark.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
