"""Run one benchmark cell and print its result as the last line:

    python3 vio_bench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout on a machine with the cell's CUDA devices.
Exits non-zero, with no result, where CUDA or the port is missing or a
module of JAX or the JAX package was loaded."""
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
# every build and kernel cache at a fixed path inside the checkout (the
# port builds its kernels into orcvio_tpu_torch/_build/ by itself)
CACHE = ROOT / "vio_bench" / "_cache"
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
sys.path.insert(0, str(ROOT))

from vio_bench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main())
