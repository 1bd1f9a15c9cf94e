"""Run one cell of the port's benchmark and print its result line.

    python portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The kernels' build cache and every other cache
the program may write live under portbench/.cache/ in the checkout, at fixed
paths, so that only a checkout's first run builds.
"""
import time

T0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def cache_env():
    """Every build and kernel cache inside the checkout; no JAX by way of a
    library that would load it by itself."""
    cache = os.path.join(ROOT, "portbench", ".cache")
    os.environ["VIBEVOICE_TORCH_BUILD_DIR"] = os.path.join(cache, "nvcc")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = os.path.join(cache, "inductor")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


if __name__ == "__main__":
    cache_env()
    sys.path.insert(0, ROOT)
    from portbench.harness import main
    sys.exit(main(sys.argv[1:], T0))
