"""One run of one benchmark cell on the card.

    python3 -m benchmark.run --workload NAME --seed N --seconds S --trace 0|1

Prints progress and, last, each compared number beside its limit on
standard error, and one JSON result line as the last line of standard
output.  Exits non-zero, with no result, without the CUDA devices the cell
asks for, or if JAX or the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

if __name__ == "__main__":
    from benchmark.harness import ROOT, main

    # the driver's CUDA compute cache lives in the checkout, at a fixed path
    os.environ["CUDA_CACHE_PATH"] = str(ROOT / "build" / "cuda-cache")
    sys.exit(main(t_start=T_START))
