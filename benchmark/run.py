#!/usr/bin/env python3
"""Run one benchmark cell of photon_ml_tpu_torch on the card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cell is ``benchmark/workloads/<cell>.json``; its configuration, driver
and metric readers are found from it by name (see ``benchmark/harness.py``).
The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device`` and, with ``--trace 1``,
``breakdown``, then ``checks``: each number compared with the plain
reference beside its limit. The same numbers end standard error.
"""

import time

_T0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the checkout's root, not this folder, heads the import path: a module
# here must never shadow one of the standard library
sys.path[0] = _ROOT

# every build and kernel cache at a fixed path inside the checkout, so that
# only a checkout's first run builds (the port's own libraries already land
# under build/ there); nothing may load JAX behind the port's back
_CACHE = os.path.join(_ROOT, "build", "bench_cache")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(_CACHE, "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(_CACHE, "triton")
os.environ["PYTORCH_KERNEL_CACHE_PATH"] = os.path.join(_CACHE, "torch_kernels")
os.environ["CUDA_CACHE_PATH"] = os.path.join(_CACHE, "cuda_compute")
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"


def main(argv=None) -> int:
    from benchmark import harness

    return harness.main(argv, started=_T0)


if __name__ == "__main__":
    sys.exit(main())
