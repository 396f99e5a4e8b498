"""Build, load and call the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into a shared library with a
plain C interface, loaded through :mod:`ctypes` (no PyTorch headers, so a
build takes seconds). Libraries land at first use under
``build/torch_kernels/`` at the root of the checkout, keyed on a hash of the
sources and flags, so an edited kernel never loads a stale build.
:func:`build` starts one ``nvcc`` per source at once and waits for all.

Nothing here runs at import time: this module imports on a machine without
``nvcc`` or a card, and only a launch on a CUDA tensor asks for a library.
:func:`check_args` is the wrappers' shared check of what a kernel takes.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: the kernels' design storage types (csrc/glm_common.cuh ``F32``/``BF16``)
DTYPE_IDS = {torch.float32: 0, torch.bfloat16: 1}
#: shared memory one block may use on Hopper (csrc/glm_common.cuh)
MAX_BLOCK_SMEM_BYTES = 232_448


def _group_size(d: int) -> int:
    g = 1
    while g < d and g < 32:
        g <<= 1
    return g


def block_smem_bytes(d: int, threads: int, lanes: int = 1) -> int:
    """Dynamic shared memory of one kernel block (``block_smem_bytes`` of
    csrc/glm_common.cuh): ``lanes`` coefficient rows of width ``d``, and a
    gradient and a value partial per lane for each row group."""
    groups = threads // _group_size(d)
    return 4 * lanes * (d + groups * d + groups)


def max_row_width(lanes: int = 1) -> int:
    """Widest row a kernel takes for ``lanes`` coefficient rows: the rows
    and one row group's partials must fit one block's shared memory."""
    d = (MAX_BLOCK_SMEM_BYTES // (4 * lanes) - 1) // 2  # one 32-wide group
    while d > 0 and block_smem_bytes(d, 32, lanes) > MAX_BLOCK_SMEM_BYTES:
        d -= 1
    return d


#: widest row the one-lane kernels take (1, 2 and 3)
MAX_ROW_WIDTH = max_row_width(1)
#: ctypes type of a device pointer or a stream
PTR = ctypes.c_void_p

#: loaded libraries of this process, by source name
_LOADED: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError(
            "nvcc not found (neither on PATH nor under CUDA_HOME): the port's "
            "CUDA kernels are built from photon_ml_tpu_torch/csrc at first use")
    return str(path)


def library_path(name: str) -> Path:
    """Where the library of ``csrc/<name>.cu`` lives for the current sources."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_ROOT / f"{name}-{h.hexdigest()[:16]}" / f"lib{name}.so"


def build(names) -> dict[str, dict]:
    """Build the libraries of ``names`` that are not built yet, one ``nvcc``
    per source, all started together. Returns ``{name: {"seconds", "log",
    "cached"}}``; raises with the compiler's output if any build fails."""
    started = {}
    report = {}
    t0 = time.perf_counter()
    for name in names:
        out = library_path(name)
        if out.exists():
            report[name] = {"seconds": 0.0, "log": "", "cached": True}
            continue
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        started[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp, out)
    failed = []
    for name, (proc, tmp, out) in started.items():
        log, _ = proc.communicate()
        report[name] = {"seconds": time.perf_counter() - t0, "log": log,
                        "cached": False}
        if proc.returncode != 0:
            failed.append(f"--- {name} (nvcc exit {proc.returncode}) ---\n{log}")
            continue
        os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
        (out.parent / "build.log").write_text(log)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return report


def load(name: str, signature: dict) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (built first if needed), with
    ``signature`` (``{function: argtypes}``, every function returning a
    CUDA error code as ``int``) declared on it."""
    lib = _LOADED.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        for fn, argtypes in signature.items():
            f = getattr(lib, fn)
            f.argtypes = list(argtypes)
            f.restype = ctypes.c_int
        _LOADED[name] = lib
    return lib


def check(name: str, code: int) -> None:
    """Raise if a kernel's C entry point reported a CUDA error."""
    if code != 0:
        raise RuntimeError(f"{name}: CUDA kernel launch failed with error "
                           f"code {code}")


def check_args(fn: str, x, layout: str, lanes: int = 1,
               **others) -> tuple[int, ...]:
    """Check what a kernel takes and return ``x.shape``: ``x`` is float32 or
    bfloat16 with one dimension per letter of ``layout`` (``"nd"``,
    ``"esd"``), the last at most :func:`max_row_width` of ``lanes``; each of
    ``others`` is ``name=(tensor, dims)``, a float32 tensor whose shape is
    ``dims``, in letters of ``layout`` and ``m`` (= ``lanes``); all
    contiguous on ``x``'s device."""
    if x.dim() != len(layout) or x.dtype not in DTYPE_IDS:
        raise ValueError(
            f"{fn}: x must be ({', '.join(layout)}) float32 or bfloat16, got "
            f"{tuple(x.shape)} {x.dtype}")
    size = dict(zip(layout, x.shape), m=lanes)
    width = max_row_width(lanes)
    if x.shape[-1] > width:
        raise ValueError(f"{fn}: rows of {x.shape[-1]} exceed the kernel's "
                         f"{width}-column shared-memory plan for {lanes} "
                         "coefficient row(s): not even one warp's partials "
                         "fit a block")
    for name, (t, dims) in others.items():
        shape = tuple(size[c] for c in dims)
        if tuple(t.shape) != shape or t.dtype != torch.float32:
            raise ValueError(f"{fn}: {name} must be float32 {shape}, got "
                             f"{tuple(t.shape)} {t.dtype}")
    for name, t in (("x", x), *((k, v[0]) for k, v in others.items())):
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f"{fn}: {name} must be contiguous on {x.device}")
    return tuple(x.shape)
