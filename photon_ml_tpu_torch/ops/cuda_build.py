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


def block_smem_bytes(d: int, threads: int) -> int:
    """Dynamic shared memory of one block of the row-group body
    (``block_smem_bytes`` of csrc/glm_common.cuh; kernel 2's wide rows, and
    kernel 1's wide body with a warp for a group): the coefficient row of
    width ``d``, and a gradient and a value partial for each row group."""
    groups = threads // _group_size(d)
    return 4 * (d + groups * d + groups)


#: widest row the row-group body (kernel 2) and the wide body of kernels 1
#: and 3 take: the row and one 32-wide row group's partials fit one block's
#: shared memory
MAX_ROW_WIDTH = next(d for d in range(MAX_BLOCK_SMEM_BYTES // 8, 0, -1)
                     if block_smem_bytes(d, 32) <= MAX_BLOCK_SMEM_BYTES)

#: kernel 4's plan (csrc/fused_glm_multi.cu): 256 threads (8 warps); ring
#: steps of 2 sub-tiles of 4 rows (4 rows x 8 lanes = 32 margins a
#: sub-tile); rows too wide for whole-row stages streamed in 1024-column
#: chunks through 2 stages at least; a row not 16-byte aligned is staged as
#: the 16-byte granules covering it, 32 bytes more a slot row. Rows of at
#: most 128 columns take a narrow body whose shared memory is far below
#: these limits.
MULTI_THREADS = 256
MULTI_SUB_TILES = 2
MULTI_STEP_ROWS = 4 * MULTI_SUB_TILES
MULTI_CHUNK_COLS = 1024
MULTI_UNALIGNED_PAD_BYTES = 32


def multi_smem_bytes(d: int, lanes: int, cols: int, stages: int,
                     itemsize: int, aligned: bool = False) -> int:
    """Dynamic shared memory of one kernel-4 block (``multi_smem_bytes`` of
    csrc/fused_glm_multi.cu): ``stages`` ring slots of 8 rows x ``cols``
    design columns (and the granule pad of unaligned rows) with their
    label, offset and weight; the ``lanes`` x d gradient accumulator (d
    rounded up to 8); each sub-tile's cross-warp margin partials and dv;
    8 x ``lanes`` value accumulators, all f32."""
    dp = -(-d // 8) * 8
    row = cols * itemsize + (0 if aligned else MULTI_UNALIGNED_PAD_BYTES)
    stage = MULTI_STEP_ROWS * row + 3 * MULTI_STEP_ROWS * 4
    return stages * stage + 4 * (
        lanes * dp + MULTI_SUB_TILES * (MULTI_THREADS + 32)
        + MULTI_STEP_ROWS * lanes)


def max_row_width(lanes: int) -> int:
    """Widest row kernel 4 takes for ``lanes`` coefficient rows, whatever
    its alignment: the gradient accumulator and two stages of unaligned
    1024-column f32 chunks fit one block's shared memory (a bf16 design's
    stages are smaller). A multiple of 8, since the accumulator's rows are
    padded to one."""
    room = MAX_BLOCK_SMEM_BYTES - multi_smem_bytes(0, lanes, MULTI_CHUNK_COLS,
                                                   2, 4)
    return max(0, room // (4 * lanes) // 8 * 8)


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
    "cached"}}``; raises with the compiler's output if any build fails.
    Each nvcc build counts in ``photon_compiles_total{fn="cuda.<name>"}``
    with its wall (a cached library counts nothing)."""
    from photon_ml_tpu_torch.telemetry.profiling import record_compile

    started = {}
    report = {}
    t0 = time.perf_counter()  # photon-lint: disable=tel-perf-counter -- the parallel nvcc builds' walls, one start to each child's exit (the report's seconds, then record_compile's); no registry timer spans child processes
    for name in names:
        out = library_path(name)
        if out.exists():
            report[name] = {"seconds": 0.0, "log": "", "cached": True}
            continue
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        started[name] = (subprocess.Popen(  # photon-lint: disable=res-process -- nvcc children of a build, waited on before build() returns; nothing for the fleet supervisor to track
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp, out)
    failed = []
    for name, (proc, tmp, out) in started.items():
        log, _ = proc.communicate()
        report[name] = {"seconds": time.perf_counter() - t0, "log": log,  # photon-lint: disable=tel-perf-counter -- a build's wall, read as its nvcc child is reaped
                        "cached": False}
        if proc.returncode != 0:
            failed.append(f"--- {name} (nvcc exit {proc.returncode}) ---\n{log}")
            continue
        os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
        (out.parent / "build.log").write_text(log)
        record_compile(f"cuda.{name}", report[name]["seconds"])
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


def check_args(fn: str, x, layout: str, lanes: int | None = None,
               **others) -> tuple[int, ...]:
    """Check what a kernel takes and return ``x.shape``: ``x`` is float32 or
    bfloat16 with one dimension per letter of ``layout`` (``"nd"``,
    ``"esd"``), the last at most :data:`MAX_ROW_WIDTH` or, for kernel 4's
    ``lanes`` coefficient rows, :func:`max_row_width` of ``lanes``; each of
    ``others`` is ``name=(tensor, dims)``, a float32 tensor whose shape is
    ``dims``, in letters of ``layout`` and ``m`` (= ``lanes``); all
    contiguous on ``x``'s device."""
    if x.dim() != len(layout) or x.dtype not in DTYPE_IDS:
        raise ValueError(
            f"{fn}: x must be ({', '.join(layout)}) float32 or bfloat16, got "
            f"{tuple(x.shape)} {x.dtype}")
    size = dict(zip(layout, x.shape), m=lanes)
    if lanes is None:
        width, plan = MAX_ROW_WIDTH, ("row-group shared-memory plan: not "
                                      "even one warp's partials fit a block")
    else:
        width, plan = max_row_width(lanes), (
            f"shared-memory plan for {lanes} coefficient row(s): their "
            "gradient accumulator and two staged chunks do not fit a block")
    if x.shape[-1] > width:
        raise ValueError(f"{fn}: rows of {x.shape[-1]} exceed the kernel's "
                         f"{width}-column {plan}")
    if not x.is_contiguous():
        raise ValueError(f"{fn}: x must be contiguous on {x.device}")
    dev = x.device
    for name, (t, dims) in others.items():
        shape = tuple([size[c] for c in dims])
        if tuple(t.shape) != shape or t.dtype != torch.float32:
            raise ValueError(f"{fn}: {name} must be float32 {shape}, got "
                             f"{tuple(t.shape)} {t.dtype}")
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"{fn}: {name} must be contiguous on {dev}")
    return tuple(x.shape)
