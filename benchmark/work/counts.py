"""Frozen copies of the port's kernel count functions.

Each function returns the f32 operations and the bytes one launch must do
and move: every input read once, every output written once, live rows only.
They are copies, kept here so that a later change to the program cannot
change the yardstick it is measured with; ``tests/test_harness_work.py``
checks them against the program's own functions
(``photon_ml_tpu_torch/ops/fused_{glm,re,hvp}.py::work``), so that a drift
is seen and not silently adopted.
"""

from __future__ import annotations

from typing import NamedTuple


class Work(NamedTuple):
    """A launch's analytic work: f32 operations and bytes moved."""

    ops: float
    nbytes: float


def fused_glm(n_live: int, n_rows: int, d: int, itemsize: int, n_out: int,
              lanes: int = 1) -> Work:
    """One evaluation of kernel 1 (``n_out`` = ``lanes`` = 1), kernel 4
    (``n_out`` = ``lanes`` = M coefficient rows sharing X) or kernel 2
    (``n_out`` = E entities, through :func:`fused_re`): X's ``n_live``
    live rows and their label and offset read once, every row's weight
    read once, the ``n_out`` coefficient rows read and the outputs (a
    gradient row and a value each) written once; ~4 f32 operations per
    element of the live rows plus ~10 per live row for the loss, for each
    of the ``lanes`` coefficient rows."""
    nbytes = (n_live * d * itemsize + n_live * 8 + n_rows * 4
              + n_out * d * 4 + n_out * (d + 1) * 4)
    return Work(float(lanes * (4.0 * n_live * d + 10.0 * n_live)),
                float(nbytes))


def fused_re(n_live: int, e: int, s: int, d: int, itemsize: int) -> Work:
    """One evaluation of kernel 2 over an (E, S, D) bucket with ``n_live``
    live rows in all: kernel 1's count over the bucket's E·S rows with E
    coefficient rows and outputs."""
    return fused_glm(n_live, e * s, d, itemsize, e)


def fused_hvp(n_live: int, n_rows: int, d: int, itemsize: int) -> Work:
    """One product of kernel 3: the ``n_live`` rows it reads (those of
    nonzero curvature) read once, every row's d2w read once, v read and the
    output written once; 4 f32 operations per element of those rows."""
    return Work(4.0 * n_live * d,
                float(n_live * d * itemsize + n_rows * 4 + 2 * d * 4))
