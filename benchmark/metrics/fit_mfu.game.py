"""The traced fits' share of the chip's roofline peak, %: the work charged
at the algorithm's evaluation points (frozen counts) at the peak's rate
over the traced window's wall."""

from benchmark.devtrace import mfu


def read(obs):
    return mfu(obs)
