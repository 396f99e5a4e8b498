"""Kernel ``fused_glm_multi``'s share of its roofline over the traced
units, %: the least time of its launches' frozen counts over its device
time."""

from benchmark.devtrace import roofline_share


def read(obs):
    return roofline_share(obs, "fused_glm_multi")
