"""Share of the traced window in which no operation runs on the device, %
(``torch.profiler``'s CUDA activity)."""

from benchmark.devtrace import idle_share


def read(obs):
    return idle_share(obs)
