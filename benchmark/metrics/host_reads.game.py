"""Host reads of the optimizer drive per unit (``drive.reads``, the
program's counter, over the whole window)."""


def read(obs):
    if "drive.reads" not in obs.counters or not obs.completed:
        return None
    return obs.counters["drive.reads"] / obs.completed
