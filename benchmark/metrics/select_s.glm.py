"""Seconds per sweep in ``validate_and_select``, on the benchmark's
clock."""


def read(obs):
    if "select_s" not in obs.clock or not obs.completed:
        return None
    return obs.clock["select_s"] / obs.completed
