"""Seconds per GLM sweep with its selection: the whole measured window over
the sweeps it completed."""


def read(obs):
    return obs.window_seconds / obs.completed if obs.completed else None
