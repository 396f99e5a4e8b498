"""Seconds per GAME fit: the whole measured window over the fits it
completed."""


def read(obs):
    return obs.window_seconds / obs.completed if obs.completed else None
