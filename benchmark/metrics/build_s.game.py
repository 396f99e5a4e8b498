"""Seconds of the dataset build in set-up: ``GameData.build`` of both
splits and ``GameEstimator.prepare``, on the benchmark's clock."""


def read(obs):
    return obs.info.get("build_s")
