"""Set-up seconds: import, kernel libraries from the build cache, the
cell's data drawn from the seed, the dataset builds and one untimed unit,
on the benchmark's clock."""


def read(obs):
    return obs.setup_seconds
