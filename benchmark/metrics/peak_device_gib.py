"""Peak device memory over set-up and the window, GiB
(``torch.cuda.max_memory_allocated``)."""


def read(obs):
    return obs.peak_bytes / 2**30 if obs.peak_bytes else None
