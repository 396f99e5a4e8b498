"""Seconds per fit inside the random-effect coordinates' ``cd.step`` spans
(the program's spans, over the whole traced run's window)."""


def read(obs):
    coords = set(obs.info.get("random_effects", ()))
    spans = [s for s in obs.spans
             if s.get("name") == "cd.step" and s.get("coordinate") in coords]
    if not spans or not obs.completed:
        return None
    return sum(s["seconds"] for s in spans) / obs.completed
