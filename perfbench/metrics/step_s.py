"""Wall time of a model step: the window's host-clock time over the whole
steps it held (every step boundary read after a synchronise)."""


def read(rec):
    steps = rec.steps
    if not steps:
        return None
    return (steps[-1]["t1"] - steps[0]["t0"]) / len(steps)
