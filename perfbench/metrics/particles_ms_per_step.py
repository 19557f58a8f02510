"""The particle stage's device time per step: CUDA events around the four
particle calls a model step makes (advection, re-binning, injection, phase
ratios), summed over the window's untraced steps, per step, in ms."""


def read(rec):
    ev = rec.ctx.events
    if ev is None or not ev.pairs:
        return None
    steps = {s["index"] for s in rec.untraced()}
    if not steps:
        return None
    return ev.seconds(lambda tag: tag[0] in steps) / len(steps) * 1e3
