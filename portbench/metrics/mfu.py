"""The whole call's share of the card's peak (%): the least time the
model's products of the calls need, each at the peak of the precision
tier it runs at (``frozen.work.call_flops``, from the calls' shapes;
``frozen.peaks.tier_flops``), over the seconds the calls took, in the part
of a traced run's window after the profiler stopped."""


def read(ctx):
    tail = ctx.tail
    if not tail or tail["calls"] <= 0 or tail["seconds"] <= 0:
        return None
    return 100.0 * tail["least_s"] / tail["seconds"]
