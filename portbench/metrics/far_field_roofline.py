"""``dense_message_rowsum``'s share of its roofline (%): the least time the
far field of the traced calls needs over the device time of its kernels
(``frozen.groups.FAR_FIELD``).  The least time of one message round of
one graph is max(products / the far field's tier peak, bytes / HBM
bandwidth) over its live pairs (``frozen.work.far_field``), for T − 1
rounds a graph: round 1's far field collapses exactly to the element
grid.  Nothing where the kernel did not run."""

from portbench.frozen import groups, peaks, work


def least_s(model, g, flops_per_s) -> float:
    w = work.far_field(g["n_pad"], g["n_pad"], model["mlp_hidden"][0],
                       live=g["cols"])
    return (model["T"] - 1) * max(w.products / flops_per_s,
                                  w.bytes / peaks.HBM_BYTES_PER_S)


def read(ctx):
    t = ctx.trace
    if not t:
        return None
    dev = groups.matching(t["kernels"], groups.FAR_FIELD)
    if dev <= 0 or not ctx.graphs:
        return None
    return 100.0 * sum(least_s(ctx.model, g, ctx.far_peak)
                       for g in ctx.graphs) / dev
