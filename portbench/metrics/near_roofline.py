"""``near_message_corr`` and ``near_pass_rowsum`` together, their share of
their roofline (%): the least time over their device time in the traced
window.  A round of a graph needs, for each pair within the cutoff, rbf @
W1e and two H × H products at the near kernels' tier peak, and its bytes
over those live slots (``frozen.work.near``), whichever bounds; T message
rounds and T pass rounds a graph."""

from portbench.frozen import groups, peaks, work


def least_s(model, g, flops_per_s) -> float:
    h, e = model["mlp_hidden"][0], model["e_dim"]
    total = 0.0
    for width in (h, 2 * h):
        w = work.near(g["n_pad"], g["k"], h, e, width, live=g["pairs"],
                      live_rows=g["rows"])
        total += max(w.products / flops_per_s,
                     w.bytes / peaks.HBM_BYTES_PER_S)
    return model["T"] * total


def read(ctx):
    t = ctx.trace
    if not t:
        return None
    dev = groups.matching(t["kernels"], groups.NEAR)
    if dev <= 0 or not ctx.graphs:
        return None
    return 100.0 * sum(least_s(ctx.model, g, ctx.main_peak)
                       for g in ctx.graphs) / dev
