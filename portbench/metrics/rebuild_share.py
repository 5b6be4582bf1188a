"""``infer.Predictor``'s Verlet-skin selections: the program's counter
``skin_rebuilds``, its change over the window, as a share of the frames
the window completed (%)."""


def read(ctx):
    n = ctx.counters.get("calls", 0)
    if n <= 0 or "skin_rebuilds" not in ctx.counters:
        return None
    return 100.0 * ctx.counters["skin_rebuilds"] / n
