"""``infer.Predictor``'s waits on the card: the program's counter
``counters["host_syncs"]`` (each host→device copy, scalar read and
readback at which the host waits on the device's stream) a call, over
every call of the run's ``Predictor``, warm-up included: the harness
keeps no count at the window's start, and its calls before the window are
the cell's own (a cold call each, or the walk's first frames).  Nothing
where the program has no such counter."""

from portbench import spans


def read(ctx):
    loc = spans.harness()
    counters = getattr(loc and loc.get("pred"), "counters", None)
    if not isinstance(counters, dict) or not counters.get("calls") \
            or "host_syncs" not in counters:
        return None
    return counters["host_syncs"] / counters["calls"]
