"""``infer.Predictor``'s host steps: the card's idle ms a traced call in
the gaps of ``device_idle_pct`` (at least 20 us) whose middle lies under
an ``epnn.predictor.*`` span of the program (the sort view, fingerprints,
cell-grid bounds, copies, skin checks, readback; ``portbench.spans``).
Nothing where the program records no such span or the card ran
nothing."""

from portbench import spans


def read(ctx):
    s = spans.of_run()
    if not s or not s["calls"] or not s["device_records"]:
        return None
    return spans.under(s["idle_s"], "epnn.predictor.") * 1e3 / s["calls"]
