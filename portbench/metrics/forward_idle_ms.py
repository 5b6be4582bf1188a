"""``ops.fused``'s host launch work: the card's idle ms a traced call in
the gaps of ``device_idle_pct`` (at least 20 us) whose middle lies under
an ``epnn.select.*`` or ``epnn.forward.*`` span of the program (the
selection, the features, the message and pass rounds;
``portbench.spans``).  Nothing where the program records no such span or
the card ran nothing."""

from portbench import spans


def read(ctx):
    s = spans.of_run()
    if not s or not s["calls"] or not s["device_records"]:
        return None
    return (spans.under(s["idle_s"], "epnn.select.", "epnn.forward.") * 1e3
            / s["calls"])
