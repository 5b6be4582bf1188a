"""``ops.fused``'s neighbor selection on the card: device ms a traced
call of the kernels, copies and fills launched under an ``epnn.select.*``
span of the program (``count_only`` and its read, the cell builder or
top-k, the skin tables' d² refresh), each matched to its CUDA launch
record by correlation id (``portbench.spans``).  Nothing where the
program records no such span or the card ran nothing."""

from portbench import spans


def read(ctx):
    s = spans.of_run()
    if not s or not s["calls"] or not s["device_records"]:
        return None
    return spans.under(s["device_s"], "epnn.select.") * 1e3 / s["calls"]
