"""Per-layer metrics, one reader a file: ``read(ctx)`` takes a
``portbench.run.Context`` and returns the metric's value, or None where
the run gave it nothing to read (the harness then leaves the metric out
of the result).  The harness reads metric ``<name>`` with
``metrics/<name>.py`` where that file exists, else with the reader of the
name's part before its first dot (``mfu.cold`` and ``mfu.md`` are both
``mfu.py``: one quantity, split by the end-to-end metric it moves)."""
