"""Cells of ``BENCHMARK.json`` cut to sizes a CPU test holds: the same
configuration and traffic files, with fewer waters, boxes and calls, and
the limit of those sizes (:data:`LIMITS`)."""

from portbench import run

CELLS = ["decay_model.frames-35520", "decay_model_parity.md-skin-35520"]
MD = CELLS[1]
#: the decay model's message gain is ≈ 2.2 / N (its file's, at N = 35,520)
GAIN_TIMES_N = 2.2
#: the limit at these sizes.  The CPU runs the program in float32 at every
#: tier (no TF32): at 300 atoms sound runs read 5e-6–1e-5 e and the
#: controls 2.3e-3–4.3e-3 e; the cells' own limits are set at 35,520
#: atoms on the card, where one TF32 pass of the far field alone reads
#: 2.5e-3–3.6e-3 e, and the card tests hold the cells to them
LIMITS = {"q_gap": 3e-4}


def spec(workload: str, molecules: int = 100, graphs: int = None,
         check_calls: int = None) -> dict:
    s = run.load_cell(workload)
    t = dict(s["traffic"], molecules=molecules, pool=4, trace_seconds=0.5,
             warmup_calls=1)
    if check_calls is not None:
        t["check_calls"] = check_calls
    if graphs is not None:
        t["graphs_per_call"] = graphs
    cfg = dict(s["config"])
    if cfg["weights"]["kind"] == "seeded":
        cfg["weights"] = dict(cfg["weights"],
                              message_out_gain=GAIN_TIMES_N / (3 * molecules))
    return dict(s, traffic=t, config=cfg, limits=dict(LIMITS))
