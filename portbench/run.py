"""One run of one cell of ``BENCHMARK.json`` on one card:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Set-up draws the configuration's weights on the card (from its fixed
``weights.seed``) and every call's inputs from the run's seed, builds the
port's ``Predictor`` and warms it up on the cell's own calls.  Then one
caller sends calls back to back for ``--seconds`` (a closed loop: a
simulation code waits for its charges before its next step), each a
``Predictor.predict_batch`` that ends with the charges on the host.  With
``--trace 1`` the profiler records the first ``trace_seconds`` of the
window, the per-layer metrics are read from it and from the untraced rest
of the window.  Once the window has closed and the program's state is
freed, the float64 reference judges a sample of the calls
(``portbench.compare``).  The last line of standard output is the
result's JSON object; the numbers compared, each beside its limit, are
the last lines of standard error."""

from __future__ import annotations

import argparse
import dataclasses
import importlib
import importlib.util
import json
import os
import subprocess
import sys
import time
import traceback

_T_IMPORT = time.time()
HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

#: top-level module names that may not be loaded in a run
FORBIDDEN = ("jax", "jaxlib", "flax", "epnn_tpu")
#: a configuration's stated precision, as the port's precision fields:
#: (matmul_precision, dense_matmul_precision).  "parity" is the port's
#: CLI serving policy: the far field at one TF32 pass, the rest "highest"
TIERS = {"highest": ("highest", ""), "parity": ("highest", "default"),
         "default": ("default", "")}


def process_start() -> float:
    """The process's start on the ``time.time()`` clock (from /proc; the
    module's import time where that cannot be read)."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            btime = next(int(line.split()[1]) for line in f
                         if line.startswith("btime"))
        start = btime + ticks / os.sysconf("SC_CLK_TCK")
        return start if 0 <= _T_IMPORT - start < 600 else _T_IMPORT
    except (OSError, ValueError, StopIteration, IndexError):
        return _T_IMPORT


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, root: str = ROOT) -> dict:
    """Everything a run of cell ``name`` reads, found by the names in
    ``BENCHMARK.json``: its configuration file, traffic file, limits, and
    the metrics it reports."""
    bench = _json(os.path.join(root, "BENCHMARK.json"))
    cell = next((w for w in bench["workloads"] if w["name"] == name), None)
    if cell is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    cfg = next(c for c in bench["configs"] if c["name"] == cell["config"])
    e2e = [m for m in bench["end_to_end"]
           if name in m.get("workloads", [name])]
    reported = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if name in m.get("workloads", [name] if m["moves"] in reported
                              else [])]
    return dict(
        name=name, cell=cell, chips=int(cell["chips"]),
        config=_json(os.path.join(root, cfg["file"])),
        traffic=_json(os.path.join(HERE, "traffic", cell["traffic"]
                                   + ".json")),
        limits=_json(os.path.join(HERE, "limits", name + ".json")),
        end_to_end=e2e, per_layer=layer)


def reader(metric: str):
    """The reader of per-layer metric ``metric``: ``metrics/<metric>.py``,
    else the reader of the name's part before its first dot."""
    for stem in (metric, metric.split(".")[0]):
        path = os.path.join(HERE, "metrics", stem + ".py")
        if os.path.exists(path):
            spec = importlib.util.spec_from_file_location(
                f"portbench.metrics.{stem.replace('.', '_')}", path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            return mod
    raise SystemExit(f"no reader for per-layer metric {metric!r}")


def precisions(tier: str) -> tuple:
    """(main, far field) precision names of a stated tier."""
    main, dense = TIERS[tier]
    return main, dense or main


def model_config(cfg_spec: dict, precision: str = None):
    """The port's ``EPNNConfig`` of a configuration file, at its stated
    precision tier (or ``precision``)."""
    from epnn_tpu_torch.models.config import EPNNConfig

    m = dict(cfg_spec["model"])
    m["mlp_hidden"] = tuple(m["mlp_hidden"])
    main, dense = TIERS[precision or cfg_spec["precision"]]
    return EPNNConfig(**m, highest_precision=main == "highest",
                      matmul_precision=main, dense_matmul_precision=dense)


@dataclasses.dataclass
class Context:
    """What a per-layer metric reads (``portbench/metrics/<name>.py``,
    ``read(ctx)``): the model, the peaks of its precision tiers
    (``main_peak`` for every product but the far field's, ``far_peak``),
    the traced window's device table (``portbench.trace.read``, with
    ``calls``, the calls in it, and ``window_s``, its length on the host
    clock), one shape record a graph of the traced calls (``n``,
    ``n_pad``, ``k``, ``pairs``, ``rows``, ``cols``), the untraced rest of
    the window (``seconds``, ``calls``, ``lat``, each call's seconds,
    ``least_s``, the least time of its products at the tiers' peaks) and
    the program's counters over the whole window."""

    model: dict
    main_peak: float
    far_peak: float
    trace: dict = None
    graphs: list = dataclasses.field(default_factory=list)
    tail: dict = None
    counters: dict = dataclasses.field(default_factory=dict)


class Shapes:
    """The benchmark's own count of each call's graphs (``shapes.count``):
    ``k``, the neighbor slots of the program's table (from the largest
    count within the selection's cutoff, the model's plus the skin), and
    ``pairs`` and ``rows`` within the model's cutoff.  ``k`` is counted
    once a ``frames`` pool box, unshifted, and once a walk, at its first
    window call: the walk moves atoms far less than the eight slots
    ``safe_k`` rounds to."""

    def __init__(self, traffic, model, skin, device):
        self.traffic, self.model, self.device = traffic, model, device
        self.skin, self._k = skin, {}

    def _count(self, xyz, cutoff) -> tuple:
        from portbench import shapes

        return shapes.count(xyz, self.traffic.n, cutoff, self.device)

    def k_of(self, c, g) -> int:
        from portbench.frozen import work

        t = self.traffic
        key = t.box(c, g) if t.kind == "frames" else "walk"
        if key not in self._k:
            xyz = (t.pool[key] if t.kind == "frames"
                   else t.coordinates([c])[c][g])
            top = self._count(xyz, self.model["cutoff"] + self.skin)[0]
            self._k[key] = work.safe_k(top, t.n_pad)
        return self._k[key]

    def exact(self, calls) -> list:
        """[record, ...] of every graph of ``calls`` (``n``, ``n_pad``,
        ``k``, ``pairs``, ``rows``, ``cols``); without a skin, ``k`` from
        the graph's own count."""
        from portbench.frozen import work

        t, out = self.traffic, []
        cols = t.n if self.model["mask_messages"] else t.n_pad
        for c, xyz in t.coordinates(list(calls)).items():
            for g in range(t.b):
                top, pairs, rows = self._count(xyz[g], self.model["cutoff"])
                k = (work.safe_k(top, t.n_pad) if self.skin == 0
                     else self.k_of(c, g))
                out.append(dict(n=t.n, n_pad=t.n_pad, k=k, pairs=pairs,
                                rows=rows, cols=cols))
        return out


def _sample(seed: int, calls: list, n: int) -> list:
    from portbench.generator import _rng

    return [int(c) for c in _rng(seed, 9).choice(
        calls, size=min(n, len(calls)), replace=False)]


def judged_calls(seed: int, calls: list, rebuilt: list, traffic_spec: dict,
                 good: dict) -> list:
    """The calls the reference judges: ``check_calls`` drawn from the
    seed, the last call where ``check_last``, and one call drawn from
    those that selected their neighbors anew where ``check_rebuild``."""
    pick = _sample(seed, calls, int(traffic_spec["check_calls"]))
    if traffic_spec.get("check_last") and calls:
        pick.append(calls[-1])
    if traffic_spec.get("check_rebuild") and rebuilt:
        pick += _sample(seed + 1, rebuilt, 1)
    return sorted({c for c in pick if c in good})


def run_cell(spec: dict, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_start: float = None,
             precision: str = None, fault=None, control: str = None) -> dict:
    """One run; returns the result object (with ``checks``, last, and
    ``judged``, what the check saw).  ``precision`` runs the program at
    another tier (the control of a cell stated at 3xTF32);
    ``control="bf16_far"`` judges, in the program's place, the reference
    with its far-field products in bfloat16 (the control of a cell whose
    far field is stated at one TF32 pass); ``fault(predictor)`` may break
    the program before the window (the harness's own tests)."""
    import numpy as np
    import torch

    from epnn_tpu_torch.data.dataset import pad_molecules
    from epnn_tpu_torch.data.xyz import Molecule
    from epnn_tpu_torch.elements import table_for_n_elems
    from epnn_tpu_torch.infer import Predictor
    from portbench import compare, generator
    from portbench import trace as tr
    from portbench import weights
    from portbench.frozen import peaks, work

    t_start = process_start() if t_start is None else t_start
    marks = [("imports", time.time())]
    dev = torch.device(device)
    cfg_spec, traffic_spec = spec["config"], spec["traffic"]
    model = dict(cfg_spec["model"])
    tier = precision or cfg_spec["precision"]
    cfg = model_config(cfg_spec, tier)
    tree = weights.load(cfg_spec, dev)
    pred = Predictor(tree, cfg, device=device,
                     **traffic_spec.get("predictor", {}))
    if fault is not None:
        fault(pred)
    marks.append(("weights and Predictor", time.time()))
    traffic = generator.Traffic(traffic_spec, model["n_elems"], seed, dev,
                                pad_molecules, Molecule,
                                table_for_n_elems(model["n_elems"]))
    marks.append(("traffic", time.time()))

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    c = 0
    for _ in range(int(traffic_spec["warmup_calls"])):
        pred.predict_batch(traffic.batch(c))
        c += 1
        marks.append((f"warm-up call {c}", time.time()))
    if trace:
        # the profiler's first start loads CUPTI, seconds of it: in set-up
        with tr.profiler(dev):
            pred.predict_batch(traffic.batch(c))
        c += 1
    sync()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    setup_s = time.time() - t_start
    marks.append(("profiler" if trace else "sync", time.time()))
    phases = " ".join(f"{n} {b - a:.2f}" for (_, a), (n, b) in zip(
        [("start", t_start)] + marks[:-1], marks))

    # -- the window ----------------------------------------------------------
    first, outs, lat, rebuilt = c, {}, [], []
    rebuilds0 = rebuilds = getattr(pred, "skin_rebuilds", 0)
    trace_s = float(traffic_spec["trace_seconds"]) if trace else 0.0
    prof, prof_done, trace_window, c_tail = None, None, 0.0, None
    if trace:
        prof = tr.profiler(dev)
        prof.start()
    t0 = time.perf_counter()
    deadline = t0 + seconds
    t_tail = None
    while True:
        now = time.perf_counter()
        if prof is not None and now - t0 >= trace_s:
            prof.stop()
            trace_window, prof_done, prof = now - t0, prof, None
            t_tail, c_tail = time.perf_counter(), c
        if now >= deadline:
            break
        batch = traffic.batch(c)
        a = time.perf_counter()
        try:
            q = pred.predict_batch(batch)
        except Exception as exc:                      # noqa: BLE001
            # a call that raises is a failed answer; the run goes on
            if not any(isinstance(v, Exception) for v in outs.values()):
                traceback.print_exc(file=sys.stderr)
            q = exc
        lat.append(time.perf_counter() - a)
        now_rebuilds = getattr(pred, "skin_rebuilds", 0)
        if now_rebuilds != rebuilds:
            rebuilt.append(c)
            rebuilds = now_rebuilds
        outs[c] = q
        c += 1
    t1 = time.perf_counter()
    if prof is not None:                 # the whole window was traced
        prof.stop()
        trace_window, prof_done = t1 - t0, prof
        t_tail, c_tail = t1, c
    calls = list(range(first, c))
    memory_peak = (torch.cuda.max_memory_allocated(dev)
                   if dev.type == "cuda" else 0)
    counters = dict(skin_rebuilds=rebuilds - rebuilds0, calls=len(calls))

    # -- every answer: there, finite, of its shape ---------------------------
    shape = (traffic.b, traffic.n_pad)
    good, failed = {}, 0
    for cc in calls:
        q = outs[cc]
        if (isinstance(q, Exception) or np.shape(q) != shape
                or not np.isfinite(q[:, :traffic.n]).all()):
            failed += 1
            continue
        good[cc] = q

    # -- per-layer readings --------------------------------------------------
    main, far = precisions(tier)
    layer_metrics, breakdown, device_extra = {}, None, {}
    if trace and spec["per_layer"]:
        table = tr.read(prof_done)
        traced = [cc for cc in calls if cc < c_tail]
        tail_calls = [cc for cc in calls if cc >= c_tail]
        table.update(window_s=trace_window, calls=len(traced))
        skin = float(traffic_spec.get("predictor", {}).get("neighbor_skin",
                                                            0.0))
        count = Shapes(traffic, model, skin, dev)
        ctx = Context(model=model, main_peak=peaks.tier_flops(main),
                      far_peak=peaks.tier_flops(far), trace=table,
                      graphs=count.exact(traced) if traced else [],
                      counters=counters)
        least = 0.0
        for cc in tail_calls:
            f = work.call_flops(model, [traffic.n_pad] * traffic.b,
                                [count.k_of(cc, g) for g in range(traffic.b)])
            least += f["far"] / ctx.far_peak + f["rest"] / ctx.main_peak
        ctx.tail = dict(seconds=t1 - t_tail, calls=len(tail_calls),
                        lat=lat[len(traced):], least_s=least)
        for m in spec["per_layer"]:
            v = reader(m["name"]).read(ctx)
            if v is not None:
                layer_metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        breakdown = {"device_ops": tr.top(table["kernels"]),
                     "idle_gaps": tr.top(table["gaps"])}
        device_extra = {"busy_s": table["busy_s"], "window_s": trace_window}
        del prof_done

    # -- the reference, once the program's state is gone ---------------------
    del pred, tree
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    limits = spec["limits"]
    picked = judged_calls(seed, calls, rebuilt, traffic_spec, good)
    graphs = traffic.graphs(picked)
    t_check = time.perf_counter()
    ref_tree = weights.load(cfg_spec, dev)
    for g in graphs:
        g["q"] = (good[g["call"]][g["graph"]] if control is None else
                  compare.control_charges(control, g, ref_tree, model, dev))
    numbers = compare.judge(graphs, ref_tree, model, limits["q_gap"], dev)
    checks = {k: {"value": numbers[k], "limit": v} for k, v in limits.items()}
    correct = (failed == 0 and len(graphs) >= traffic.b and all(
        v["value"] <= v["limit"] for v in checks.values()))

    # -- end-to-end metrics --------------------------------------------------
    metrics = {}
    done = len(calls) - failed
    if not trace and done > 0 and lat:
        per_call = (t1 - t0) * 1e3 / done
        e2e = {"call_ms": per_call, "frame_ms": per_call,
               "call_p95_ms": float(np.percentile(np.asarray(lat) * 1e3,
                                                  95)),
               "setup_s": setup_s}
        for m in spec["end_to_end"]:
            if m["name"] in e2e:
                metrics[m["name"]] = {"value": e2e[m["name"]],
                                      "unit": m["unit"]}
    elif trace:
        metrics = layer_metrics
    if dev.type == "cuda":
        kind, platform = torch.cuda.get_device_name(dev), "gpu"
    else:
        kind, platform = "cpu", "cpu"
    result = {"correct": bool(correct), "attempted": len(calls),
              "failed": failed, "metrics": metrics,
              "device": dict(platform=platform, kind=kind, count=1,
                             memory_peak_bytes=int(memory_peak),
                             **device_extra)}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["judged"] = {"graphs": len(graphs), "calls": picked,
                        "rebuilt": len(rebuilt), "setup_s": setup_s,
                        "phases": phases,
                        "quartiles_ms": [round(float(v) * 1e3, 3) for v in (
                            np.percentile(lat, [25, 50, 75, 95]) if lat
                            else [])],
                        "check_s": time.perf_counter() - t_check,
                        **{k: numbers[k] for k in (
                            "q_gap_raw", "q_rms", "q_max", "sum_gap",
                            "gate_ties", "ties_set")}}
    result["checks"] = checks
    return result


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def power_limit() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them, or
    ``"not read"``."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().splitlines()[0] if out.stdout else \
            "not read"
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def main(argv=None) -> int:
    t_start = process_start()
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    spec = load_cell(args.workload)
    import torch

    found = (torch.cuda.device_count() if torch.cuda.is_available() else 0)
    if found < spec["chips"]:
        print(f"portbench: the cell needs {spec['chips']} CUDA device(s); "
              f"found {found}", file=sys.stderr)
        return 2
    result = run_cell(spec, args.seed, args.seconds, bool(args.trace),
                      "cuda", t_start)
    loaded = forbidden_modules()
    if loaded:
        print(f"portbench: loaded in this process: {', '.join(loaded)}",
              file=sys.stderr)
        return 3
    result["device"]["power_limit"] = power_limit()
    judged = result.pop("judged")
    print(f"judged {judged['graphs']} graph(s) of calls {judged['calls']} "
          f"({judged['rebuilt']} call(s) of the window selected anew); "
          f"gate ties {judged['gate_ties']:.0f}, set the other way "
          f"{judged['ties_set']:.0f} (gap before {judged['q_gap_raw']!r} e); "
          f"RMS gap {judged['q_rms']!r} e; "
          f"max |q_ref| {judged['q_max']!r}; |sum q - Q| "
          f"{judged['sum_gap']!r}; calls' 25/50/75/95th percentiles "
          f"{judged['quartiles_ms']} ms; set-up {judged['setup_s']:.2f} s "
          f"({judged['phases']}); "
          f"check {judged['check_s']:.1f} s; "
          f"{result['device']['power_limit']}", file=sys.stderr)
    for name, v in result["checks"].items():
        print(f"check {name} = {v['value']!r} (limit {v['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
