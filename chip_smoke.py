#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``epnn_tpu_torch``) on one NVIDIA
card: ``python3 chip_smoke.py`` from the repository root.

1. Device: the card's name and power limit; PyTorch's TF32 flags stay
   off (the port never sets them: plain products are float32 at every
   precision; the tensor-core kernels run 3xTF32 at "high"/"highest" and
   one TF32 pass at "default").
2. Build: the eight CUDA kernels from ``epnn_tpu_torch/csrc`` at the
   shipped widths (H 32, E 48) and at every width of :data:`WIDTH_CASES`,
   and the six tensor-core kernels' one-pass tier at the shipped and the
   timed width, one ``nvcc`` per library, all in parallel; each entry's
   registers and spills, per instantiation and tier.  Every phase but
   (k) and [train e] holds the kernels at precision "highest".
3. Kernels: each kernel against its plain PyTorch version on the card, at
   the shapes of the 2,220-atom water box (the checkpoint's round weights,
   the box's own neighbor table), the same bits on a second launch, and
   again with the inputs it reads one float at a time moved off the
   16-byte boundary; kernel, plain and bound times, the bound counting
   only what this data needs (live pairs and slots).
   The far field and its backward (a seeded cotangent) also against their
   3xTF32 emulations, on a ragged rectangular slice of the same inputs
   (:data:`RAGGED`, zeros in cv), and at 17,760 atoms (in 4c); the
   backward's four outputs against the float64 plain version; bounds from
   the TF32 tensor-core rate (and the fp32 bound beside them); the SM clock
   before and after their timings.  The far field's int8 tier
   (:func:`int8_phase`) on the same inputs at both sizes and on the ragged
   case: against its plain version (also with padding rows setting the
   scale), the same bits twice and off the boundary, its gap to the
   3xTF32 kernel, its time beside that kernel's,
   and a bound from its int8 products and CUDA-core instructions.
   The two near kernels (:func:`near_phase`) at 2,220 and at 17,760 atoms,
   each box with its own neighbor table: also against their 3xTF32
   emulations, bounds at the TF32 rate and in fp32, and the
   ``near_pass_rowsum`` antisymmetry probe on each table with the M rows
   of the 16-row tensor-core tiles its pairs took.
   The fused dense kernels (``fused_message_rowsum`` in both ``masked``
   modes, ``fused_epn_rowsum`` with the hard and the soft gate,
   :func:`fused_kernel_phase`) at the same shapes: each against its plain
   version and its 3xTF32 emulation, the same bits on a second launch and
   off the boundary, its times against a bound from its tensor-core
   products (TF32 rate; the fp32 bound beside), its CUDA-core work (the
   d² scan of every valid pair, the live pairs' elementwise work),
   special-function ops (at the SM clock ``nvidia-smi`` reports) and
   bytes; again at 17,760 atoms, held to a row slice of the plain version
   and the emulation; the dense pass kernel's dimer probe (disjoint atom
   pairs, each pair's two rows exact negations).
   The kernels at other widths (:func:`width_phase`): on a seeded
   random-weight model at each (H, E) of :data:`WIDTH_CASES` on a 600-atom
   water box, every width-carrying kernel against its plain version (and
   emulation), the same bits twice and off the boundary; the forward
   through the neighbor split and the dense fused forward at each of
   :data:`FORWARD_WIDTHS` against the plain dense forward on the card;
   the near-pair and dimer probes at every width; at :data:`TIMED_WIDTH`
   every kernel's time beside its bound.  ``neighbor_compact`` at 2,220
   and 17,760 atoms, each box in lattice order and shuffled: the same set
   as top-k on every row, the same table as its plain version bit for
   bit, and its time beside top-k's and beside two bounds (operations,
   instruction issue); on the same boxes the neighbor selection line:
   the cell-list builder (``count_only`` k equal to top-k's largest row,
   then its tables) gives the same set as top-k and ``neighbor_compact``,
   and the device times of the three.
4. Slice: ``Predictor.from_checkpoint("trained/mixed_b16")`` serving
   (a) small molecules on the dense path (no kernel may launch),
   (b) the two 2,220-atom boxes (Q = 0, +1) against the committed JAX
   golden charges, and padded to a width that is no multiple of 4,
   (c) the 17,760-atom box, spatially sorted, against a Predictor with
   top-k and no sort; launch counts per graph forward, the neighbor
   selection by the cell builder once a graph a call and never by top-k
   (counted by wrapping both, :func:`count_selection`), conservation, and
   the median ``predict_batch`` latency; in (b) and (c) 'auto' against
   top-k in turns, warm (one batch) and cold (``predict_molecules``, a
   new batch a call; at 17,760 atoms also 'auto' unsorted), with the cold
   set-up piece by piece (:func:`cold_parts`), and in (c) the sort's raw
   Σq on random-weight models that read the far field (:func:`sort_phase`);
   (d) ``forward_blocked(use_pallas=True)`` without ``neighbor_k`` (the
   fully fused dense forward) on the two 2,220-atom boxes: 5 + 5 fused
   launches per graph, charges against the golden and (b), its median
   latency, and the plain dense forward ``_forward_single`` on the card
   as its reference; then ``_forward_single_pallas(rbf_method=
   "doubling")`` against the direct call (:func:`dense_doubling_phase`:
   launches, gate flips, conservation, medians in turns); (e)
   ``neighbor_compact``'s tables through
   ``forward_blocked(neighbor_k=k, neighbors=(idx, mask))``; (f) the int8
   serving tier (``dense_matmul_precision="int8"``) on the boxes of (b)
   and (c): 4 int8 far-field launches a graph and none of the fp32 one,
   each launch of the run again against its plain version, the far sums
   of the run against the fp32 kernel's (above 0, below 2%), the charges' gap
   to (b) and (c), conservation, and both tiers' medians in turns;
   (g) MD serving (:func:`md_phase`): ``predict_trajectory`` with
   ``reuse_neighbors`` and a Verlet skin on the 2,220- and the
   17,760-atom box, a seeded drift then one jump: the rebuild counts, each
   frame against a cold Predictor, conservation, launches, and the skin
   step's median time beside the cold call's;
   (h) the clustered far-field tier (:func:`cluster_phase`):
   ``Predictor(far_cluster=C)`` at C = 32 and 128 (and 32 under int8) on
   the boxes of (b) and (c): as many far-field launches as the exact call,
   each with C centroid columns and again against its plain version, the
   gap to the exact charges, conservation, the same charges and radius on
   a second call, int8 within the tier's bar, the tiers' medians in turns,
   and the far-field kernels at the clustered shapes beside their bounds;
   then (:func:`cluster_accuracy_phase`) a random-weight model that reads
   the far field at 2,224 atoms: C ≥ the valid atoms against exact,
   ``far_field_diagnostics`` at C = 32, ``calibrate_far_cluster``;
   (i) ``charge_position_vjp`` on a 2,220-atom box (:func:`vjp_phase`):
   shape, padding rows, launches (the far-field backward kernel), central
   differences, its time;
   (j) the huge-N memory mode (:func:`huge_serving_phase`): explicit
   ``near_row_chunk`` at (b)'s and (c)'s boxes, with and without the auto
   window, the full-width charges bit for bit, launches a chunk, the near
   kernels in row blocks (the same bits, pairs exact negations); an
   undersized window; 142,080- and 568,320-atom boxes at far_cluster 32
   (chunk forced, then the auto policy): chunked and windowed against
   full width bit for bit, raw |sum q - Q| beside JAX's, peak device
   memory, warm medians in turns, the cold set-up, the near kernels at
   the chunk and full-width shapes;
   (k) the precision tiers: the six tensor-core kernels at precision
   "default" (:func:`tier_kernels_phase`) on the inputs of the 3xTF32
   checks (2,220 and 17,760 atoms) and at :data:`TIMED_WIDTH`, each
   against its one-pass emulation (entry by entry within 1e-5·(max|ref|
   + 1) plus the budget of the TF32 operand roundings that another
   summation order of an epart can flip, :func:`flip_budget`; the
   backward against the one-pass products in float64 with the tie
   budget), the same bits twice, the pass kernels' probes, times beside
   one-pass bounds, ptxas usage; then ``predict_batch`` in every tier of
   :data:`PRECISION_TIERS` (:func:`tier_serving_phase`) on
   ``mixed_b16`` at 2 × 2,220 and 17,760 atoms and on a random-weight
   model at 2,224: the kernels and TF32 tier each launch asks for
   (:data:`TIER_ROUTES`), charges within JAX's bf16 bar of highest's,
   parity at the golden bar, conservation, medians in turns.
5. Training: (a) the gradients of one fused train step on two 900-atom
   boxes, card against the port on the CPU, leaf by leaf; (b) ``train()``
   fine-tuning the checkpoint for a few epochs on the 2,220-atom boxes and
   the small molecules (noisy labels around the model's own charges): the
   fused bucket's loss falls, launches per fused step, none in dense
   steps, the median fused step, ``best/`` served with conservation, and
   the trained state through the sharding-aware format and back bit for
   bit (:func:`dcp_round_trip`); (c) the clustered tier
   (:func:`train_cluster_phase`): one clustered step's gradients card
   against CPU (the fits' rows assigned apart printed, ties checked), and
   ``train(far_cluster=32)`` on (b)'s set;
   (d) the huge-N mode in training (:func:`huge_train_phase`): a chunked
   remat step against full width on (a)'s boxes (the loss bit for bit,
   gradients within 1e-5 relative Frobenius), exact and clustered, and
   ``train(far_cluster=32)`` on a 213,120-atom bucket, which the auto
   policy chunks with remat forced; (e) ``train()`` under ``fast``
   (:func:`tier_train_phase`): the loss falls, every launch one-pass, the
   far-field backward's launches against their one-pass emulation.
   Then [cli] (:func:`cli_phase`): ``python -m epnn_tpu_torch`` on the
   card, on ``.xyz`` files of the golden boxes and the 17,760-atom box:
   ``infer`` in process (bit for bit the API's ``parity`` Predictor, the
   golden bar, the parity and fast routes tier by tier) and once as a
   subprocess (the same files), ``bench`` chained and per call beside
   (b)/(c)'s medians, ``import-ckpt`` of a synthetic reference bundle of
   the checkpoint (params bit for bit; ``infer`` from it and from
   ``--reference-models``), ``eval-pol`` (bit for bit the API's
   difference), and ``train --init-from`` for two epochs (the far-field
   backward kernel launched).
   [mesh] multi-device serving on the one card (:func:`mesh_one_rank_phase`,
   :func:`mesh_shape_rows`, :func:`mesh_two_rank_phase`): (a) a real NCCL
   process group of world size 1 (``make_mesh(1, 1)``): ``Predictor(
   mesh=..., shard_mode=...)`` 'atom' and 'ring', exact and at
   ``far_cluster`` = 32, on the 2 x 2,220 and 17,760-atom boxes, against
   the one-card call, conservation, launches, medians in turns; the far
   field at the two-rank split's shapes (R = N/2 rows against N columns,
   the ring's N/2 x N/2 blocks, R x 32 centroids) against its plain
   version and emulation, with times and bounds; (b) two gloo ranks
   sharing ``cuda:0`` (NCCL refuses two ranks on one GPU; this script
   with ``--mesh-child``): 'atom' and 'ring' exact and ring at C = 32,
   the charges against the one-card call, launches and their shapes a
   rank, every launch against its plain version on its own inputs
   (:func:`launch_error`), the ring's distributed fits counted, the pass
   pairs across the ranks exact negations both ways, medians (two ranks
   on one card: no scaling figure); and a gloo probe (``--gloo-probe``)
   of which collectives gloo takes on CUDA tensors, held to the mesh's
   rule of what it stages through the host.
   [mesh c] training on the mesh: (a) on the NCCL world of one,
   ``make_sharded_train_step`` atom (exact and C = 32) and ring, one step
   on [train a]'s boxes against ``train_step_fused`` at [train a]'s bar,
   launches a step (:func:`mesh_train_one_rank`); the far-field backward
   at a rank's shapes (1,112 × 2,224, the ring's 1,112 × 1,112 block,
   1,112 × 32) and the near kernels on a rank's 1,112 and 8,880 rows,
   each against its plain version, timed beside its bound
   (:func:`mesh_train_shape_rows`); (b) on [mesh b]'s two gloo ranks
   (:func:`mesh_train_child`): atom, ring and ring C = 32 steps on the
   2,220-atom boxes against the one-card step (the ring's partitions
   replayed at C = 32), every far-field backward launch against its
   plain version, launches a rank, every rank's parameters the same bits;
   the data-parallel step on a (2, 1) mesh; ``train(mesh=...)`` two
   epochs, the sharded step's loss falling.  On a machine with N cards,
   ``torchrun --nproc-per-node N chip_smoke.py --mesh-train-cards`` runs
   (b) over NCCL, a card a rank: a (1, N) mesh, and a (2, N/2) mesh's
   atom and data-parallel steps (:func:`mesh_train_cards`).
6. Profile: ``torch.profiler`` over ``predict_batch`` (2 x 2,220 and
   1 x 17,760 atoms, fp32 and int8, parity and fast; the clustered call
   at 17,760 with its k-means as a group), a Verlet-skin step at 17,760
   atoms and
   one fused train step (2 x 2,220):
   device-busy time against wall time, and the largest kernels; then
   ``benchmark_batch(cost_analysis=True)``'s ``flops`` at 2 x 2,220 and 1
   x 17,760 atoms equal to the same call's count on the CPU (a child
   process of this script, ``--cpu-flops``, started after the build;
   :func:`flops_phase`).
7. The kernels' JSON line, the card line, and last the result line.

Any failure raises and exits non-zero; without a CUDA card it exits 2
before printing any result.  Imports nothing of JAX.
"""

import atexit
import functools
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

#: published H100 SXM peaks (NVIDIA data sheet): fp32 outside the tensor
#: cores, and HBM3 bandwidth — the bound of a kernel is the larger of its
#: FLOP and byte times at these rates
PEAK_FP32_FLOPS = 67e12
#: dense TF32 on the tensor cores: the far-field and near kernels' 3xTF32
#: products
PEAK_TF32_FLOPS = 495e12
#: dense int8 on the tensor cores: the int8 far field's products
PEAK_INT8_OPS = 1979e12
#: CUDA-core instructions a second: one a lane a clock, half the fp32 FLOP
#: peak (which counts an FMA as two)
PEAK_INSTR = PEAK_FP32_FLOPS / 2
PEAK_BYTES = 3.35e12
# the work each bound counts is ``kernels.work``'s (its products,
# elementwise FLOP, instructions, special-function ops and bytes on the
# data given), the one source of the kernels' work counts

GOLDEN = "epnn_tpu_torch/testdata/water2220_mixed_b16.npz"
CKPT = "trained/mixed_b16"
KERNEL_ROWS = {
    # name -> (TPU kernel it replaces, CUDA source)
    "dense_message_rowsum": ("epnn_tpu/ops/pallas_kernels.py:98",
                             "epnn_tpu_torch/csrc/dense_message_rowsum.cu"),
    "dense_message_rowsum_int8": (
        "epnn_tpu/ops/pallas_kernels.py:59",
        "epnn_tpu_torch/csrc/dense_message_rowsum_int8.cu"),
    "near_message_corr": ("epnn_tpu/ops/pallas_kernels.py:1286",
                          "epnn_tpu_torch/csrc/near_message_corr.cu"),
    "near_pass_rowsum": ("epnn_tpu/ops/pallas_kernels.py:1410",
                         "epnn_tpu_torch/csrc/near_pass_rowsum.cu"),
    "dense_message_rowsum_bwd": (
        "epnn_tpu/ops/pallas_kernels.py:1079",
        "epnn_tpu_torch/csrc/dense_message_rowsum_bwd.cu"),
    "fused_message_rowsum": ("epnn_tpu/ops/pallas_kernels.py:490",
                             "epnn_tpu_torch/csrc/fused_message_rowsum.cu"),
    "fused_epn_rowsum": ("epnn_tpu/ops/pallas_kernels.py:368",
                         "epnn_tpu_torch/csrc/fused_epn_rowsum.cu"),
    "neighbor_compact": ("epnn_tpu/ops/pallas_kernels.py:685",
                         "epnn_tpu_torch/csrc/neighbor_compact.cu"),
}
#: launches of each kernel per graph forward with the round-1 collapse (T=5)
PER_GRAPH = {"dense_message_rowsum": 4, "near_message_corr": 5,
             "near_pass_rowsum": 5}
#: per graph in a fused train step: the forward's, and one far-field
#: backward per far-field forward (the near backwards recompute through
#: their plain versions and launch nothing)
PER_GRAPH_TRAIN = {**PER_GRAPH, "dense_message_rowsum_bwd": 4}
#: per graph through the fully fused dense forward (T = 5)
PER_GRAPH_DENSE = {"fused_message_rowsum": 5, "fused_epn_rowsum": 5}
#: per graph with kernel-built neighbor tables: the table, then the forward
PER_GRAPH_COMPACT = {**PER_GRAPH, "neighbor_compact": 1}
#: per graph in the int8 serving tier: its far field in place of the fp32 one
PER_GRAPH_INT8 = {"dense_message_rowsum_int8": 4, "near_message_corr": 5,
                  "near_pass_rowsum": 5}
#: the slice each kernel's ``launches`` is read from
MAIN_PATH = {"dense_message_rowsum_bwd": "train",
             "dense_message_rowsum_int8": "int8",
             "fused_message_rowsum": "dense_fused",
             "fused_epn_rowsum": "dense_fused",
             "neighbor_compact": "compact_nbrs"}
#: special-function results (exp, cos, sqrt) per clock per SM, and SMs
SFU_PER_CLOCK_SM = 16
SMS = 132
#: the [train] phase: gradient-check box size (waters), train() epochs,
#: and the label noise (e) around the checkpoint's own charges
TRAIN_BOX_MOLECULES = 300
TRAIN_EPOCHS = 5
LABEL_NOISE = 0.05
#: the far field's ragged rectangular case (R rows, N columns), a slice of
#: the 2,220-atom inputs with seeded zeros in cv
RAGGED = (37, 1001)
#: the shipped widths (H, E) and the other widths the kernels are built
#: and checked at: below them, a multiple of neither 16 (H) nor 8 (E), and
#: the widest
SHIPPED_WIDTHS = (32, 48)
WIDTH_CASES = ((16, 24), (40, 20), (64, 64), (96, 80), (136, 72), (128, 128),
               (256, 256))
#: the width whose kernels the width phase also times against their bounds
#: (the wide path's), and the widths whose two forwards it checks against
#: the plain dense forward on the card
TIMED_WIDTH = (128, 128)
FORWARD_WIDTHS = ((16, 24), TIMED_WIDTH)
#: the width phase's water box (molecules: 600 atoms) and model rounds
WIDTH_BOX_MOLECULES = 200
WIDTH_T = 2
#: [slice g]: the Verlet skin (Å), frames of the 2,220- and the 17,760-atom
#: trajectory (14 steady frames each), the seeded drift a frame (Å an
#: axis, at most; cumulative: the 14 steps after the first frame move an
#: atom at most 14·√3·0.02 = 0.485 Å, under skin/2) and the last frame's
#: jump from the first (Å an atom, past skin/2)
MD_SKIN = 1.0
MD_FRAMES = {"2220": 16, "17760": 16}
MD_DRIFT = 0.02
MD_JUMP = 0.6
#: [slice h]: the clustered tier's centroid counts served on mixed_b16, the
#: one also served under int8, and the accuracy phase's charge bar between
#: C ≥ the valid atoms and exact (JAX's, tests/test_fused.py:1340)
CLUSTER_CS = (32, 128)
CLUSTER_INT8_C = 32
CLUSTER_EXACT_BAR = 2e-5
#: [slice h] the accuracy phase's bar on C ≥ the valid atoms against exact
#: where the fit merged rows its float32 scores cannot tell apart, and the
#: calibration budget, both in units of max|q| + 1 (see
#: :func:`cluster_accuracy_phase`)
CLUSTER_MERGED_BAR = 1e-3
CLUSTER_BUDGET = 1e-3
#: [train c]: the clustered train run's C
TRAIN_CLUSTER_C = 32
#: [slice i]: the central difference's step (Å), probes wanted, the band
#: around the cutoff a probed atom's pairs must avoid (Å), and the bar
#: (JAX's, tests/test_fused.py:1258-1264)
VJP_EPS = 3e-3
VJP_PROBES = 3
VJP_CLEAR = 0.05
VJP_BAR = 5e-2
#: a probe whose forward and backward differences part by more than this
#: share of the scale has a relu switching within ε: skipped
VJP_KINK = 2e-2
#: [slice j]: explicit near-row chunks at 2 x 2,220 and 17,760 atoms, an
#: undersized window (rows), and the huge boxes (waters; 142,080 and
#: 568,320 atoms) served at far_cluster = HUGE_C with the chunk of
#: ``balanced_row_chunk`` (below the threshold forced, above it the auto
#: policy's), beside JAX's raw |sum q - Q| there (``BENCH_r05.json``;
#: accuracy, not hardware figures)
HUGE_CHUNKS = (1024, 4096)
HUGE_UNDERSIZED_WINDOW = 256
HUGE_C = 32
HUGE_BOXES = {"142080": 47_360, "568320": 189_440}
JAX_RAW_SUM_Q = {"142080": 1.39e-3, "568320": 3.16e-3}
#: [train d]: the chunk of the 2 x 900-atom step, and the bucket of one
#: 213,120-atom box (past ``infer.HUGE_GRAPH_MIN_ATOMS``) trained 2 epochs
HUGE_STEP_CHUNK = 256
HUGE_TRAIN_MOLECULES = 71_040
HUGE_TRAIN_EPOCHS = 2
#: calls of the port's neighbor selection since the last
#: :func:`reset_selection`: cell-list tables, the cell builder's count_only
#: k, and top-k tables (:func:`count_selection`)
SELECTION = {"cell": 0, "cell_count": 0, "topk": 0}


def require(ok, detail) -> None:
    """A check that stays under ``python -O`` (unlike ``assert``)."""
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {detail}")


def count_selection() -> None:
    """Wrap the port's cell-list builder (in each module that calls it)
    and its top-k ``build_neighbors`` with the counters of
    :data:`SELECTION`."""
    from epnn_tpu_torch import infer
    from epnn_tpu_torch.ops import fused
    from epnn_tpu_torch.train import loop

    cell, topk = fused.build_neighbors_cell, fused.build_neighbors

    def cell_counted(*a, **kw):
        SELECTION["cell_count" if kw.get("count_only") else "cell"] += 1
        return cell(*a, **kw)

    def topk_counted(*a, **kw):
        SELECTION["topk"] += 1
        return topk(*a, **kw)

    for mod in (fused, infer, loop):
        mod.build_neighbors_cell = cell_counted
    fused.build_neighbors = topk_counted


def reset_selection() -> None:
    for kind in SELECTION:
        SELECTION[kind] = 0


def smi(fields: str, fmt: str = "csv,noheader") -> str:
    """The first card's ``fields`` as ``nvidia-smi --query-gpu`` gives them."""
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={fields}", f"--format={fmt}"],
        capture_output=True, text=True, timeout=60,
        check=True).stdout.strip().splitlines()[0]


def card_line() -> str:
    return smi("name,power.limit")


def max_sm_clock_hz() -> float:
    return float(smi("clocks.max.sm", "csv,noheader,nounits")) * 1e6


def sm_clocks() -> str:
    return smi("clocks.sm,clocks.max.sm")


#: the precision every phase but [slice k] holds the kernels at: their
#: 3xTF32 tier, to their 3xTF32 emulations (the wrappers' own default is
#: JAX's "default", the one-pass tier)
HI = {"precision": "highest"}


#: each tier's emulation of the tensor-core kernels (``<kernel><suffix>``)
#: and its name in the output
EMULATION = {"highest": "_3xtf32_plain", "default": "_tf32_plain"}
TIER_TEXT = {"highest": "3xTF32", "default": "one TF32 pass"}
#: the tiers' keys in the JSON line (max_abs_diff_<key>, flop_<key>)
TIER_KEY = {"highest": "3xtf32", "default": "tf32"}


def at(fn, precision):
    """Kernel wrapper ``fn`` pinned to ``precision``."""
    return functools.partial(fn, precision=precision)


def plain_time(torch, fn, iters):
    """:func:`device_ms` of a plain version, or None where ``iters`` is 0
    (a tier's phase that the other tier's already timed)."""
    return device_ms(torch, fn, iters) if iters else None


def off_boundary(t):
    """t's values in a view 4 bytes past a 16-byte boundary."""
    return t.new_empty(t.numel() + 1)[1:].view(t.shape).copy_(t)


def bound(flop, sfu, nbytes, sfu_rate):
    """(bound ms, what bounds it): the largest of the FLOP time at the fp32
    peak, the special-function time and the byte time."""
    times = {"operations": max(flop / PEAK_FP32_FLOPS, sfu / sfu_rate),
             "bytes": nbytes / PEAK_BYTES}
    by = max(times, key=times.get)
    return times[by] * 1e3, by


def tc_bound(wk, passes=3):
    """(bound ms, what bounds it, fp32 bound ms) of a kernel's work ``wk``
    (``kernels.work`` on this data: live pairs or slots): its products on
    the tensor cores at ``passes`` TF32 products each (3: 3xTF32, 1: the
    one-pass tier), at the TF32 peak, and its elementwise FLOP on the CUDA
    cores; its bytes at the HBM rate: the bound is the largest of the
    three times.  The fp32 bound puts every FLOP on the CUDA cores, as a
    kernel without the tensor cores would."""
    tc = passes * wk.products / PEAK_TF32_FLOPS
    ops = max(tc, wk.elementwise / PEAK_FP32_FLOPS)
    by = wk.bytes / PEAK_BYTES
    fp32 = (wk.products + wk.elementwise) / PEAK_FP32_FLOPS
    return (max(ops, by) * 1e3, "operations" if ops >= by else "bytes",
            max(fp32, by) * 1e3)


def fused_bound(wk, sfu_rate, passes=3):
    """(bound ms, what bounds it, fp32 bound ms) of a fused dense kernel's
    work ``wk`` (``kernels.work``): its products on the tensor cores at
    ``passes`` TF32 products each (3xTF32 or one pass, at the TF32 peak),
    its elementwise FLOP and scan instructions on the CUDA cores, its
    special-function ops at ``sfu_rate``, and its bytes at the HBM rate;
    the bound is the largest.  The fp32 bound puts the products on the
    CUDA cores too."""
    tc = passes * wk.products / PEAK_TF32_FLOPS
    cuda = wk.elementwise / PEAK_FP32_FLOPS + wk.instructions / PEAK_INSTR
    sf = wk.special / sfu_rate
    ops, by = max(tc, cuda, sf), wk.bytes / PEAK_BYTES
    fp32 = max((wk.products + wk.elementwise) / PEAK_FP32_FLOPS
               + wk.instructions / PEAK_INSTR, sf)
    return (max(ops, by) * 1e3, "operations" if ops >= by else "bytes",
            max(fp32, by) * 1e3)


#: the labels of a kernel's bool template instantiations (``ILb0E``,
#: ``ILb1E``): the far field's backward passes, the fused kernels' RBF
#: methods
INSTANTIATIONS = {"dense_message_rowsum_bwd": ("<pass C>", "<pass R>"),
                  "fused_message_rowsum": ("<direct>", "<doubling>"),
                  "fused_epn_rowsum": ("<direct>", "<doubling>")}


def entry_name(mangled, labels=INSTANTIATIONS["dense_message_rowsum_bwd"]):
    """A kernel entry's own name from its mangled one: the last of the
    length-prefixed names after ``_Z`` / ``_ZN``; an instantiation on a
    bool gets its label (``labels``: false's, true's; by default a pass of
    the far field's backward, ``<pass C>`` or ``<pass R>``)."""
    pos, name = 3 if mangled.startswith("_ZN") else 2, mangled
    while True:
        m = re.match(r"\d+", mangled[pos:])
        if m is None:
            break
        pos += m.end()
        name = mangled[pos:pos + int(m.group())]
        pos += int(m.group())
    tail = re.match(r"ILb([01])E", mangled[pos:])
    return name + (labels[int(tail.group(1))] if tail else "")


def ptxas_usage(kernels, name, h=SHIPPED_WIDTHS[0], e=SHIPPED_WIDTHS[1],
                precision="highest"):
    """Registers and spill bytes of each entry of a kernel's library at
    widths (h, e) and the TF32 tier of ``precision``, from its build log
    (``-Xptxas -v``)."""
    out, entry, spill = [], "?", (0, 0)
    for ln in kernels.build_log(name, h, e, precision).splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            entry = entry_name(m.group(1), INSTANTIATIONS.get(
                name, INSTANTIATIONS["dense_message_rowsum_bwd"]))
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      ln)
        if m:
            spill = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            out.append(dict(entry=entry, registers=int(m.group(1)),
                            spill_stores=spill[0], spill_loads=spill[1]))
    return out


def far_forward(torch, kernels, args, precision="highest"):
    """``dense_message_rowsum`` at ``precision`` on ``args`` against its
    fp32 plain version and its tier's emulation (:data:`EMULATION`), each
    within 1e-5·(max|ref| + 1) (the forward is continuous in z2, so the
    two may differ only by summation order) — at "default" the emulation
    only, the fp32 gap being the tier's; the same bits on a second launch
    and with every input off the 16-byte boundary.  Returns (max|Δ| vs
    plain, vs emulation, tol)."""
    wrapper = at(kernels.dense_message_rowsum, precision)
    out = wrapper(*args)
    ref = kernels.dense_message_rowsum_plain(*args)
    emu = getattr(kernels, "dense_message_rowsum"
                  + EMULATION[precision])(*args)
    torch.cuda.synchronize()
    err = float((out - ref).abs().max())
    err_emu = float((out - emu).abs().max())
    tol = 1e-5 * (float((ref if precision == "highest" else emu).abs().max())
                  + 1.0)
    require(np.isfinite(err) and err_emu <= tol
            and (precision != "highest" or err <= tol),
            ("dense_message_rowsum", precision, tuple(args[0].shape),
             tuple(args[1].shape), err, err_emu, tol))
    require(torch.equal(wrapper(*args), out),
            ("dense_message_rowsum", "not the same bits on a second launch"))
    off = [off_boundary(t) for t in args]
    require(torch.equal(wrapper(*off), out),
            ("dense_message_rowsum", "inputs off the 16-byte boundary"))
    return err, err_emu, tol


def tie_budget(torch, args, precision="highest"):
    """The most each of ``dense_message_rowsum_bwd``'s four outputs can move
    when every z2 within rounding of 0 flips relu's indicator: per entry, in
    float64, the sum of |Δe2| = |g_io · cv_j| over the (i, j, o) with
    |z2| ≤ 2^-16 · (|b2_o| + Σ_f relu(z1_f) |W2_fo|) (far above the 3xTF32
    and fp32 rounding of z2), carried through |W2ᵀ| and 1[z1 > 0] (dpi,
    dpj) or relu(z1) (dW2).  At "default" z2 is the one-pass tier's (its
    TF32 products in float64, :func:`mm_tf32_f64`), whose sign is what the
    kernel and its reference may disagree on.  For small R·N·H only."""
    pi, pj, cv, w2, b2, g = (t.double() for t in args)
    z1 = pi[:, None, :] + pj[None, :, :]
    a1 = torch.relu(z1)
    z2 = (a1 @ w2 if precision == "highest" else mm_tf32_f64(a1, w2)) + b2
    tie = z2.abs() <= 2.0 ** -16 * (b2.abs() + a1 @ w2.abs())
    de2 = torch.where(tie, (g[:, None, :] * cv[None, :, None]).abs(), 0.0)
    dz1 = (de2 @ w2.abs().T) * (z1 > 0)
    h = pi.shape[1]
    return (dz1.sum(1), dz1.sum(0), a1.reshape(-1, h).T @ de2.reshape(-1, h),
            de2.sum((0, 1))), int(tie.sum())


def mm_tf32_f64(a, b, c=None):
    """``c + a @ b`` of TF32-rounded operands in float64: the one-pass
    tier's products without float32 summation (its float64 reference)."""
    from epnn_tpu_torch.ops import kernels

    out = (kernels.tf32_round(a.float()).double()
           @ kernels.tf32_round(b.float()).double())
    return out if c is None else c + out


def far_backward(torch, kernels, args, ties=False, precision="highest"):
    """``dense_message_rowsum_bwd`` at ``precision`` on ``args``: each of
    its four outputs against the float64 reference of its tier (the bar
    below): the float64 plain version, or at "default" the one-pass
    products in float64 (:func:`mm_tf32_f64`); and its distance to the
    fp32 plain version and to the tier's emulation; the same bits on a
    second launch and with every input off the 16-byte boundary.  With
    ``ties`` the bar also takes, entry by entry, :func:`tie_budget` (the
    width phase).  Returns {part: (vs fp32, vs f64, fp32 twin vs f64, vs
    emulation, tol)}."""
    wrapper = at(kernels.dense_message_rowsum_bwd, precision)
    outs = wrapper(*args)
    emus = getattr(kernels, "dense_message_rowsum_bwd"
                   + EMULATION[precision])(*args)
    fp32s = kernels.dense_message_rowsum_bwd_plain(*args)
    if precision == "highest":
        refs = fp32s
        exact = kernels.dense_message_rowsum_bwd_plain(
            *(t.double() for t in args))
    else:
        refs = emus
        exact = kernels._far_bwd_rows(*(t.double() for t in args),
                                      mm_tf32_f64)
    budgets, n_ties = (tie_budget(torch, args, precision) if ties
                       else ((0.0,) * 4, 0))
    torch.cuda.synchronize()
    # The gradient steps where z1 or z2 crosses 0 (relu's indicator): a pair
    # whose z lies within rounding of 0 flips between any two evaluations,
    # moving one entry by ~|g_i|·|W2 row|.  So the bar is the float64 plain
    # version: the kernel may be at most twice as far from it as the
    # float32 plain version is, plus 1e-5·(max|ref| + 1).  The emulation
    # rounds z2 differently again, so its distance is reported, not barred.
    # At one pass the same with the tier's products: the one-pass products
    # in float64, and the float32 emulation's distance to them.
    # Where the float32 plain version flips no tie and the kernel flips one
    # (the random-weight model of the width phase: one flip moved dpi by
    # 0.30 against a bar of 0.0145), the tie budget bounds what the flips
    # may move, entry by entry.
    errs = {}
    for part, o, r, r32, em, r64, bud in zip(
            ("dpi", "dpj", "dw2", "db2"), outs, refs, fp32s, emus, exact,
            budgets):
        plain64 = float((r.double() - r64).abs().max())
        tol = 2.0 * plain64 + 1e-5 * (float(r64.abs().max()) + 1.0)
        err64 = float(((o.double() - r64).abs() - bud).max())
        require(np.isfinite(err64) and err64 <= tol,
                ("dense_message_rowsum_bwd", precision, tuple(args[0].shape),
                 tuple(args[1].shape), part, err64, tol, n_ties))
        errs[part] = (float((o - r32).abs().max()), err64, plain64,
                      float((o - em).abs().max()), tol)
    again = wrapper(*args)
    require(all(torch.equal(a, b) for a, b in zip(again, outs)),
            ("dense_message_rowsum_bwd", "not the same bits on a second "
             "launch"))
    off = [off_boundary(t) for t in args]
    require(all(torch.equal(a, b) for a, b in
                zip(wrapper(*off), outs)),
            ("dense_message_rowsum_bwd", "inputs off the 16-byte boundary"))
    return errs


def far_phase(torch, card, args, gbar, label, clocks, iters, ties=False,
              precision="highest"):
    """[kernel] both far-field kernels at ``precision`` on ``args`` (pi,
    pj, cv, W2, b2) and the cotangent ``gbar``: ``far_forward`` and
    ``far_backward``, kernel and plain times (``iters``: forward kernel,
    forward plain, backward kernel, backward plain; a plain iters of 0
    skips it), the SM clock before and after the timings (appended to
    ``clocks``), and the bounds on this data at the tier's products:
    every row against the live columns (cv ≠ 0).  ``ties`` as in
    :func:`far_backward`.  Returns {kernel: measurements}."""
    from epnn_tpu_torch.ops import kernels

    passes = kernels.tf32_passes(precision)
    key, text = TIER_KEY[precision], TIER_TEXT[precision]
    r, hh = args[0].shape
    nc = args[1].shape[0]
    live = int(torch.count_nonzero(args[2]))
    fwd_err, fwd_emu, fwd_tol = far_forward(torch, kernels, args, precision)
    errs = far_backward(torch, kernels, (*args, gbar), ties=ties,
                        precision=precision)
    fwd = at(kernels.dense_message_rowsum, precision)
    bwd = at(kernels.dense_message_rowsum_bwd, precision)
    clocks.append((f"before the far-field timings at {label} ({text})",
                   sm_clocks()))
    ms = device_ms(torch, lambda: fwd(*args), iters[0])
    plain_ms = plain_time(
        torch, lambda: kernels.dense_message_rowsum_plain(*args), iters[1])
    bwd_ms = device_ms(torch, lambda: bwd(*args, gbar), iters[2])
    bwd_plain_ms = plain_time(
        torch, lambda: kernels.dense_message_rowsum_bwd_plain(*args, gbar),
        iters[3])
    clocks.append((f"after the far-field timings at {label} ({text})",
                   sm_clocks()))
    out = {}
    ptext = lambda t: "not timed" if t is None else f"{t:.4f} ms"  # noqa
    # forward: the mid-layer product + ~4H elementwise a live pair; pi,
    # cv and out whole, pj where cv is live, W2, b2 once
    wk = kernels.work("dense_message_rowsum", rows=r, cols=nc, h=hh,
                      live=live)
    nbytes = wk.bytes
    b_ms, b_by, b32 = tc_bound(wk, passes)
    out["dense_message_rowsum"] = dict(
        R=r, N=nc, live_cols=live,
        max_abs_err=fwd_err if precision == "highest" else fwd_emu,
        max_abs_diff=fwd_err, tol=fwd_tol,
        ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
        bound_fp32_ms=b32, flop=wk.products + wk.elementwise,
        bytes=nbytes, **{f"max_abs_diff_{key}": fwd_emu,
                         f"flop_{key}": passes * wk.products})
    print(f"[kernel] dense_message_rowsum at R={r} N={nc} ({live} live "
          f"columns), {text}: max|d| vs plain f32 {fwd_err:.3e}, vs its "
          f"emulation {fwd_emu:.3e} (tol {fwd_tol:.3e}), same bits on a "
          f"second launch and off the 16-byte boundary; kernel {ms:.4f} ms, "
          f"plain {ptext(plain_ms)}, bound {b_ms:.5f} ms ({b_by}: "
          f"{passes * wk.products:,} tensor-core FLOP in {text}, "
          f"{nbytes:,} B), fp32 bound {b32:.5f} ms on {card}")
    # backward: z2, e2 @ W2ᵀ and the dW2 outer product (3 H×H
    # contractions) + ~9H elementwise a live pair; pi, g, dpi, cv, pj and
    # dpj whole, pj where cv is live, W2, b2, dW2, db2 once
    wk = kernels.work("dense_message_rowsum_bwd", rows=r, cols=nc, h=hh,
                      live=live)
    nbytes = wk.bytes
    b_ms, b_by, b32 = tc_bound(wk, passes)
    out["dense_message_rowsum_bwd"] = dict(
        R=r, N=nc, live_cols=live,
        max_abs_err=max(e[0 if precision == "highest" else 3]
                        for e in errs.values()),
        max_abs_diff={p: e[0] for p, e in errs.items()},
        max_abs_diff_f64={p: e[1] for p, e in errs.items()},
        plain_f32_diff_f64={p: e[2] for p, e in errs.items()},
        tol_f64={p: e[4] for p, e in errs.items()}, ms=bwd_ms,
        plain_ms=bwd_plain_ms, bound_ms=b_ms, bound_by=b_by,
        bound_fp32_ms=b32, flop=wk.products + wk.elementwise,
        bytes=nbytes, **{f"max_abs_diff_{key}": {p: e[3] for p, e in
                                                 errs.items()},
                         f"flop_{key}": passes * wk.products})
    print(f"[kernel] dense_message_rowsum_bwd at R={r} N={nc}, {text}: "
          f"{bwd_errs_text(errs)}; same bits on a second launch and off the "
          f"16-byte boundary; kernel {bwd_ms:.4f} ms, plain "
          f"{ptext(bwd_plain_ms)}, bound {b_ms:.5f} ms ({b_by}: "
          f"{passes * wk.products:,} tensor-core FLOP in {text}, "
          f"{nbytes:,} B), fp32 bound {b32:.5f} ms on {card}")
    for when, clk in clocks[-2:]:
        print(f"[clock] SM clock (clocks.sm, clocks.max.sm) {when}: {clk}")
    return out


def int8_bound(wk):
    """(bound ms, what bounds it, tensor-core ms, CUDA-core ms) of the int8
    far field's work ``wk`` (``kernels.work`` on the live pairs): 2H²
    integer operations a pair at the int8 tensor-core rate, H activations
    and H outputs a pair at ``kernels.INT8_INSTR_IN`` / ``INT8_INSTR_OUT``
    CUDA-core instructions each, and its bytes at the HBM rate: the bound
    is the largest of the three."""
    tc = wk.products / PEAK_INT8_OPS
    cuda = wk.instructions / PEAK_INSTR
    ops, by = max(tc, cuda), wk.bytes / PEAK_BYTES
    return (max(ops, by) * 1e3, "operations" if ops >= by else "bytes",
            tc * 1e3, cuda * 1e3)


def int8_phase(torch, card, args, label, iters=None):
    """[kernel] ``dense_message_rowsum_int8`` on ``args`` (pi, pj, cv, W2,
    b2), its scale from their maxima, against its plain version on the same
    card tensors within 1e-5·(max|ref| + 1) (within the tier everything is
    exact integers, so only the order of the sum over j differs); again
    with padding rows setting the scale (``pad_pi`` above max(pi); and 0
    with pj lowered below 0, pi raised as much); the same bits on a second launch and
    with every input off the 16-byte boundary; its gap to the 3xTF32
    kernel on the same inputs (> 0: the tier changes the numbers).  With
    ``iters`` (int8 kernel, its plain version, the 3xTF32 kernel): their
    times, the 3xTF32 kernel's beside the int8 one's in turns, and the
    bound on this data (live columns only).  Returns the measurements."""
    from epnn_tpu_torch.ops import kernels

    pi, pj, cv, w2, b2 = args
    r, hh = pi.shape
    nc = pj.shape[0]
    full = tuple(args)
    out = kernels.dense_message_rowsum_int8(*full)
    ref = kernels.dense_message_rowsum_int8_plain(*full)
    f32 = kernels.dense_message_rowsum(*args, **HI)
    torch.cuda.synchronize()
    err = float((out - ref).abs().max())
    tol = 1e-5 * (float(ref.abs().max()) + 1.0)
    require(np.isfinite(err) and err <= tol,
            ("dense_message_rowsum_int8", label, err, tol))
    # padding rows setting the scale: pi = pad_pi above every pi; and rows
    # of pi = pj = 0 with every pj lowered below 0 and pi raised as much,
    # so the rows' pj = 0 sets max(pj) while each pair keeps its activation
    # (lowering pj alone kills most activations, and a float32 sum of
    # ~12,000 near-equal terms drifts past the bar in any order)
    pad_errs = []
    # the step by which the padding rows move a maximum: 1, or 1% of the
    # inputs' magnitude where they are large (a clustered round's pi, pj
    # reach 1e5 on mixed_b16), so that s_in moves past float32 rounding
    bump = 1.0 + 0.01 * float(torch.maximum(pi.abs().amax(),
                                            pj.abs().amax()))
    shift = pj.amax() + 0.25 * bump
    for pad, pi_pad, pj_pad in ((pi.amax() + bump, pi, pj),
                                (pi.new_zeros(()), pi + shift, pj - shift)):
        pargs = (pi_pad.contiguous(), pj_pad.contiguous(), *args[2:])
        got = kernels.dense_message_rowsum_int8(*pargs, pad)
        want = kernels.dense_message_rowsum_int8_plain(*pargs, pad)
        moved = kernels.dense_message_rowsum_int8_plain(*pargs)
        e = float((got - want).abs().max())
        t = 1e-5 * (float(want.abs().max()) + 1.0)
        require(np.isfinite(e) and e <= t and float(
            (moved - want).abs().max()) > t,
            ("dense_message_rowsum_int8", label, "padded scale", e, t))
        pad_errs.append(e)
    require(torch.equal(kernels.dense_message_rowsum_int8(*full), out),
            ("dense_message_rowsum_int8", "not the same bits on a second "
             "launch"))
    off = [off_boundary(t) for t in full]
    require(torch.equal(kernels.dense_message_rowsum_int8(*off), out),
            ("dense_message_rowsum_int8", "inputs off the 16-byte boundary"))
    tier = float((out - f32).abs().max())
    scale = float(f32.abs().max()) + 1.0
    require(0.0 < tier, ("dense_message_rowsum_int8", label, "no tier gap"))
    live = int(torch.count_nonzero(cv))
    entry = dict(R=r, N=nc, live_cols=live, max_abs_err=err, tol=tol,
                 padded_scale_errs=pad_errs, tier_gap=tier,
                 tier_gap_rel=tier / scale)
    text = (f"[kernel] dense_message_rowsum_int8 at R={r} N={nc} ({live} "
            f"live columns): max|d| vs plain {err:.3e} (tol {tol:.3e}), with "
            f"padding rows setting the scale {pad_errs[0]:.3e} / "
            f"{pad_errs[1]:.3e}, same bits on a second launch and off the "
            f"16-byte boundary; gap to the 3xTF32 kernel {tier:.4e} = "
            f"{tier / scale:.3e} of max|out| + 1")
    if iters is not None:
        # timed as the serving path calls it: W2 quantized once, so a call
        # is the kernel and the wrapper's two maxima
        w2_int8 = kernels.int8_weights(w2)
        ms = device_ms(torch, lambda: kernels.dense_message_rowsum_int8(
            *full, w2_int8=w2_int8), iters[0])
        plain_ms = device_ms(torch, lambda: kernels.dense_message_rowsum_int8_plain(
            *full), iters[1])
        f32_ms = device_ms(torch, lambda: kernels.dense_message_rowsum(
            *args, **HI), iters[2])
        ms_again = device_ms(torch, lambda: kernels.dense_message_rowsum_int8(
            *full, w2_int8=w2_int8), iters[0])
        wk = kernels.work("dense_message_rowsum_int8", rows=r, cols=nc,
                          h=hh, live=live)
        nbytes = wk.bytes
        b_ms, b_by, tc_ms, cuda_ms = int8_bound(wk)
        entry.update(ms=ms, ms_second=ms_again, plain_ms=plain_ms,
                     fp32_kernel_ms=f32_ms, bound_ms=b_ms, bound_by=b_by,
                     bound_tensor_core_ms=tc_ms, bound_cuda_core_ms=cuda_ms,
                     int_ops=wk.products, instructions=wk.instructions,
                     bytes=nbytes)
        text += (f"; kernel and its two maxima {ms:.4f} ms (again after the 3xTF32 kernel's "
                 f"{f32_ms:.4f} ms: {ms_again:.4f}), plain {plain_ms:.4f} ms,"
                 f" bound {b_ms:.5f} ms ({b_by}: int8 tensor cores "
                 f"{tc_ms:.5f} ms for {wk.products:,} operations, "
                 f"CUDA cores {cuda_ms:.5f} ms for "
                 f"{entry['instructions']:,.0f} instructions, {nbytes:,} B) "
                 f"on {card}")
    print(text)
    return entry


def bwd_errs_text(errs):
    return ("max|d| vs plain f32 / vs the tier's f64 reference (its f32 "
            "emulation vs f64; tol) / vs its emulation: " + ", ".join(
                f"{p} {e:.3e} / {e64:.3e} ({p64:.3e}; {t:.3e}) / {em:.3e}"
                for p, (e, e64, p64, em, t) in errs.items()))


def device_ms(torch, fn, iters):
    """Device ms per call: a sleep kernel holds the stream while ``iters``
    calls are enqueued between two events, so the host's launch cost does
    not show in the interval."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)  # ~0.1 s of GPU cycles
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def noisy_labels(g, q):
    """``q`` plus seeded noise of :data:`LABEL_NOISE` e that sums to zero,
    so the labels keep the molecule's net charge."""
    noise = g.normal(0.0, LABEL_NOISE, size=q.shape)
    return (q + noise - noise.mean()).astype(np.float32)


def dcp_round_trip(torch, state, cfg, tc, directory):
    """A ``TrainState`` on the card through ``io.checkpoint.
    save_train_state_orbax`` into ``directory`` and back with
    ``load_train_state_orbax`` into a fresh template on the card (seeded
    weights, no Adam state): every parameter leaf, both moments, the step,
    the update count and the rate bit for bit.  Returns the counts, the
    files and their bytes, and the host ms of each call."""
    from epnn_tpu_torch.io import checkpoint as ckpt_io
    from epnn_tpu_torch.models import tree_leaves
    from epnn_tpu_torch.train import loop

    def leaves(st):
        moments = loop._adam_moments(st)
        return ([p.detach() for p in tree_leaves(st.params)]
                + [t for m in moments for t in tree_leaves(m)])

    _, save_ms = host_ms(torch, lambda: ckpt_io.save_train_state_orbax(
        directory, state))
    template = loop.create_state(cfg, tc, seed=11, device="cuda")
    _, load_ms = host_ms(torch, lambda: ckpt_io.load_train_state_orbax(
        directory, template))
    want, got = leaves(state), leaves(template)
    require(len(want) == len(got) and all(
        a.device == b.device and torch.equal(a, b)
        for a, b in zip(want, got)), "DCP round trip: a leaf differs")
    require((template.step, template.opt.count, float(template.opt.lr))
            == (state.step, state.opt.count, float(state.opt.lr)),
            ("DCP round trip", template.step, state.step))
    path = os.path.join(directory, ckpt_io.DCP_DIR)
    files = sorted(os.listdir(path))
    return dict(leaves=len(want), files=files, save_ms=save_ms,
                load_ms=load_ms, step=state.step, bytes=sum(
                    os.path.getsize(os.path.join(path, f)) for f in files))


def train_phase(torch, pred, card, small, small_q, batch2, golden):
    """[train] (a) one fused train step's gradients, card against CPU;
    (b) ``train()`` from the checkpoint.  Returns the kernels' launches in
    the ``train()`` run and the median fused train step (ms)."""
    from epnn_tpu_torch.data import pad_molecules, uniform_q0_contract
    from epnn_tpu_torch.elements import table_for_n_elems
    from epnn_tpu_torch.infer import Predictor
    from epnn_tpu_torch.models import tree_leaves
    from epnn_tpu_torch.ops import kernels
    from epnn_tpu_torch.testing import golden_boxes, water_box
    from epnn_tpu_torch.train import TrainConfig, loop, train

    cfg = pred.cfg
    g = np.random.default_rng(5)
    per_step = {kn: 2 * PER_GRAPH_TRAIN.get(kn, 0) for kn in kernels.SOURCES}

    # (a) gradients of one fused step (B = 2), the card against the CPU
    boxes = [water_box(TRAIN_BOX_MOLECULES, seed=30, charge=0.0),
             water_box(TRAIN_BOX_MOLECULES, seed=31, charge=-1.0)]
    batch = pad_molecules(boxes, table_for_n_elems(cfg.n_elems))
    y = (batch.node_mask * g.normal(0.0, 0.3, size=batch.node_mask.shape)
         ).astype(np.float32)
    arrays = (batch.x, batch.q0, batch.xyz, batch.node_mask, y,
              np.ones(2, np.float32))
    k = pred._neighbor_k(batch)
    uq0 = uniform_q0_contract(batch.x, batch.q0, batch.node_mask)
    grads, losses = {}, {}
    for side, device in (("card", "cuda"), ("host", "cpu")):
        state = loop.create_state(cfg, TrainConfig(), device=device,
                                  params=pred.params)
        args = [torch.from_numpy(a).to(device) for a in arrays]
        kernels.reset_launch_counts()
        _, loss, _, _ = loop.train_step_fused(state, cfg, "masked_mse",
                                              None, 256, k, *args,
                                              uniform_q0=uq0, remat=False)
        if side == "card":
            torch.cuda.synchronize()
            step_launches = dict(kernels.LAUNCHES)
        losses[side] = float(loss)
        grads[side] = [p.grad.cpu() for p in
                       tree_leaves(state.params)]
    require(step_launches == per_step, (step_launches, per_step))
    # per leaf: relative Frobenius error ≤ 1e-3 — summation order, and the
    # relu-indicator ties of the far-field backward (above), which move
    # single entries; a wrong or missing gradient term is O(1)
    worst_fro = worst_max = 0.0
    for gc, gr in zip(grads["card"], grads["host"]):
        fro = float(torch.linalg.norm(gc - gr)
                    / max(float(torch.linalg.norm(gr)), 1e-30))
        require(np.isfinite(fro) and fro <= 1e-3, ("gradient", fro))
        worst_fro = max(worst_fro, fro)
        worst_max = max(worst_max, float((gc - gr).abs().max())
                        / (float(gr.abs().max()) + 1.0))
    dl = abs(losses["card"] - losses["host"])
    require(dl <= 1e-5 * (abs(losses["host"]) + 1.0), ("loss", losses))
    print(f"[train a] first fused step, 2 x {batch.natoms[0]:,} atoms, k={k}:"
          f" loss card {losses['card']:.6e} CPU {losses['host']:.6e}; "
          f"{len(grads['host'])} gradient leaves, card vs CPU relative "
          f"Frobenius error <= 1e-3 (worst {worst_fro:.3e}; worst "
          f"max|d|/(max|g|+1) {worst_max:.3e}); launches "
          f"{step_launches}")

    # (b) train(): fine-tune the checkpoint on the golden boxes and the
    # small molecules, labels = their charges plus seeded noise
    big = golden_boxes()
    for m, q in zip(big, golden):
        m.labels = noisy_labels(g, q[:m.natoms])
    for m, q in zip(small, small_q):
        m.labels = noisy_labels(g, q)
    steps = {"train_step": [], "train_step_fused": []}
    originals = {name: getattr(loop, name) for name in steps}

    def spy(name):
        def step(*a, **kw):
            before = dict(kernels.LAUNCHES)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = originals[name](*a, **kw)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            launched = {kn: kernels.LAUNCHES[kn] - before[kn]
                        for kn in before}
            steps[name].append((float(out[1]), launched, ms))
            return out
        return step

    with tempfile.TemporaryDirectory() as tmp:
        run = os.path.join(tmp, "run")
        tc = TrainConfig(epochs=TRAIN_EPOCHS, checkpoint_dir=run,
                         log_path=os.path.join(tmp, "log.jsonl"),
                         init_from=CKPT)
        for name in steps:
            setattr(loop, name, spy(name))
        try:
            kernels.reset_launch_counts()
            res = train(big + small, cfg, tc, val_mols=small)
            train_launches = dict(kernels.LAUNCHES)
        finally:
            for name, fn in originals.items():
                setattr(loop, name, fn)
        fused = steps["train_step_fused"]
        require(len(fused) == TRAIN_EPOCHS, len(fused))
        for _, launched, _ in fused:
            require(launched == per_step, (launched, per_step))
        for _, launched, _ in steps["train_step"]:
            require(sum(launched.values()) == 0, launched)
        f_loss = [s[0] for s in fused]
        require(np.all(np.isfinite(f_loss)) and f_loss[-1] < f_loss[0],
                f_loss)
        step_list = [s[2] for s in fused]
        step_ms = float(np.median(step_list))
        require(len(res.history) == TRAIN_EPOCHS
                and np.isfinite(res.best_val_masked_mae), res.history)
        served = Predictor.from_checkpoint(os.path.join(run, "best"))
        q_best = served.predict_batch(batch2)
        cons = np.abs(q_best.astype(np.float64).sum(1) - batch2.total_q)
        require(np.all(np.isfinite(q_best)) and np.all(cons <= 1e-4), cons)
        dcp = dcp_round_trip(torch, res.state, cfg, tc,
                             os.path.join(tmp, "state"))
    print(f"[train b] the trained state through the sharding-aware format "
          f"(save_train_state_orbax / load_train_state_orbax, "
          f"torch.distributed.checkpoint) on the card: {dcp['leaves']} "
          f"leaves and the step, update count and rate bit for bit in a "
          f"fresh template; files {dcp['files']}, {dcp['bytes']:,} B, save "
          f"{dcp['save_ms']:.1f} ms, load {dcp['load_ms']:.1f} ms")
    print(f"[train b] train(): {TRAIN_EPOCHS} epochs from {CKPT} on 2 x "
          f"2,220 atoms + {len(small)} small molecules: fused-bucket loss "
          f"{' -> '.join(f'{v:.6e}' for v in f_loss)}; launches per fused "
          f"step {fused[0][1]}, none in {len(steps['train_step'])} dense "
          f"steps; fused train step median {step_ms:.3f} ms (steps "
          f"{', '.join(f'{v:.3f}' for v in step_list)} ms); best/ served: "
          f"|sum q - Q| = {cons.tolist()} on {card}")
    return train_launches, step_ms, step_list, big + small


def turns(timed, preds, call, reps):
    """Medians of ``reps`` calls ``call(p)`` of each Predictor of
    ``preds`` ({name: p}) in turns (the names in order, then reversed,
    e.g. topk, auto, auto, topk), after a warm-up call of each: {name:
    [ms, ms]}.  ``call`` = ``p.predict_batch(batch)`` times warm calls
    (k, grid, tables and sorted twin cached on the batch object);
    ``p.predict_molecules(mols)`` times cold ones, a new padded batch a
    call, as every caller of ``predict_molecules`` pays."""
    for p in preds.values():
        call(p)
    out = {name: [] for name in preds}
    for name in list(preds) + list(preds)[::-1]:
        out[name].append(round(timed(lambda: call(preds[name]), reps), 3))
    return out


def cold_parts(torch, pred, mols, reps=5):
    """Host-clock medians (ms) of ``reps`` cold calls' set-up, piece by
    piece, each on a new padded batch of ``mols``: the padding, the
    spatial sort (``_spatial_view``: CRC, cell key, argsort, five
    permuted arrays), the cell grid's bounds (host binning) and k (the
    cell builder's ``count_only`` and its sync, or the host count under
    top-k), on the batch the forward would get."""
    from epnn_tpu_torch.data import pad_molecules
    from epnn_tpu_torch.elements import table_for_n_elems

    table = table_for_n_elems(pred.cfg.n_elems)
    parts = {"pad": [], "sort": [], "grid": [], "k": []}
    for _ in range(reps):
        t0 = time.perf_counter()
        batch = pad_molecules(mols, table)
        t1 = time.perf_counter()
        view = pred._spatial_view(batch)
        t2 = time.perf_counter()
        inner = batch if view is None else view[0]
        pred._neighbor_grid(inner)
        t3 = time.perf_counter()
        pred._neighbor_k(inner)
        torch.cuda.synchronize()
        t4 = time.perf_counter()
        for key, a, b in (("pad", t0, t1), ("sort", t1, t2),
                          ("grid", t2, t3), ("k", t3, t4)):
            parts[key].append((b - a) * 1e3)
    return {key: round(float(np.median(v)), 3) for key, v in parts.items()}


def sort_phase(torch, card, mol, seeds=range(5)):
    """[slice c] the spatial sort's effect on raw Σq on models that read
    the far field: ``[width]``'s seeded random-weight model (``init_params``:
    h 16, msg 8, T :data:`WIDTH_T`) at the shipped widths, one a seed,
    served on ``mol`` by ``Predictor(spatial_sort='auto')`` (sorted at
    this size) and ``'off'``.  The two must agree within
    1e-5·(max|q|+1); raw |Σq − Q| of each is recorded, not bounded (the
    sort changes only the float32 summation order).  Returns a row a
    seed."""
    from epnn_tpu_torch.data import pad_molecules
    from epnn_tpu_torch.elements import table_for_n_elems
    from epnn_tpu_torch.infer import CELL_SORT_MIN_ATOMS, Predictor
    from epnn_tpu_torch.models import EPNNConfig
    from epnn_tpu_torch.models.epnn import init_params

    hh, ee = SHIPPED_WIDTHS
    cfg = EPNNConfig(h_dim=16, e_dim=ee, msg_dim=8, mlp_hidden=(hh, hh),
                     T=WIDTH_T)
    batch = pad_molecules([mol], table_for_n_elems(cfg.n_elems))
    require(batch.padded_atoms >= CELL_SORT_MIN_ATOMS, "sort_phase size")
    out = []
    for seed in seeds:
        params = init_params(cfg, torch.Generator().manual_seed(seed))
        q_on = Predictor(params, cfg).predict_batch(batch)[0]
        q_off = Predictor(params, cfg, spatial_sort="off").predict_batch(
            batch)[0]
        dq = float(np.abs(q_on - q_off).max())
        tol = 1e-5 * (float(np.abs(q_off).max()) + 1.0)
        raw = [abs(float(q.astype(np.float64).sum()) - mol.total_charge)
               for q in (q_on, q_off)]
        require(np.all(np.isfinite(q_on)) and dq < tol, ("sort", seed, dq))
        out.append(dict(seed=seed, max_abs_q=float(np.abs(q_off).max()),
                        sum_abs_q=float(np.abs(q_off).sum()), max_dq=dq,
                        tol=tol, raw_sum_q_sorted=raw[0],
                        raw_sum_q_unsorted=raw[1]))
        print(f"[slice c] spatial sort, random-weight model seed {seed} "
              f"(H {hh}, E {ee}, T {WIDTH_T}), 1 x {mol.natoms:,} atoms: "
              f"max|q| {out[-1]['max_abs_q']:.4e}, sorted vs unsorted "
              f"max|dq| {dq:.3e} (tol {tol:.3e}); raw |sum q - Q| sorted "
              f"{raw[0]:.4e}, unsorted {raw[1]:.4e} on {card}")
    return out


def md_phase(torch, card, pred, boxes):
    """[slice g] MD serving: ``predict_trajectory`` with
    ``reuse_neighbors=True, neighbor_skin=MD_SKIN`` on each (label,
    molecule) of ``boxes`` over ``MD_FRAMES[label]`` frames: a seeded
    cumulative drift of at most :data:`MD_DRIFT` Å an axis a frame (under
    skin/2 in all), then a last frame :data:`MD_JUMP` Å from the
    first for every atom.  ``skin_rebuilds`` must read 1 on every frame
    but the last and 2 on it; each frame's charges against a cold
    ``Predictor``'s (default settings, a new batch a frame) within
    1e-5·(max|q|+1), |Σq − Q| ≤ 1e-4; the kernels' launches T times a
    graph's; the selection by the cell builder only, once a rebuild.
    Times on the host clock: each skin step and each cold call.  Returns
    the numbers by box."""
    from epnn_tpu_torch.data import pad_molecules
    from epnn_tpu_torch.data.xyz import Molecule
    from epnn_tpu_torch.elements import table_for_n_elems
    from epnn_tpu_torch.infer import Predictor
    from epnn_tpu_torch.ops import kernels

    table = table_for_n_elems(pred.cfg.n_elems)
    cold = Predictor(pred.params, pred.cfg)
    out = {}
    for label, mol in boxes:
        t = MD_FRAMES[label]
        g = np.random.default_rng(11)
        drift = mol.xyz[None] + np.cumsum(
            g.uniform(-MD_DRIFT, MD_DRIFT, size=(t - 1, mol.natoms, 3)),
            axis=0)
        u = g.normal(size=(mol.natoms, 3))
        u /= np.linalg.norm(u, axis=1, keepdims=True)
        frames = np.concatenate([drift, drift[:1] + MD_JUMP * u[None]]
                                ).astype(np.float32)
        skin = Predictor(pred.params, pred.cfg, reuse_neighbors=True,
                         neighbor_skin=MD_SKIN)
        step_ms, rebuilds, call = [], [], skin.predict_batch

        def timed_step(batch):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            q = call(batch)
            step_ms.append((time.perf_counter() - t0) * 1e3)
            rebuilds.append(skin.skin_rebuilds)
            return q

        skin.predict_batch = timed_step
        kernels.reset_launch_counts()
        reset_selection()
        q = skin.predict_trajectory(mol, frames)
        launches, sel = dict(kernels.LAUNCHES), dict(SELECTION)
        require(rebuilds == [1] * (t - 1) + [2], ("skin_rebuilds", rebuilds))
        require(launches == {kn: t * PER_GRAPH.get(kn, 0)
                             for kn in kernels.SOURCES}, launches)
        require(sel["cell"] == 2 and sel["topk"] == 0, ("[slice g]", sel))
        cold_ms, dqs, tols, cons = [], [], [], []
        for i in range(t):
            b_t = pad_molecules([Molecule(
                name=mol.name, symbols=mol.symbols, xyz=frames[i],
                total_charge=mol.total_charge)], table)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            qc = cold.predict_batch(b_t)[0, :mol.natoms]
            cold_ms.append((time.perf_counter() - t0) * 1e3)
            dqs.append(float(np.abs(q[i] - qc).max()))
            tols.append(1e-5 * (float(np.abs(qc).max()) + 1.0))
            cons.append(abs(float(q[i].astype(np.float64).sum())
                            - mol.total_charge))
        require(all(d < tl for d, tl in zip(dqs, tols)), (label, dqs, tols))
        require(max(cons) <= 1e-4, (label, cons))
        steady = float(np.median(step_ms[1:-1]))
        out[label] = dict(frames=t, skin=MD_SKIN, rebuilds=rebuilds,
                          selection_calls=sel, step_ms=step_ms,
                          steady_step_median_ms=steady, cold_ms=cold_ms,
                          cold_median_ms=float(np.median(cold_ms)),
                          max_dq=dqs, tol=tols, conservation=cons)
        print(f"[slice g] MD serving, 1 x {mol.natoms:,} atoms, {t} frames "
              f"(drift <= {MD_DRIFT} A an axis a frame, then {MD_JUMP} A), "
              f"reuse_neighbors, neighbor_skin={MD_SKIN}: skin_rebuilds "
              f"{rebuilds}; selection calls {sel}; launches {launches}; "
              f"max|dq| vs a cold Predictor per frame {max(dqs):.3e} (tol "
              f">= {min(tols):.3e}); |sum q - Q| <= {max(cons):.3e}; skin "
              f"step median {steady:.3f} ms (first {step_ms[0]:.3f}, "
              f"rebuild {step_ms[-1]:.3f}), cold call median "
              f"{float(np.median(cold_ms)):.3f} ms on {card}")
    return out


def spy_calls(module, name, seen):
    """Replace ``module.<name>`` by a wrapper that appends each call's
    (cloned tensor arguments, keywords) to ``seen``; returns a function
    that puts the original back."""
    import torch

    real = getattr(module, name)

    def spy(*a, **kw):
        seen.append((tuple(t.detach().clone() if isinstance(t, torch.Tensor)
                           else t for t in a), kw))
        return real(*a, **kw)

    setattr(module, name, spy)
    return lambda: setattr(module, name, real)


def cluster_phase(torch, card, pred, boxes, timed, rows, clocks):
    """[slice h] the clustered far-field tier through ``Predictor(far_cluster
    =C)`` on mixed_b16, for each (label, batch, reps) of ``boxes``: each C
    of :data:`CLUSTER_CS` (and C = :data:`CLUSTER_INT8_C` under int8)
    launches its far field as often as the exact call does (4 a graph), every
    launch with C centroid columns, and every launch again against its
    plain version on its own inputs within 1e-5·(max|ref|+1); the charges'
    gap to the exact call (printed), |Σq − Q| ≤ 1e-4, the same bits for the
    charges and the radius on a second call, int8 within the tier's bar
    0.05·(max|q|+1) of the fp32 clustered charges; all tiers' medians in
    turns (exact, C32, C128, C32 int8, then reversed); and both far-field
    kernels and the int8 one at the clustered shapes (the first launch's
    inputs) beside their bounds, into ``rows``' sizes.  Returns the
    numbers and the 2 x 2,220 C32 call's launches."""
    from epnn_tpu_torch.infer import Predictor
    from epnn_tpu_torch.ops import fused, kernels

    cfg = pred.cfg
    c8 = CLUSTER_INT8_C
    preds = {"exact": pred}
    for c in CLUSTER_CS:
        preds[f"C{c}"] = Predictor(pred.params, cfg, far_cluster=c)
    preds[f"C{c8} int8"] = Predictor(
        pred.params, cfg.replace(dense_matmul_precision="int8"),
        far_cluster=c8)
    out, main = {}, None
    g = np.random.default_rng(13)
    for label, batch, reps in boxes:
        q_exact = pred.predict_batch(batch)
        res = {}
        for name, p in preds.items():
            if name == "exact":
                continue
            c = p.far_cluster
            int8 = name.endswith("int8")
            fn = "dense_message_rowsum" + ("_int8" if int8 else "")
            p.predict_batch(batch)          # k, grid, tables, twin cached
            seen = []
            restore = spy_calls(fused, fn, seen)
            try:
                kernels.reset_launch_counts()
                q = p.predict_batch(batch)
                launches = dict(kernels.LAUNCHES)
            finally:
                restore()
            per_graph = PER_GRAPH_INT8 if int8 else PER_GRAPH
            want = {kn: batch.batch_size * per_graph.get(kn, 0)
                    for kn in kernels.SOURCES}
            require(launches == want, ("[slice h]", label, name, launches))
            cols = [a[1].shape[0] for a, _ in seen]
            require(len(seen) == want[fn] and set(cols) == {c},
                    ("[slice h] columns", label, name, cols))
            if label == "2x2220" and name == f"C{CLUSTER_CS[0]}":
                main = launches
            errs = []
            for a, kw in seen:
                got = getattr(kernels, fn)(*a, **kw)
                ref = (kernels.dense_message_rowsum_int8_plain(
                    *a, kw["pad_pi"], kw["pad_pj"]) if int8
                    else kernels.dense_message_rowsum_plain(*a))
                errs.append(float((got - ref).abs().max())
                            / (1e-5 * (float(ref.abs().max()) + 1.0)))
            require(max(errs) <= 1.0, ("[slice h] vs plain", label, name,
                                       errs))
            cons = np.abs(q.astype(np.float64).sum(1) - batch.total_q)
            require(np.all(np.isfinite(q)) and np.all(cons <= 1e-4),
                    ("[slice h] conservation", label, name, cons))
            again = p.predict_batch(batch)
            rad = [p.far_field_diagnostics(batch, compare_exact=False)[
                "max_radius"] for _ in range(2)]
            require(np.array_equal(q, again)
                    and np.array_equal(rad[0], rad[1]),
                    ("[slice h] not the same bits twice", label, name))
            dq = float(np.abs(q - q_exact).max())
            res[name] = dict(C=c, launches=launches, launch_err_over_bar=errs,
                             max_dq_vs_exact=dq, conservation=cons.tolist(),
                             max_radius=rad[0].tolist(), columns=cols)
            if int8:
                q32 = preds[f"C{c}"].predict_batch(batch)
                gap = float(np.abs(q - q32).max())
                bar = 0.05 * (float(np.abs(q32).max()) + 1.0)
                require(gap < bar, ("[slice h] int8 tier", label, gap, bar))
                res[name]["max_dq_vs_fp32_clustered"] = gap
            # the kernels at this clustered shape: the first launch's inputs
            a = seen[0][0]
            size = f"{a[0].shape[0]}x{c}"
            if c == c8 and not int8:
                gbar = torch.from_numpy(g.normal(size=tuple(a[0].shape))
                                        .astype(np.float32)).cuda()
                it = (50, 5, 20, 3) if a[0].shape[0] < 4096 else (20, 2, 10, 2)
                for kn, entry in far_phase(torch, card, a, gbar, size,
                                           clocks, it).items():
                    rows[kn]["sizes"][size] = entry
            if int8:
                rows["dense_message_rowsum_int8"]["sizes"][size] = \
                    int8_phase(torch, card, a[:5], size, (50, 5, 50))
        medians = turns(timed, preds, lambda pr: pr.predict_batch(batch),
                        reps)
        out[label] = dict(tiers=res, turns_ms=medians)
        print(f"[slice h] clustered far field, {label} atoms: " + "; ".join(
            f"{n} launches {r['launches']} ({len(r['columns'])} far-field "
            f"launches, {r['columns'][0]} columns each; each again vs its "
            f"plain version at most {max(r['launch_err_over_bar']):.3e} of "
            f"the bar), max|dq| vs exact {r['max_dq_vs_exact']:.3e}"
            + (f", vs fp32 clustered {r['max_dq_vs_fp32_clustered']:.3e}"
               if "max_dq_vs_fp32_clustered" in r else "")
            + f", |sum q - Q| {r['conservation']}, radius {r['max_radius']}"
            for n, r in res.items())
            + f"; charges and radius the same bits twice; predict_batch "
            f"medians in turns (ms) {medians} on {card}")
    return out, main


def cluster_accuracy_phase(torch, card, mol):
    """[slice h] the clustered tier on a model that reads the far field:
    ``[width]``'s seeded random-weight model at the shipped widths (as
    :func:`sort_phase`) on ``mol``.  C ≥ the valid atoms: every valid row
    may still share a cluster with rows that JAX's score ‖c‖² − 2r·c
    cannot tell apart in float32 (closer than ~sqrt(eps)·‖r‖; on this
    model's water boxes most rows have such twins, in JAX's fit as in the
    port's), so the check is that the fit's radius stays within that
    resolution, sqrt(32·eps)·max‖pj‖; the charges then equal the exact ones
    within JAX's bar :data:`CLUSTER_EXACT_BAR`·(max|q|+1) where no row
    merged, and within :data:`CLUSTER_MERGED_BAR`·(max|q|+1) where rows
    merged (the merged count is printed).  C = 32: ``far_field_diagnostics``
    whole, ``max_abs_dq`` finite, |Σq − Q| ≤ 2e-6·(Σ|q|+1).
    ``calibrate_far_cluster`` with a budget of
    :data:`CLUSTER_BUDGET`·(max|q|+1) over the default candidates and the
    padded width selects a C.  Returns the numbers."""
    from epnn_tpu_torch.data import pad_molecules
    from epnn_tpu_torch.elements import table_for_n_elems
    from epnn_tpu_torch.infer import Predictor
    from epnn_tpu_torch.models import EPNNConfig
    from epnn_tpu_torch.models.epnn import init_params
    from epnn_tpu_torch.ops import fused

    hh, ee = SHIPPED_WIDTHS
    cfg = EPNNConfig(h_dim=16, e_dim=ee, msg_dim=8, mlp_hidden=(hh, hh),
                     T=WIDTH_T)
    params = init_params(cfg, torch.Generator().manual_seed(0))
    batch = pad_molecules([mol], table_for_n_elems(cfg.n_elems))
    n_all = batch.padded_atoms
    exact = Predictor(params, cfg)
    q_e = exact.predict_batch(batch)
    scale = float(np.abs(q_e).max()) + 1.0
    p_all = Predictor(params, cfg, far_cluster=n_all)
    fits = []
    restore = spy_calls(fused, "weighted_kmeans", fits)
    try:
        rad_all = p_all.far_field_diagnostics(
            batch, compare_exact=False)["max_radius"]
    finally:
        restore()
    q_all = p_all.predict_batch(batch)
    merged, resolution = 0, 0.0
    for (rows, w, c), _ in fits:
        _, wts, _ = fused.weighted_kmeans(rows, w, c)
        merged += int((w > 0).sum()) - int((wts > 0).sum())
        resolution = max(resolution, float(np.sqrt(32 * np.finfo(
            np.float32).eps)) * float(rows[w > 0].norm(dim=1).max()))
    dq_all = float(np.abs(q_all - q_e).max())
    bar_all = (CLUSTER_MERGED_BAR if merged else CLUSTER_EXACT_BAR) * scale
    require(float(rad_all.max()) <= resolution and dq_all <= bar_all,
            ("[slice h] C >= valid atoms", dq_all, bar_all, merged,
             rad_all.tolist(), resolution))
    p32 = Predictor(params, cfg, far_cluster=32)
    diag = p32.far_field_diagnostics(batch)
    q32 = p32.predict_batch(batch)
    cons = abs(float(q32.astype(np.float64).sum()) - mol.total_charge)
    cons_bar = 2e-6 * (float(np.abs(q32).sum()) + 1.0)
    require(np.all(np.isfinite(diag["max_abs_dq"])) and cons <= cons_bar,
            ("[slice h] C=32", diag, cons, cons_bar))
    budget = CLUSTER_BUDGET * scale
    cal = exact.calibrate_far_cluster(
        batch, budget, candidates=(16, 32, 64, 128, 256, n_all))
    require(cal["selected"] is not None, ("[slice h] calibrate", cal))
    diag = {k: (v.tolist() if isinstance(v, np.ndarray) else v)
            for k, v in diag.items()}
    print(f"[slice h] random-weight model (H {hh}, E {ee}, T {WIDTH_T}), "
          f"1 x {mol.natoms:,} atoms, max|q| {scale - 1.0:.4e}: C = {n_all} "
          f"({merged} valid rows merged with a twin, radius "
          f"{rad_all.tolist()} within the scores' resolution "
          f"{resolution:.4e}) vs exact max|dq| {dq_all:.3e} (bar "
          f"{bar_all:.3e}); C = 32 far_field_diagnostics {diag}, |sum q - Q| "
          f"{cons:.3e} (bar {cons_bar:.3e}); calibrate_far_cluster(budget "
          f"{budget:.4e}) selected {cal['selected']}, errors "
          f"{cal['errors']} on {card}")
    return dict(max_abs_q=scale - 1.0, c_all=n_all, max_dq_c_all=dq_all,
                bar_c_all=bar_all, merged_rows_c_all=merged,
                radius_c_all=rad_all.tolist(), resolution=resolution,
                diagnostics_c32=diag, conservation_c32=cons,
                calibrate=dict(selected=cal["selected"], budget=budget,
                               errors=cal["errors"]))


def fit_assignments(torch, fits):
    """The final assignment of each recorded fit (rows, weights, C,
    keywords), on the rows' device: the serving-mode fit of the same rows
    (the same Lloyd centroids as the differentiable one) and the argmin of
    its scores.  Returns [(weights, centroids, assignment)] on the CPU."""
    from epnn_tpu_torch.ops.cluster import weighted_kmeans

    out = []
    for (rows, w, c), kw in fits:
        kw = {k: v for k, v in kw.items() if k != "differentiable"}
        cent, _, _ = weighted_kmeans(rows, w, c, **kw)
        score = (cent * cent).sum(1)[None, :] - 2.0 * (rows @ cent.T)
        out.append((w.cpu(), cent.cpu(), score.argmin(1).cpu()))
    return out


def rows_apart(torch, card, host):
    """Valid rows that two fits' partitions put apart, up to relabeling:
    rows whose cluster on ``host`` is not the one most rows of their
    ``card`` cluster take (each a (weights, centroids, assignment) of
    :func:`fit_assignments`)."""
    w, _, ac = card
    ah = host[2]
    valid = w > 0
    ac, ah = ac[valid], ah[valid]
    apart = 0
    for c in torch.unique(ac).tolist():
        sel = ah[ac == c]
        apart += int((sel != torch.mode(sel).values).sum())
    return apart


def replay_fits(torch, fits):
    """A stand-in for ``weighted_kmeans`` that returns, fit by fit, what the
    given fits (of :func:`fit_assignments`) return on the caller's rows:
    the card's assignment and Lloyd centroids, and in the differentiable
    mode the weighted means of the caller's rows under that assignment
    (the training tier's centroids)."""
    calls = iter(fits)

    def fit(rows, weights, c, differentiable=False, **kw):
        _, lloyd, assign = next(calls)
        lloyd = lloyd.to(rows.device)
        onehot = assign.to(rows.device)[:, None] == torch.arange(
            c, device=rows.device)[None, :]
        wo = onehot.to(torch.float32) * weights.detach()[:, None]
        wts = wo.sum(0)
        cent = lloyd
        if differentiable:
            cent = torch.where((wts > 0)[:, None], (wo.T @ rows)
                               / torch.clamp(wts, min=1e-30)[:, None], lloyd)
        return cent, wts, rows.new_zeros(())

    return fit


def train_cluster_phase(torch, pred, card, mols, val_mols, exact_steps):
    """[train c] the clustered training tier: (a) one clustered fused
    step's gradients (the differentiable fit) on 2 x 900 atoms, card
    against the port on the CPU, at C = :data:`TRAIN_CLUSTER_C` and at C =
    the padded width (≥ the valid atoms).  The k-means is discontinuous in
    float32 noise: on water boxes the seeds come from an argsort of row
    norms that tie within rounding, so the card's and the CPU's own fits
    start from other seeds and partition tight classes differently; the
    valid rows they put apart (up to relabeling) are printed.  The CPU
    step then replays the card's partition (:func:`replay_fits`: the same
    assignment, centroids the weighted means of the CPU's own rows), so
    both compute the same function, held to ``[train a]``'s bar (1e-3
    relative Frobenius a leaf) at both C.  (b) ``train()`` with
    ``TrainConfig(far_cluster=C)`` on ``[train b]``'s molecules, 5 epochs:
    the fused loss falls, the launches per fused step, each step's time
    beside ``[train b]``'s exact ones.  Returns the numbers and the run's
    launches."""
    from epnn_tpu_torch.data import pad_molecules, uniform_q0_contract
    from epnn_tpu_torch.elements import table_for_n_elems
    from epnn_tpu_torch.models import tree_leaves
    from epnn_tpu_torch.ops import fused, kernels
    from epnn_tpu_torch.ops.cluster import weighted_kmeans
    from epnn_tpu_torch.testing import water_box
    from epnn_tpu_torch.train import TrainConfig, loop, train

    cfg = pred.cfg
    g = np.random.default_rng(5)
    per_step = {kn: 2 * PER_GRAPH_TRAIN.get(kn, 0) for kn in kernels.SOURCES}
    boxes = [water_box(TRAIN_BOX_MOLECULES, seed=30, charge=0.0),
             water_box(TRAIN_BOX_MOLECULES, seed=31, charge=-1.0)]
    batch = pad_molecules(boxes, table_for_n_elems(cfg.n_elems))
    y = (batch.node_mask * g.normal(0.0, 0.3, size=batch.node_mask.shape)
         ).astype(np.float32)
    arrays = (batch.x, batch.q0, batch.xyz, batch.node_mask, y,
              np.ones(2, np.float32))
    k = pred._neighbor_k(batch)
    uq0 = uniform_q0_contract(batch.x, batch.q0, batch.node_mask)

    def one_step(device, c, fit):
        state = loop.create_state(cfg, TrainConfig(), device=device,
                                  params=pred.params)
        args = [torch.from_numpy(a).to(device) for a in arrays]
        seen = []
        real = fused.weighted_kmeans
        fused.weighted_kmeans = fit
        restore = spy_calls(fused, "weighted_kmeans", seen)
        try:
            kernels.reset_launch_counts()
            loop.train_step_fused(state, cfg, "masked_mse", None, 256, k,
                                  *args, uniform_q0=uq0, far_cluster=c,
                                  far_cluster_grad=True, remat=False)
            torch.cuda.synchronize()
            launches = dict(kernels.LAUNCHES)
        finally:
            restore()
            fused.weighted_kmeans = real
        return ([p.grad.cpu() for p in tree_leaves(state.params)], seen,
                launches)

    checks = {}
    for c in (TRAIN_CLUSTER_C, batch.padded_atoms):
        g_card, seen, launches = one_step("cuda", c, weighted_kmeans)
        require(launches == per_step, ("[train c] step launches", c,
                                       launches))
        card_fits = fit_assignments(torch, seen)
        g_host, seen_host, _ = one_step("cpu", c, replay_fits(torch,
                                                              card_fits))
        own = fit_assignments(torch, [((r, w, c_), {})
                                      for (r, w, c_), _ in seen_host])
        apart = [rows_apart(torch, a, b) for a, b in zip(card_fits, own)]
        fro = [float(torch.linalg.norm(gc - gr)
                     / max(float(torch.linalg.norm(gr)), 1e-30))
               for gc, gr in zip(g_card, g_host)]
        require(all(np.isfinite(v) and v <= 1e-3 for v in fro),
                ("[train c] gradients", c, fro))
        checks[c] = dict(launches=launches, rows_apart=apart,
                         grad_rel_fro_max=max(fro))
    print(f"[train c] one clustered fused step (far_cluster_grad), 2 x "
          f"{batch.natoms[0]:,} atoms: launches {launches}; " + "; ".join(
              f"C = {c}: valid rows the card's and the CPU's own fits put "
              f"apart, a fit: {r['rows_apart']}; gradients card vs CPU (the "
              f"card's partition replayed) worst relative Frobenius "
              f"{r['grad_rel_fro_max']:.3e} (bar 1e-3)"
              for c, r in checks.items()))

    steps = []
    original = loop.train_step_fused

    def spy(*a, **kw):
        before = dict(kernels.LAUNCHES)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = original(*a, **kw)
        torch.cuda.synchronize()
        steps.append((float(res[1]), {kn: kernels.LAUNCHES[kn] - before[kn]
                                      for kn in before},
                      (time.perf_counter() - t0) * 1e3, kw["far_cluster"]))
        return res

    with tempfile.TemporaryDirectory() as tmp:
        tc = TrainConfig(epochs=TRAIN_EPOCHS, init_from=CKPT,
                         checkpoint_dir=os.path.join(tmp, "run"),
                         far_cluster=TRAIN_CLUSTER_C)
        loop.train_step_fused = spy
        try:
            kernels.reset_launch_counts()
            res = train(mols, cfg, tc, val_mols=val_mols)
            run_launches = dict(kernels.LAUNCHES)
        finally:
            loop.train_step_fused = original
    require(len(steps) == TRAIN_EPOCHS and all(
        s[1] == per_step and s[3] == TRAIN_CLUSTER_C for s in steps),
        ("[train c] train()", [s[1] for s in steps]))
    losses = [s[0] for s in steps]
    require(np.all(np.isfinite(losses)) and losses[-1] < losses[0], losses)
    require(np.isfinite(res.best_val_masked_mae), res.history)
    step_list = [s[2] for s in steps]
    print(f"[train c] train(far_cluster={TRAIN_CLUSTER_C}): {TRAIN_EPOCHS} "
          f"epochs from {CKPT}, [train b]'s molecules: fused-bucket loss "
          f"{' -> '.join(f'{v:.6e}' for v in losses)}; launches per fused "
          f"step {steps[0][1]}; clustered steps "
          f"{', '.join(f'{v:.3f}' for v in step_list)} ms (median "
          f"{float(np.median(step_list)):.3f}) beside [train b]'s exact "
          f"{', '.join(f'{v:.3f}' for v in exact_steps)} ms (median "
          f"{float(np.median(exact_steps)):.3f}) on {card}")
    return dict(step_checks=checks, losses=losses,
                step_ms=step_list, step_median_ms=float(np.median(step_list)),
                exact_step_ms=exact_steps), run_launches


def vjp_phase(torch, card, pred, mol, timed):
    """[slice i] ``Predictor.charge_position_vjp`` on ``mol`` through
    mixed_b16: the (B, N, 3) shape, exactly zero on padding rows, the
    launches (the far-field backward kernel once a far-field launch);
    central differences (:data:`VJP_EPS`) of Σ cot·q on
    :data:`VJP_PROBES` (atom, axis) entries, the probed atoms' pairs
    farther than :data:`VJP_CLEAR` from the cutoff and the one-sided
    differences within :data:`VJP_KINK`·scale of each other (a relu of the
    model switching within ε of the probe makes a difference no
    derivative; such probes are skipped, and counted), the cotangent random on the probed atom and its neighbors
    within the cutoff, zero elsewhere; |g − fd| < :data:`VJP_BAR`·max(|fd|,
    max|g|, 1e-3); the call's median time.  Returns the numbers and the
    call's launches."""
    from epnn_tpu_torch.data import pad_molecules
    from epnn_tpu_torch.elements import table_for_n_elems
    from epnn_tpu_torch.ops import kernels

    table = table_for_n_elems(pred.cfg.n_elems)
    batch = pad_molecules([mol], table)
    n = mol.natoms
    cutoff = float(pred.cfg.cutoff)
    xyz = mol.xyz.astype(np.float64)
    d = np.sqrt(((xyz[:, None] - xyz[None]) ** 2).sum(-1))
    clear = np.nonzero(np.abs(d - cutoff).min(1) > VJP_CLEAR)[0]
    g = np.random.default_rng(17)
    probes, skipped, launches = [], [], None
    for i, ax in zip(clear[::41], [0, 1, 2] * 40):
        i = int(i)
        cot = np.zeros_like(batch.q0)
        near = d[i] < cutoff
        cot[0, :n][near] = g.normal(size=int(near.sum()))
        kernels.reset_launch_counts()
        grad = pred.charge_position_vjp(batch, cot)
        torch.cuda.synchronize()
        if launches is None:
            launches = dict(kernels.LAUNCHES)
            want = {kn: PER_GRAPH_TRAIN.get(kn, 0) for kn in kernels.SOURCES}
            require(launches == want, ("[slice i] launches", launches))
            require(grad.shape == batch.xyz.shape
                    and np.all(grad[0, n:] == 0.0)
                    and np.all(np.isfinite(grad)), "[slice i] shape, padding")

        vals = []
        for shift in (VJP_EPS, 0.0, -VJP_EPS):
            b2 = pad_molecules([mol], table)
            b2.xyz[0, i, ax] += shift
            vals.append(float((pred.predict_batch(b2).astype(np.float64)
                               * cot).sum()))
        fwd = (vals[0] - vals[1]) / VJP_EPS
        bwd = (vals[1] - vals[2]) / VJP_EPS
        fd1 = 0.5 * (fwd + bwd)
        scale = max(abs(fd1), float(np.abs(grad).max()), 1e-3)
        row = dict(atom=i, axis=ax, grad=float(grad[0, i, ax]), fd=fd1,
                   forward=fwd, backward=bwd, scale=scale)
        if abs(fwd - bwd) > VJP_KINK * scale:
            skipped.append(row)
            continue
        require(abs(row["grad"] - fd1) < VJP_BAR * scale, ("[slice i]", row))
        probes.append(row)
        if len(probes) == VJP_PROBES:
            break
    require(len(probes) == VJP_PROBES, ("[slice i] probes", probes, skipped))
    ms = timed(lambda: pred.charge_position_vjp(batch, cot), 5)
    print(f"[slice i] charge_position_vjp, 1 x {n:,} atoms: shape "
          f"{grad.shape}, padding rows exactly 0; launches {launches}; "
          f"central differences (eps {VJP_EPS} A) at " + "; ".join(
              f"atom {r['atom']} axis {r['axis']}: g {r['grad']:.5e}, fd "
              f"{r['fd']:.5e}" for r in probes)
          + f" (bar {VJP_BAR} of max(|fd|, max|g|, 1e-3); {len(skipped)} "
          f"probes skipped at a relu switch: one-sided differences apart by "
          f"more than {VJP_KINK} of it); call median {ms:.3f} ms on "
          f"{card}")
    return dict(probes=probes, skipped=skipped, launches=launches,
                ms=ms), launches


def chunk_probe(torch, label, cases, table, chunk):
    """Both near kernels launched in row blocks of ``chunk`` rows on one
    box's inputs (``near_inputs``), as the chunked forward launches them:
    the concatenated blocks equal the full-width launch bit for bit, and
    the ``near_pass_rowsum`` probe (disjoint near pairs, one slot each)
    keeps every pair's two rows exact negations across block boundaries.
    Returns the probe's pair count and how many pairs straddle blocks."""
    from epnn_tpu_torch.ops import kernels
    from epnn_tpu_torch.testing import disjoint_pair_gh

    def blocks(name, args):
        n, k = args[0].shape[0], args[3].shape[1]
        outs = []
        for s in range(0, n, chunk):
            e = min(s + chunk, n)
            outs.append(getattr(kernels, name)(
                args[0][s:e], args[1][s * k:e * k], args[2][s * k:e * k],
                args[3][s:e].contiguous(), *args[4:], **HI))
        return torch.cat(outs)

    for name, args in cases.items():
        full = getattr(kernels, name)(*args, **HI)
        require(torch.equal(blocks(name, args), full),
                (name, label, chunk, "blocks differ from full width"))
    idx, nbr_mask = table
    args = list(cases["near_pass_rowsum"])
    gh, pairs = disjoint_pair_gh(idx.cpu().numpy(), nbr_mask.cpu().numpy())
    args[3] = torch.from_numpy(gh).to(args[0].device)
    got = blocks("near_pass_rowsum", args)
    pt = torch.from_numpy(pairs).to(got.device)
    require(torch.equal(got[pt[:, 0]], -got[pt[:, 1]])
            and int(torch.count_nonzero(got[pt[:, 0]])) > 0,
            ("chunked antisymmetry", label, chunk))
    return len(pairs), int(np.sum(pairs[:, 0] // chunk != pairs[:, 1] // chunk))


def near_shape_entry(torch, card, label, name, args, kw, iters):
    """One near kernel at the shapes a launch of the forward gave it
    (``args``, ``kw`` as passed): against its plain version, its time, the
    plain version's and the bound of this data (:func:`near_bound`)."""
    from epnn_tpu_torch.ops import kernels

    wrapper = getattr(kernels, name)
    plain = getattr(kernels, name + "_plain")
    got = wrapper(*args, **kw)
    ref = plain(*args)
    err = float((got - ref).abs().max())
    tol = 1e-5 * (float(ref.abs().max()) + 1.0)
    require(np.isfinite(err) and err <= tol, (name, label, err, tol))
    del got, ref
    ms = device_ms(torch, lambda: wrapper(*args, **kw), iters[0])
    plain_ms = device_ms(torch, lambda: plain(*args), iters[1])
    n_live, wk, (b_ms, b_by, b32) = near_bound(name, args)
    entry = dict(N=args[0].shape[0], K=args[3].shape[1], live_slots=n_live,
                 max_abs_err=err, tol=tol, ms=ms, plain_ms=plain_ms,
                 bound_ms=b_ms, bound_by=b_by, bound_fp32_ms=b32,
                 bytes=wk.bytes)
    print(f"[slice j] {name} at {label} (N={entry['N']:,} rows, K="
          f"{entry['K']}, {n_live:,} live slots): max|d| vs plain {err:.3e} "
          f"(tol {tol:.3e}); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"bound {b_ms:.5f} ms ({b_by}), fp32 bound {b32:.5f} ms on {card}")
    return entry


def host_ms(torch, fn):
    """``(fn(), its host-clock ms)``, the card synchronized on both sides."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def peak_bytes(torch, fn):
    """``(fn(), the device bytes it allocated at its peak above what was
    allocated before it)`` (``torch.cuda.max_memory_allocated``)."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    return out, torch.cuda.max_memory_allocated() - before


def first_near_args(torch, fused, fn):
    """``fn()``'s result and the arguments of its first launch of each
    near kernel, ``{name: (args, kw)}`` (spied on the forward's names)."""
    seen = {}
    real = {name: getattr(fused, name)
            for name in ("near_message_corr", "near_pass_rowsum")}

    def spy(name):
        def call(*a, **kw):
            seen.setdefault(name, (a, kw))
            return real[name](*a, **kw)
        return call

    for name in real:
        setattr(fused, name, spy(name))
    try:
        out = fn()
    finally:
        for name, f in real.items():
            setattr(fused, name, f)
    return out, seen


def huge_serving_phase(torch, card, pred, boxes, timed, rows):
    """[slice j] the huge-N memory mode through ``Predictor``.

    (1) On ``boxes`` (2 x 2,220 and 1 x 17,760 atoms, exact far field,
    each Predictor cell-sorting the batch): explicit ``near_row_chunk``
    of :data:`HUGE_CHUNKS`, unwindowed and with the auto window, against
    ``near_row_chunk=0`` — the same bits, 5 launches of each near kernel
    a graph a chunk, the far field's 4, conservation; the near kernels in
    row blocks on the box's table (:func:`chunk_probe`).  (2) An
    undersized explicit window: the same charges twice, |sum q - Q| off.
    (3) The boxes of :data:`HUGE_BOXES` at far_cluster = :data:`HUGE_C`:
    the chunked, the windowed and the full-width Predictor (the chunk of
    ``balanced_row_chunk``, forced below ``HUGE_GRAPH_MIN_ATOMS`` and the
    auto policy's above, with its window and sort), the same bits, the
    launches, raw |sum q - Q| beside JAX's, each variant's peak device
    memory on its cold and a warm call, warm medians in turns, the cold
    set-up's parts, and the near kernels at the chunk and the full-width
    shapes.  Returns (results, the launches of the largest box's auto
    call)."""
    import math

    from epnn_tpu_torch import infer
    from epnn_tpu_torch.data import pad_molecules
    from epnn_tpu_torch.elements import table_for_n_elems
    from epnn_tpu_torch.infer import Predictor
    from epnn_tpu_torch.ops import fused, kernels
    from epnn_tpu_torch.ops.fused import balanced_row_chunk
    from epnn_tpu_torch.testing import water_box
    from epnn_tpu_torch.tools.near_field_pace import near_inputs

    cfg = pred.cfg
    table = table_for_n_elems(cfg.n_elems)
    near = ("near_message_corr", "near_pass_rowsum")

    def mk(**kw):
        return Predictor(pred.params, cfg, **kw)

    def widths(p):
        return [w for d in p._winw_cache.values() for w in d.values()]

    out = {}
    # (1) explicit chunks at the boxes of [slice b] and [slice c]
    for label, batch in boxes:
        n, b = batch.padded_atoms, batch.batch_size
        total_q = batch.total_q.astype(np.float64)
        variants = {"full": mk(near_row_chunk=0, spatial_sort="on")}
        for c in HUGE_CHUNKS:
            variants[f"chunk {c}"] = mk(near_row_chunk=c, near_window=0,
                                        spatial_sort="on")
            variants[f"chunk {c} window"] = mk(near_row_chunk=c,
                                               spatial_sort="on")
        qs, launched = {}, {}
        for name, p in variants.items():
            kernels.reset_launch_counts()
            qs[name] = p.predict_batch(batch)
            launched[name] = dict(kernels.LAUNCHES)
        entry = {"windows": {}, "launches": launched}
        for name, p in variants.items():
            require(np.array_equal(qs[name], qs["full"]),
                    ("[slice j] not the full-width bits", label, name))
            c = p.near_row_chunk or n
            want = {kn: b * (5 * math.ceil(n / c) if kn in near
                             else PER_GRAPH.get(kn, 0))
                    for kn in kernels.SOURCES}
            require(launched[name] == want, ("[slice j]", label, name,
                                             launched[name], want))
            entry["windows"][name] = widths(p)
        w1024 = entry["windows"][f"chunk {HUGE_CHUNKS[0]} window"]
        require(w1024 and all(0 < w < n for w in w1024),
                ("[slice j] the window is not engaged", label, w1024))
        cons = np.abs(qs["full"].astype(np.float64).sum(1) - total_q)
        require(np.all(cons <= 1e-4), ("[slice j]", label, cons))
        full_p = variants["full"]
        twin = full_p._sort_cache[batch][3]
        cases, nbr_table = near_inputs(full_p, twin, np.random.default_rng(0))
        probe = {c: chunk_probe(torch, label, cases, nbr_table, c)
                 for c in HUGE_CHUNKS}
        entry.update(conservation=cons.tolist(), probe=probe)
        out[label] = entry
        print(f"[slice j] {label} atoms, exact far field, cell-sorted: "
              f"near_row_chunk {HUGE_CHUNKS} with and without the auto "
              f"window (widths {entry['windows']}) give the full-width "
              f"charges bit for bit; launches "
              f"{ {k: v for k, v in launched.items() if 'window' not in k} }"
              f" (5 a graph a chunk); |sum q - Q| = {cons.tolist()}; the "
              f"near kernels in row blocks equal their full-width launch, "
              f"probe pairs (pairs, across blocks) {probe} all exact "
              f"negations on {card}")

    # (2) an undersized window on the 17,760-atom box
    label, batch = boxes[-1]
    bad = mk(near_row_chunk=HUGE_CHUNKS[0],
             near_window=HUGE_UNDERSIZED_WINDOW, spatial_sort="on")
    q1, q2 = bad.predict_batch(batch), bad.predict_batch(batch)
    cons_bad = float(np.abs(q1.astype(np.float64).sum(1)
                            - batch.total_q).max())
    ref = mk(near_row_chunk=0, spatial_sort="on").predict_batch(batch)
    gap = float(np.abs(q1 - ref).max())
    require(np.array_equal(q1, q2) and np.all(np.isfinite(q1)),
            "[slice j] undersized window: not the same charges twice")
    require(cons_bad > 1e-3 and gap > 1e-3,
            ("[slice j] undersized window dropped nothing", cons_bad, gap))
    out["undersized_window"] = dict(window=HUGE_UNDERSIZED_WINDOW,
                                    chunk=HUGE_CHUNKS[0], raw_sum_q=cons_bad,
                                    max_dq_vs_full=gap)
    print(f"[slice j] {label} atoms, chunk {HUGE_CHUNKS[0]}, window "
          f"{HUGE_UNDERSIZED_WINDOW} rows (undersized): the same charges on "
          f"two calls; |sum q - Q| = {cons_bad:.3e}, max|dq| vs full width "
          f"{gap:.3e}: the pairs outside the window are dropped on {card}")

    # (3) the huge boxes, clustered far field
    huge_launches = None
    for label, n_mol in HUGE_BOXES.items():
        mol = water_box(n_mol, seed=3)
        batch = pad_molecules([mol], table)
        n = batch.padded_atoms
        chunk = balanced_row_chunk(n, infer.HUGE_GRAPH_ROW_CHUNK)
        auto = n >= infer.HUGE_GRAPH_MIN_ATOMS
        windowed = (mk(far_cluster=HUGE_C) if auto
                    else mk(far_cluster=HUGE_C, near_row_chunk=chunk))
        require(windowed._near_chunk(batch) == chunk, (label, chunk))
        variants = {"full": mk(far_cluster=HUGE_C, near_row_chunk=0),
                    "chunked": mk(far_cluster=HUGE_C, near_row_chunk=chunk,
                                  near_window=0),
                    "windowed": windowed}
        qs, peaks, cold_ms, launched, shapes = {}, {}, {}, {}, {}
        for name in ("windowed", "chunked", "full"):
            p = variants[name]
            kernels.reset_launch_counts()
            try:
                (qs[name], cold_ms[name]), peaks[name] = peak_bytes(
                    torch, lambda: host_ms(torch, lambda: p.predict_batch(
                        batch)))
            except torch.cuda.OutOfMemoryError as err:
                require(name == "full" and auto, (label, name, str(err)))
                qs[name] = None
                peaks[name] = dict(cold="OOM")
                print(f"[slice j] {label} atoms, full width: out of device "
                      f"memory ({err}); compared at 142,080 atoms only")
                continue
            launched[name] = dict(kernels.LAUNCHES)
            peaks[name] = dict(cold=peaks[name], warm=peak_bytes(
                torch, lambda: p.predict_batch(batch))[1])
        for name in ("windowed", "full"):
            if qs[name] is not None:
                # once the peaks are read: a call that hands its near
                # launches' inputs over
                shapes[name] = first_near_args(
                    torch, fused, lambda: variants[name].predict_batch(
                        batch))[1]
        c_eff = {"full": n, "chunked": chunk, "windowed": chunk}
        for name, got in launched.items():
            want = {kn: 5 * math.ceil(n / c_eff[name]) if kn in near
                    else PER_GRAPH.get(kn, 0) for kn in kernels.SOURCES}
            require(got == want, ("[slice j]", label, name, got, want))
        if auto:
            huge_launches = launched["windowed"]
        win = widths(windowed)
        require(win and all(0 < w < n for w in win),
                ("[slice j] no window at", label, win))
        raw = {name: abs(float(q.astype(np.float64).sum()))
               for name, q in qs.items() if q is not None}
        for name, q in qs.items():
            require(q is not None or name == "full", (label, name))
            if q is not None:
                require(np.all(np.isfinite(q)) and raw[name] <= 1e-2,
                        ("[slice j]", label, name, raw[name]))
        for name in ("chunked", "windowed"):
            if qs["full"] is not None:
                require(np.array_equal(qs[name], qs["full"]),
                        ("[slice j] not the full-width bits", label, name))
        timed_variants = {name: variants[name] for name in
                          ("full", "chunked", "windowed")
                          if qs[name] is not None}
        warm = turns(timed, timed_variants,
                     lambda p: p.predict_batch(batch), 3)
        parts = {name: cold_parts(torch, p, [mol], reps=2)
                 for name, p in timed_variants.items()}
        # where a warm call's device time goes, full width against the
        # auto policy's chunks and window (the largest box only)
        prof = {}
        for name in (("full", "windowed") if auto else ()):
            if qs[name] is None:
                continue
            wall, busy, kern = device_split(
                torch, lambda: variants[name].predict_batch(batch), reps=1)
            top = sorted(kern.items(), key=lambda kv: -kv[1])[:6]
            prof[name] = dict(wall_ms=wall, device_busy_ms=busy,
                              groups=profile_groups(kern),
                              top={key[:100]: ms for key, ms in top})
        kernel_rows = {}
        for name in near:
            kernel_rows[name] = {
                f"{label} {shape}": near_shape_entry(
                    torch, card, f"{label} atoms, {shape}", name,
                    *shapes[shape][name], (5, 2))
                for shape in shapes}
            rows[name]["sizes"].update(kernel_rows[name])
        shapes.clear()
        out[label] = dict(
            atoms=n, chunk=chunk, auto=auto, windows=win,
            bitwise_vs_full=qs["full"] is not None, raw_sum_q=raw,
            jax_raw_sum_q=JAX_RAW_SUM_Q[label], peak_bytes=peaks,
            cold_ms=cold_ms, warm_turns_ms=warm, cold_parts_ms=parts,
            launches=launched, profile=prof)
        print(f"[slice j] {n:,} atoms (water_box({n_mol:,})), far_cluster "
              f"{HUGE_C}: chunk {chunk} ({'auto policy' if auto else 'forced'}"
              f"), window {win}, sorted; chunked and windowed vs full width "
              f"bit for bit: {qs['full'] is not None}; launches {launched}; "
              f"raw |sum q - Q| {raw} (JAX: {JAX_RAW_SUM_Q[label]:.2e} e); "
              f"peak device memory above the call's start (bytes) {peaks}; "
              f"cold call ms {cold_ms}; "
              f"warm predict_batch medians in turns (full, chunked, windowed, "
              f"reversed) {warm} ms; cold set-up parts (ms) {parts}; "
              f"profiled warm call (torch.profiler) {prof} on {card}")
        del variants, windowed, timed_variants, qs
        torch.cuda.empty_cache()
    require(huge_launches is not None and all(
        huge_launches[kn] > 0 for kn in ("dense_message_rowsum", *near)),
        ("[slice j] the auto path launched no kernel", huge_launches))
    return out, huge_launches


def huge_train_phase(torch, pred, card):
    """[train d] (a) on [train a]'s two 900-atom boxes, one fused step
    with ``near_row_chunk`` = :data:`HUGE_STEP_CHUNK` and ``remat`` against
    full width without remat, exact and clustered (``far_cluster_grad``):
    the loss bit for bit, gradients within 1e-5 relative Frobenius a leaf;
    (b) ``train()`` at far_cluster = :data:`HUGE_C` on one bucket of a
    213,120-atom box (noisy labels around the model's clustered charges):
    the auto policy chunks the bucket and forces remat, the loss is
    finite; step times, peak memory, far-field backward launches.
    Returns (results, the ``train()`` run's launches)."""
    from epnn_tpu_torch import infer
    from epnn_tpu_torch.data import pad_molecules, uniform_q0_contract
    from epnn_tpu_torch.elements import table_for_n_elems
    from epnn_tpu_torch.infer import Predictor
    from epnn_tpu_torch.models import tree_leaves
    from epnn_tpu_torch.ops import kernels
    from epnn_tpu_torch.ops.fused import balanced_row_chunk
    from epnn_tpu_torch.testing import water_box
    from epnn_tpu_torch.train import TrainConfig, loop, train

    cfg = pred.cfg
    g = np.random.default_rng(6)
    boxes = [water_box(TRAIN_BOX_MOLECULES, seed=30, charge=0.0),
             water_box(TRAIN_BOX_MOLECULES, seed=31, charge=-1.0)]
    batch = pad_molecules(boxes, table_for_n_elems(cfg.n_elems))
    y = (batch.node_mask * g.normal(0.0, 0.3, size=batch.node_mask.shape)
         ).astype(np.float32)
    args = [torch.from_numpy(a).cuda() for a in (
        batch.x, batch.q0, batch.xyz, batch.node_mask, y,
        np.ones(2, np.float32))]
    k = pred._neighbor_k(batch)
    uq0 = uniform_q0_contract(batch.x, batch.q0, batch.node_mask)
    steps = {}
    for c in (0, HUGE_C):
        runs = {}
        for name, kw in (("full", dict(near_row_chunk=0, remat=False)),
                         ("chunk", dict(near_row_chunk=HUGE_STEP_CHUNK,
                                        remat=True))):
            state = loop.create_state(cfg, TrainConfig(), device="cuda",
                                      params=pred.params)
            kernels.reset_launch_counts()
            _, loss, _, _ = loop.train_step_fused(
                state, cfg, "masked_mse", None, 256, k, *args,
                uniform_q0=uq0, far_cluster=c, far_cluster_grad=c > 0, **kw)
            torch.cuda.synchronize()
            runs[name] = (loss, [p.grad for p in tree_leaves(state.params)],
                          dict(kernels.LAUNCHES))
        (l_full, g_full, n_full), (l_ch, g_ch, n_ch) = runs["full"], \
            runs["chunk"]
        fro = [float(torch.linalg.norm(a - b)
                     / max(float(torch.linalg.norm(b)), 1e-30))
               for a, b in zip(g_ch, g_full)]
        require(torch.equal(l_ch, l_full), ("[train d] loss", c,
                                            float(l_ch), float(l_full)))
        require(all(np.isfinite(v) and v <= 1e-5 for v in fro),
                ("[train d] gradients", c, fro))
        steps[c] = dict(loss=float(l_full), grad_rel_fro_max=max(fro),
                        launches_full=n_full, launches_chunk_remat=n_ch)
    print(f"[train d] one fused step, 2 x {batch.natoms[0]:,} atoms, "
          f"near_row_chunk {HUGE_STEP_CHUNK} + remat vs full width: " +
          "; ".join(f"far_cluster {c}: loss {r['loss']:.9e} bit for bit, "
                    f"gradients worst relative Frobenius "
                    f"{r['grad_rel_fro_max']:.3e} (bar 1e-5), launches "
                    f"{r['launches_full']} vs {r['launches_chunk_remat']}"
                    for c, r in steps.items()) + f" on {card}")

    # (b) train() on a bucket past the threshold
    mol = water_box(HUGE_TRAIN_MOLECULES, seed=41)
    served = Predictor(pred.params, cfg, far_cluster=HUGE_C
                       ).predict_molecules([mol])[0]
    mol.labels = noisy_labels(g, served)
    pad = -(-mol.natoms // 8) * 8
    require(pad >= infer.HUGE_GRAPH_MIN_ATOMS, pad)
    want_chunk = balanced_row_chunk(pad, infer.HUGE_GRAPH_ROW_CHUNK)
    record = []
    original = loop.train_step_fused

    def spy(*a, **kw):
        before = dict(kernels.LAUNCHES)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = original(*a, **kw)
        torch.cuda.synchronize()
        record.append(dict(
            loss=float(res[1]), ms=(time.perf_counter() - t0) * 1e3,
            near_row_chunk=kw["near_row_chunk"], remat=kw["remat"],
            launches={kn: kernels.LAUNCHES[kn] - before[kn]
                      for kn in before}))
        return res

    tc = TrainConfig(epochs=HUGE_TRAIN_EPOCHS, far_cluster=HUGE_C,
                     val_fraction=0.0, init_from=CKPT)
    loop.train_step_fused = spy
    try:
        kernels.reset_launch_counts()
        (res, run_ms), peak = peak_bytes(torch, lambda: host_ms(
            torch, lambda: train([mol], cfg, tc, progress=False)))
        run_launches = dict(kernels.LAUNCHES)
    finally:
        loop.train_step_fused = original
    require(len(record) == HUGE_TRAIN_EPOCHS and all(
        r["near_row_chunk"] == want_chunk and r["remat"] for r in record),
        ("[train d] the auto policy did not chunk and remat", record))
    require(all(np.isfinite(r["loss"]) for r in record), record)
    require(run_launches["dense_message_rowsum_bwd"] > 0
            and run_launches["dense_message_rowsum"] > 0, run_launches)
    require(len(res.history) == HUGE_TRAIN_EPOCHS, res.history)
    print(f"[train d] train(far_cluster={HUGE_C}) on one {pad:,}-atom bucket,"
          f" {HUGE_TRAIN_EPOCHS} epochs: auto chunk {want_chunk} with remat "
          f"forced; steps (loss, ms) "
          f"{[(r['loss'], round(r['ms'], 1)) for r in record]}; launches a "
          f"step {record[-1]['launches']} (far-field backward "
          f"{record[-1]['launches']['dense_message_rowsum_bwd']}); peak device"
          f" memory above the run's start {peak:,} B; the run "
          f"{run_ms / 1e3:.1f} s on {card}")

    # (c) one step of that bucket: the auto chunk with remat against full
    # width without it, each step's peak above its start
    from epnn_tpu_torch.ops.fused import batch_cell_grid, build_neighbors_cell

    hb = pad_molecules([mol], table_for_n_elems(cfg.n_elems))
    hargs = [torch.from_numpy(a).cuda() for a in (
        hb.x, hb.q0, hb.xyz, hb.node_mask, hb.y, np.ones(1, np.float32))]
    hk = Predictor(pred.params, cfg)._neighbor_k(hb)
    table = build_neighbors_cell(
        hargs[2][0], hargs[3][0], float(cfg.cutoff), hk,
        *batch_cell_grid(hb.xyz, hb.node_mask, cfg.cutoff), with_d2=True,
        row_chunk=want_chunk)
    nbrs = tuple(t[None] for t in table)
    huq0 = uniform_q0_contract(hb.x, hb.q0, hb.node_mask)
    big_steps = {}
    for name, kw in (("chunk+remat", dict(near_row_chunk=want_chunk,
                                          remat=True)),
                     ("full", dict(near_row_chunk=0, remat=False))):
        state = loop.create_state(cfg, TrainConfig(), device="cuda",
                                  params=pred.params)
        try:
            ((_, loss, _, _), ms), step_peak = peak_bytes(
                torch, lambda: host_ms(torch, lambda: loop.train_step_fused(
                    state, cfg, "masked_mse", None, 256, hk, *hargs,
                    uniform_q0=huq0, far_cluster=HUGE_C,
                    far_cluster_grad=True, neighbors=nbrs, **kw)))
        except torch.cuda.OutOfMemoryError as err:
            require(name == "full", (name, str(err)))
            big_steps[name] = dict(peak_bytes="OOM", error=str(err)[:200])
            continue
        big_steps[name] = dict(loss=loss, ms=ms, peak_bytes=step_peak,
                               grads=[p.grad for p in
                                      tree_leaves(state.params)])
        del state
    ref = big_steps.get("full", {})
    if "grads" in ref:
        ch = big_steps["chunk+remat"]
        fro = max(float(torch.linalg.norm(a - b)
                        / max(float(torch.linalg.norm(b)), 1e-30))
                  for a, b in zip(ch["grads"], ref["grads"]))
        require(torch.equal(ch["loss"], ref["loss"]) and fro <= 1e-5,
                ("[train d] the bucket's step", float(ch["loss"]),
                 float(ref["loss"]), fro))
        big_steps["grad_rel_fro_max"] = fro
    for v in big_steps.values():
        if isinstance(v, dict):
            v.pop("grads", None)
            if "loss" in v:
                v["loss"] = float(v["loss"])
    out = dict(steps=steps, atoms=pad, chunk=want_chunk,
               train_steps=record, peak_bytes=peak, run_ms=run_ms,
               launches=run_launches, bucket_step=big_steps)
    print(f"[train d] one clustered step on the {pad:,}-atom bucket: "
          f"{big_steps} (peaks above the step's start, bytes; the loss bit "
          f"for bit, gradients within 1e-5 relative Frobenius) on {card}")
    return out, run_launches


#: [slice k]: the precision tiers through ``Predictor``, with JAX's names
#: (``epnn_tpu/cli.py:165-185``: ``parity`` is the CLI's default)
PRECISION_TIERS = {
    "highest": {},
    "parity": dict(matmul_precision="highest",
                   dense_matmul_precision="default"),
    "fast": dict(matmul_precision="default"),
    "bf16x3": dict(dense_matmul_precision="bf16x3"),
    "bfloat16": dict(compute_dtype="bfloat16"),
}
#: the kernels a graph forward of each tier launches on the neighbor split
#: and the TF32 tier each asks for (1 or 3 products a k-step): JAX's routes
#: — bf16x3 runs the far field's plain version, bfloat16 its bf16 message
#: rounds plain and its float32 pass rounds at "default".  The far field
#: launches in rounds 2+ (round 1 collapses), the near kernels every round.
TIER_ROUTES = {
    "highest": {"dense_message_rowsum": 3, "near_message_corr": 3,
                "near_pass_rowsum": 3},
    "parity": {"dense_message_rowsum": 1, "near_message_corr": 3,
               "near_pass_rowsum": 3},
    "fast": {"dense_message_rowsum": 1, "near_message_corr": 1,
             "near_pass_rowsum": 1},
    "bf16x3": {"near_message_corr": 3, "near_pass_rowsum": 3},
    "bfloat16": {"near_pass_rowsum": 1},
}
#: JAX's bf16 bar (tests/test_fused.py:292-311), the cap on every tier's
#: charges against highest's
TIER_CAP = 3e-2
TIER_TRAIN_EPOCHS = 3


def spy_tiers():
    """Wrap ``kernels._launch`` to record each launch's (kernel, TF32
    tier); returns (the list, a function that puts it back)."""
    from epnn_tpu_torch.ops import kernels

    seen, real = [], kernels._launch

    def launch(name, device, tensors, scalars, vector_read, h=None, e=None,
               passes=3):
        seen.append((name, passes))
        return real(name, device, tensors, scalars, vector_read, h, e,
                    passes)

    kernels._launch = launch
    return seen, lambda: setattr(kernels, "_launch", real)


def tier_routes(seen):
    """{kernel: {passes: launches}} of a :func:`spy_tiers` record."""
    out = {}
    for name, passes in seen:
        out.setdefault(name, {}).setdefault(passes, 0)
        out[name][passes] += 1
    return out


def tier_kernels_phase(torch, card, pred, batch2, big, far_sets,
                       fused_boxes, sfu_rate, clocks):
    """[slice k] the six tensor-core kernels at precision "default" (one
    TF32 product a k-step): at the shapes of ``far_sets`` ((label, args,
    cotangent, iters)), of the near kernels' tables of ``batch2`` and
    ``big``, of ``fused_boxes`` (:func:`fused_kernel_phase`'s), and at
    :data:`TIMED_WIDTH` on ``[width]``'s random-weight model: each against
    its one-pass emulation (``*_tf32_plain``; :func:`far_phase`,
    :func:`near_phase`, :func:`fused_kernel_phase` at "default"), the same
    bits twice, the pass kernels' antisymmetry probes, times beside the
    one-pass bounds.  The plain versions are not timed again (the 3xTF32
    phases timed them on the same inputs).  Returns {kernel: {label:
    measurements}}."""
    from epnn_tpu_torch.ops import kernels
    from epnn_tpu_torch.ops.fused import build_neighbors, rbf_and_gate
    from epnn_tpu_torch.tools.near_field_pace import near_inputs

    out = {name: {} for name in kernels.TIERED}
    for label, args, gbar, iters in far_sets:
        for name, entry in far_phase(torch, card, args, gbar, label, clocks,
                                     iters, precision="default").items():
            out[name][label] = entry
    for label, batch in (("2220", batch2), ("17760", big)):
        cases, table = near_inputs(pred, batch, np.random.default_rng(0))
        for name, entry in near_phase(
                torch, card, label, cases, table, (50, 0),
                min_pairs=int(batch.node_mask[0].sum()) // 4,
                precision="default").items():
            out[name][label] = entry
    wm, wp = pred._fused.messages[1], pred._fused.passes[0]
    fused_rows = fused_kernel_phase(torch, card, pred.cfg, fused_boxes, wm,
                                    wp, sfu_rate, precision="default",
                                    plain_iters=0)
    for name, row in fused_rows.items():
        sizes = row.pop("sizes")
        for key in ("name", "route", "source", "replaces", "launches",
                    "library_ms", "ptxas"):
            row.pop(key)
        out[name][fused_boxes[0][0]] = row
        out[name].update(sizes)
    # the timed width on [width]'s random-weight model
    hh, ee = TIMED_WIDTH
    label = f"{hh}x{ee}"
    (cfg_w, pred_w, batch_w, n, xyz, mask, a, wm_w, wp_w, _, _, far_args,
     gbar) = width_inputs(torch, WIDTH_CASES.index(TIMED_WIDTH), hh, ee)
    for name, entry in far_phase(torch, card, far_args, gbar, label, clocks,
                                 (10, 0, 3, 0), ties=True,
                                 precision="default").items():
        out[name][label] = entry
    cases, table = near_inputs(pred_w, batch_w,
                               np.random.default_rng(WIDTH_CASES.index(
                                   TIMED_WIDTH)))
    for name, entry in near_phase(torch, card, label, cases, table, (3, 0),
                                  min_pairs=int(mask.sum()) // 4,
                                  precision="default").items():
        out[name][label] = entry
    k = pred_w._neighbor_k(batch_w)
    _, nbr_mask, d2 = build_neighbors(xyz, mask, cfg_w.cutoff, k,
                                      with_d2=True)
    _, gate = rbf_and_gate(d2, nbr_mask, cfg_w)
    counts = dict(valid=int(mask.sum()),
                  near=int(torch.count_nonzero(nbr_mask)),
                  gated=int(torch.count_nonzero(gate * nbr_mask)))
    for name, row in fused_kernel_phase(
            torch, card, cfg_w, [(label, a, xyz, mask, counts)], wm_w, wp_w,
            sfu_rate, label, precision="default", plain_iters=0).items():
        row.pop("sizes")
        for key in ("name", "route", "source", "replaces", "launches",
                    "library_ms", "ptxas"):
            row.pop(key)
        out[name][label] = row
    for name in kernels.TIERED:
        out[name]["ptxas"] = {
            f"{h}x{e}": ptxas_usage(kernels, name, h, e, "default")
            for h, e in (SHIPPED_WIDTHS, TIMED_WIDTH)}
    print(f"[slice k] the six tensor-core kernels at precision 'default' "
          f"(one TF32 pass): every one within its bar of its one-pass "
          f"emulation at 2,220 / 17,760 atoms and at {label}, the same bits "
          f"twice, the pass kernels' pairs exact negations, on {card}")
    return out


def tier_serving_phase(torch, card, pred, batch2, big, golden, total_q,
                       timed):
    """[slice k] ``predict_batch`` in every tier of
    :data:`PRECISION_TIERS`, on ``trained/mixed_b16`` at 2 × 2,220 atoms
    (``batch2``) and 17,760 (``big``), and on ``[width]``'s random-weight
    model at the shipped widths (which reads the far field) at 2,224
    atoms: each tier's launches and the TF32 tier each asks for
    (:data:`TIER_ROUTES`), its charges against highest's under JAX's bf16
    bar :data:`TIER_CAP`·(max|q|+1) as a cap (the gap printed), parity
    against the JAX golden at the golden bar 1e-5·(max|q|+1) (JAX's
    "parity-neutral"), |Σq − Q| ≤ 1e-4 e (the random model at 2e-6·(Σ|q|
    + 1), the JAX suite's relative bar: its charges run to thousands of
    e); medians in turns (the tiers in order, then reversed) at 2 × 2,220
    atoms for every tier and at 17,760 for highest, parity and fast (the
    bf16 tiers run the plain O(N²) far field there, as JAX routes them:
    one call each, timed).  Returns the numbers and the launches of each
    tier's 2 × 2,220 call."""
    from epnn_tpu_torch.data import pad_molecules
    from epnn_tpu_torch.elements import table_for_n_elems
    from epnn_tpu_torch.infer import Predictor
    from epnn_tpu_torch.models import EPNNConfig
    from epnn_tpu_torch.models.epnn import init_params
    from epnn_tpu_torch.ops import kernels
    from epnn_tpu_torch.testing import golden_boxes

    hh, ee = SHIPPED_WIDTHS
    cfg_r = EPNNConfig(h_dim=16, e_dim=ee, msg_dim=8, mlp_hidden=(hh, hh),
                       T=WIDTH_T)
    params_r = init_params(cfg_r, torch.Generator().manual_seed(0))
    mol_r = golden_boxes()[0]
    batch_r = pad_molecules([mol_r], table_for_n_elems(cfg_r.n_elems))
    models = {"mixed_b16": (pred.params, pred.cfg),
              "random": (params_r, cfg_r)}
    sets = {"mixed_b16": [("2x2220", batch2), ("1x17760", big)],
            "random": [("1x2224", batch_r)]}
    preds = {m: {t: Predictor(p, c.replace(**kw))
                 for t, kw in PRECISION_TIERS.items()}
             for m, (p, c) in models.items()}
    out, launches = {}, {}
    for model, batches in sets.items():
        for label, batch in batches:
            qs, res = {}, {}
            for tier, p in preds[model].items():
                seen, restore = spy_tiers()
                kernels.reset_launch_counts()
                try:
                    t0 = time.perf_counter()
                    q = p.predict_batch(batch)
                    torch.cuda.synchronize()
                    ms = (time.perf_counter() - t0) * 1e3
                finally:
                    restore()
                routes = tier_routes(seen)
                t = p.cfg.T
                want = {kn: {ps: batch.batch_size * (
                    t - 1 if kn == "dense_message_rowsum" else t)}
                    for kn, ps in TIER_ROUTES[tier].items()}
                require(routes == want, ("[slice k]", model, label, tier,
                                         routes, want))
                if model == "mixed_b16" and label == "2x2220":
                    launches[tier] = dict(kernels.LAUNCHES)
                qs[tier] = q
                cons = np.abs(q.astype(np.float64).sum(1) - batch.total_q)
                cons_bar = (np.full(len(cons), 1e-4) if model == "mixed_b16"
                            else 2e-6 * (np.abs(q).sum(1) + 1.0))
                require(np.all(np.isfinite(q)) and np.all(cons <= cons_bar),
                        ("[slice k] conservation", model, label, tier, cons))
                res[tier] = dict(routes={kn: {str(ps): c for ps, c in
                                              r.items()}
                                         for kn, r in routes.items()},
                                 conservation=cons.tolist(), first_ms=ms)
            ref = qs["highest"]
            cap = TIER_CAP * (float(np.abs(ref).max()) + 1.0)
            for tier, q in qs.items():
                gap = float(np.abs(q - ref).max())
                require(gap <= cap, ("[slice k] gap", model, label, tier,
                                     gap, cap))
                res[tier]["max_abs_dq_vs_highest"] = gap
            if model == "mixed_b16" and label == "2x2220":
                tol_g = 1e-5 * (float(np.abs(golden).max()) + 1.0)
                for tier, q in qs.items():
                    dq = float(np.abs(q[:, :golden.shape[1]] - golden).max())
                    res[tier]["golden_dq"] = dq
                require(res["parity"]["golden_dq"] < tol_g,
                        ("[slice k] parity vs golden",
                         res["parity"]["golden_dq"], tol_g))
                res["golden_tol"] = tol_g
            res["cap"] = cap
            if label == "2x2220" or model == "random":
                res["turns_ms"] = turns(
                    timed, preds[model],
                    lambda p, b=batch: p.predict_batch(b), 7)
            else:
                fast3 = {t: preds[model][t] for t in ("highest", "parity",
                                                      "fast")}
                res["turns_ms"] = turns(
                    timed, fast3, lambda p, b=batch: p.predict_batch(b), 3)
            out[f"{model} {label}"] = res
            print(f"[slice k] {model} {label}: " + "; ".join(
                f"{t} routes {r['routes']}, max|dq| vs highest "
                f"{r['max_abs_dq_vs_highest']:.3e}"
                + (f", vs golden {r['golden_dq']:.3e}" if "golden_dq" in r
                   else "")
                + f", |sum q - Q| {max(r['conservation']):.3e}"
                for t, r in res.items() if isinstance(r, dict)
                and "routes" in r)
                + f" (cap {cap:.3e}"
                + (f", golden tol {res['golden_tol']:.3e}"
                   if "golden_tol" in res else "")
                + f"); predict_batch medians in turns {res['turns_ms']} ms "
                f"on {card}")
    return out, launches


def tier_train_phase(torch, card, pred, mols, val_mols):
    """[train e] ``train()`` under ``fast`` (``matmul_precision="default"``)
    from the checkpoint on ``[train b]``'s set (its labels), for
    :data:`TIER_TRAIN_EPOCHS` epochs: the fused bucket's loss falls, every
    tensor-core launch asks for the one-pass tier, and the far-field
    backward's launches of the first fused step, run again on their own
    inputs with a seeded cotangent, hold their one-pass emulation
    (:func:`far_backward` at "default").  The run's own cotangents there
    are 0: the checkpoint's far field reaches no loss on water boxes, and
    from seeded initial weights the loss runs away (1e22 in 3 epochs).
    Returns the numbers and the run's launches."""
    from epnn_tpu_torch.ops import kernels
    from epnn_tpu_torch.train import TrainConfig, loop, train

    cfg = pred.cfg.replace(**PRECISION_TIERS["fast"])
    fused_losses = []
    real = loop.train_step_fused

    def step(*a, **kw):
        out = real(*a, **kw)
        fused_losses.append(float(out[1]))
        return out

    bwd_seen = []
    with tempfile.TemporaryDirectory() as tmp:
        tc = TrainConfig(epochs=TIER_TRAIN_EPOCHS,
                         checkpoint_dir=os.path.join(tmp, "run"),
                         log_path=os.path.join(tmp, "log.jsonl"),
                         init_from=CKPT)
        seen, restore = spy_tiers()
        restore_bwd = spy_calls(kernels, "dense_message_rowsum_bwd",
                                bwd_seen)
        loop.train_step_fused = step
        try:
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            res = train(mols, cfg, tc, val_mols=val_mols)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            launches = dict(kernels.LAUNCHES)
        finally:
            loop.train_step_fused = real
            restore_bwd()
            restore()
    routes = tier_routes(seen)
    require(set(routes) == {"dense_message_rowsum",
                            "dense_message_rowsum_bwd", "near_message_corr",
                            "near_pass_rowsum"}
            and all(set(r) == {1} for r in routes.values()),
            ("[train e] routes", routes))
    require(len(fused_losses) == TIER_TRAIN_EPOCHS
            and np.all(np.isfinite(fused_losses))
            and fused_losses[-1] < fused_losses[0], fused_losses)
    require(np.isfinite(res.best_val_masked_mae), res.history)
    per_step = 2 * PER_GRAPH_TRAIN["dense_message_rowsum_bwd"]
    first = bwd_seen[:per_step]
    require(all(kw.get("precision", a[7] if len(a) > 7 else None)
                == "default" for a, kw in first), "[train e] bwd precision")
    g = np.random.default_rng(11)
    errs = [far_backward(torch, kernels, (*a[:5], torch.from_numpy(
        g.normal(size=tuple(a[5].shape)).astype(np.float32)).to(a[5].device)),
        precision="default") for a, _ in first]
    worst = {p: max(e[p][1] - e[p][4] for e in errs) for p in errs[0]}
    g_max = max(float(a[5].abs().max()) for a, _ in first)
    print(f"[train e] train() under fast (matmul_precision='default'), "
          f"{TIER_TRAIN_EPOCHS} epochs from {CKPT}: fused-bucket loss "
          f"{' -> '.join(f'{v:.6e}' for v in fused_losses)}; launches "
          f"{launches}, every one at one TF32 pass ({routes}); the first "
          f"step's {len(first)} far-field backward launches again, on their "
          f"inputs with a seeded cotangent (the run's: max|g| {g_max:.3e}), "
          f"vs their one-pass emulation: worst (err - tol) per output "
          f"{worst}; {secs:.1f} s on {card}")
    return dict(fused_losses=fused_losses, routes={
        kn: {str(p): c for p, c in r.items()} for kn, r in routes.items()},
        bwd_checked=len(first), bwd_worst_err_minus_tol=worst,
        bwd_max_cotangent=g_max,
        seconds=secs, best_val_masked_mae=res.best_val_masked_mae), launches


#: [cli]: the atom the eval-pol dimer (the Q = 0 golden box) splits at,
#: and the epochs of the CLI's fine-tune
CLI_SPLIT = 1110
CLI_TRAIN_EPOCHS = 2


def cli_run(argv):
    """``epnn_tpu_torch.cli.main(argv)`` in this process, its standard
    output captured: returns the printed lines."""
    import contextlib
    import io

    from epnn_tpu_torch import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(argv)
    return buf.getvalue().splitlines()


def cli_phase(torch, card, pred, golden, medians, train_mols, val_mols):
    """[cli] the port's CLI (``python -m epnn_tpu_torch``) on the card, at
    ``trained/mixed_b16``'s full width, on ``.xyz`` files written so they
    read back as the same float32 bits: the two golden 2,220-atom boxes
    and the 17,760-atom box.  (a) ``infer`` in process: each file equals a
    ``Predictor`` under the CLI's ``parity`` cfg bit for bit, the golden
    boxes within the golden bar, |Σq − Q| ≤ 1e-4 e, the launches of
    ``[slice k]``'s ``parity`` route tier by tier; ``--precision fast``
    within :data:`TIER_CAP` of parity on its own route.  (b) ``python -m
    epnn_tpu_torch infer`` once as a subprocess: exit 0, the same files bit
    for bit.  (c) ``bench`` at 2,220 and 17,760 atoms, chained and
    ``--per-call``: the JSON parses, ``method`` as asked, ``mean_s`` > 0,
    printed beside ``medians`` ([slice b] / [slice c]'s warm medians).
    (d) ``import-ckpt`` of a synthetic TF bundle of the checkpoint's
    weights in the reference's layout (alias paths, a snappy block): the
    params bit for bit, the reference's inferred cfg; ``infer`` from the
    imported checkpoint and from ``--reference-models``, each bit for bit
    a Predictor of those params and cfg.  (e) ``eval-pol`` on the Q = 0
    box split at :data:`CLI_SPLIT` with monomer charges 0 0: the result
    and its printed summary equal ``predict_molecules`` on the dimer minus
    the monomers bit for bit; Σ polarization within 1e-4 e.  (f) ``train
    --init-from`` the checkpoint for :data:`CLI_TRAIN_EPOCHS` epochs on
    [train b]'s molecules (``train_mols``, ``val_mols`` as ``--val-data``)
    written as ``.xyz`` + ``.npy``: ``best/params.msgpack``, finite losses,
    the far-field backward kernel launched.  Returns (numbers for the
    JSON line, launches of (a)'s parity run, launches of (f))."""
    import dataclasses

    from epnn_tpu_torch import analysis
    from epnn_tpu_torch.data import load_directory, load_molecule
    from epnn_tpu_torch.infer import Predictor
    from epnn_tpu_torch.io import load_config, load_params
    from epnn_tpu_torch.models import EPNNConfig, tree_leaves
    from epnn_tpu_torch.ops import kernels
    from epnn_tpu_torch.testing import (
        SCALING_SIZE_MOLECULES,
        golden_boxes,
        reference_variables,
        water_box,
        write_tf_bundle,
        write_xyz,
    )

    t_start = time.perf_counter()
    os.environ["EPNN_PLATFORM"] = "cuda"
    parity = PRECISION_TIERS["parity"]
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        def path(*parts):
            return os.path.join(tmp, *parts)

        boxes = golden_boxes()
        big = water_box(SCALING_SIZE_MOLECULES, seed=2)
        for m in boxes + [big]:
            write_xyz(path("data"), m)
        mols = load_directory(path("data"))
        for m in mols:
            ref = next(b for b in boxes + [big] if b.name == m.name)
            require(np.array_equal(m.xyz, ref.xyz), ("[cli] xyz bits", m.name))

        # (a) infer in process, parity then fast, each on its own route
        def infer(precision, dest):
            seen, restore = spy_tiers()
            kernels.reset_launch_counts()
            try:
                lines = cli_run(["infer", "--checkpoint", CKPT,
                                 path("data"), "--out", dest,
                                 "--precision", precision])
            finally:
                restore()
            launched = dict(kernels.LAUNCHES)
            routes = tier_routes(seen)
            t = pred.cfg.T
            want = {kn: {ps: len(mols) * (
                t - 1 if kn == "dense_message_rowsum" else t)}
                for kn, ps in TIER_ROUTES[precision].items()}
            require(routes == want, ("[cli] routes", precision, routes, want))
            return lines, launched, routes, {
                m.name: np.load(os.path.join(dest, m.name + "_pred.npy"))
                for m in mols}

        lines_p, cli_launches, routes_p, q_cli = infer("parity",
                                                       path("parity"))
        p0 = Predictor.from_checkpoint(CKPT)
        api = Predictor(p0.params, p0.cfg.replace(**parity))
        tol_g = 1e-5 * (float(np.abs(golden).max()) + 1.0)
        golden_dq, cons = [], []
        for m, q in zip(mols, api.predict_molecules(mols)):
            qc = q_cli[m.name]
            require(qc.dtype == q.dtype and np.array_equal(qc, q),
                    ("[cli] infer vs the API", m.name))
            cons.append(abs(float(qc.astype(np.float64).sum())
                            - m.total_charge))
            require(np.all(np.isfinite(qc)) and cons[-1] <= 1e-4,
                    ("[cli] conservation", m.name, cons[-1]))
            for i, b in enumerate(boxes):
                if b.name == m.name:
                    golden_dq.append(float(np.abs(qc - golden[i, :m.natoms])
                                           .max()))
                    require(golden_dq[-1] < tol_g,
                            ("[cli] vs golden", m.name, golden_dq[-1]))
        _, _, routes_f, q_fast = infer("fast", path("fast"))
        fast_gap = {}
        for name, qf in q_fast.items():
            cap = TIER_CAP * (float(np.abs(q_cli[name]).max()) + 1.0)
            fast_gap[name] = float(np.abs(qf - q_cli[name]).max())
            require(fast_gap[name] <= cap, ("[cli] fast", name, fast_gap))
        out["infer"] = dict(lines=lines_p, golden_dq=golden_dq, tol=tol_g,
                            conservation=cons, routes_parity=routes_p,
                            routes_fast=routes_f, fast_gap=fast_gap)

        # (b) python -m epnn_tpu_torch, once, as a subprocess
        root = os.path.dirname(os.path.abspath(__file__))
        env = dict(os.environ, EPNN_PLATFORM="cuda")
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (root, env.get("PYTHONPATH")) if p)
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "epnn_tpu_torch", "infer", "--checkpoint",
             CKPT, path("data"), "--out", path("sub")], cwd=root, env=env,
            capture_output=True, text=True, timeout=600)
        sub_s = time.perf_counter() - t0
        require(proc.returncode == 0, ("[cli] python -m", proc.returncode,
                                       proc.stderr[-3000:]))
        for m in mols:
            qs = np.load(path("sub", m.name + "_pred.npy"))
            require(np.array_equal(qs, q_cli[m.name]),
                    ("[cli] subprocess vs in process", m.name))
        out["subprocess_s"] = sub_s

        # (c) bench, chained and per call
        bench = {}
        for label, m in (("1x2220", boxes[0]), ("1x17760", big)):
            for method, extra in (("chained", []),
                                  ("per_call", ["--per-call"])):
                lines = cli_run(["bench", "--checkpoint", CKPT,
                                 path("data", m.name + ".xyz"), *extra])
                stats = json.loads(lines[-1])
                require(stats["method"] == method and stats["mean_s"] > 0
                        and stats["natoms"] == m.natoms,
                        ("[cli] bench", label, stats))
                bench[f"{label} {method}"] = stats
        out["bench"] = bench

        # (d) import-ckpt of a synthetic reference bundle, then infer
        os.makedirs(path("models"))
        prefix = path("models", "mixed_b16_weights")
        write_tf_bundle(prefix, reference_variables(pred.params),
                        snappy_blocks=(1,))
        lines_i = cli_run(["import-ckpt", prefix, "--out", path("imported")])
        cfg_i = load_config(path("imported"))
        want_cfg = EPNNConfig(
            n_elems=pred.cfg.n_elems, h_dim=pred.cfg.h_dim,
            e_dim=pred.cfg.e_dim, msg_dim=pred.cfg.msg_dim,
            mlp_hidden=pred.cfg.mlp_hidden, T=pred.cfg.T,
            mask_messages=False)
        require(cfg_i == want_cfg, ("[cli] imported cfg", cfg_i))
        params_i = load_params(path("imported"), cfg_i)
        require(all(torch.equal(a.cpu(), b.cpu()) for a, b in zip(
            tree_leaves(params_i), tree_leaves(pred.params))),
            "[cli] imported params")
        for b in boxes:
            write_xyz(path("golden"), b)
        gmols = load_directory(path("golden"))
        q_imp = Predictor(pred.params, cfg_i.replace(**parity)
                          ).predict_molecules(gmols)
        runs = {"imported": ["--checkpoint", path("imported")],
                "reference": ["--reference-models", path("models"),
                              "--reference-name", "mixed_b16_weights"]}
        cons_i = []
        for label, src in runs.items():
            cli_run(["infer", *src, path("golden"), "--out", path(label)])
            for m, q in zip(gmols, q_imp):
                qc = np.load(path(label, m.name + "_pred.npy"))
                require(np.array_equal(qc, q), ("[cli]", label, m.name))
                cons_i.append(abs(float(qc.astype(np.float64).sum())
                                  - m.total_charge))
        require(max(cons_i) <= 1e-4, ("[cli] imported conservation", cons_i))
        out["import"] = dict(line=lines_i[-1], conservation=cons_i)

        # (e) eval-pol on the Q = 0 box split at CLI_SPLIT
        dimer_path = write_xyz(path("pol"), dataclasses.replace(
            boxes[0], name="dimer", split=CLI_SPLIT, labels=None))
        got = []
        real = analysis.polarization_response
        analysis.polarization_response = (
            lambda *a, **kw: got.append(real(*a, **kw)) or got[-1])
        try:
            lines_e = cli_run(["eval-pol", "--checkpoint", CKPT, dimer_path,
                               "--monomer-charges", "0", "0"])
        finally:
            analysis.polarization_response = real
        dimer = load_molecule(dimer_path)
        q_d = api.predict_molecules([dimer])[0]
        q_m = np.concatenate(api.predict_molecules(list(
            analysis.split_dimer(dimer, charges=(0.0, 0.0)))))
        want = analysis.PolarizationResult(dimer.name, q_d, q_m, q_d - q_m)
        res = got[0]
        require(len(got) == 1 and np.array_equal(res.pred_polarization,
                                                 want.pred_polarization),
                "[cli] eval-pol vs predict_molecules")
        require("\n".join(lines_e) == want.summary(),
                ("[cli] eval-pol output", lines_e[:2]))
        pol_sum = abs(float(res.pred_polarization.astype(np.float64).sum()))
        require(pol_sum <= 1e-4, ("[cli] sum of polarization", pol_sum))
        out["eval_pol"] = dict(
            sum=pol_sum, max_abs=float(np.abs(res.pred_polarization).max()))

        # (f) train --init-from the checkpoint on [train b]'s molecules
        for m in train_mols:
            write_xyz(path("train"), m)
        for m in val_mols:
            write_xyz(path("val"), m)
        kernels.reset_launch_counts()
        lines_t = cli_run(["train", "--data", path("train"), "--val-data",
                           path("val"), "--out", path("run"), "--epochs",
                           str(CLI_TRAIN_EPOCHS), "--init-from", CKPT])
        train_launches = dict(kernels.LAUNCHES)
        require(os.path.exists(path("run", "best", "params.msgpack")),
                "[cli] best/params.msgpack")
        with open(path("run", "metrics.jsonl")) as f:
            rows = [json.loads(ln) for ln in f]
        losses = [r["train_loss"] for r in rows]
        require(len(rows) == CLI_TRAIN_EPOCHS and np.all(np.isfinite(losses)),
                ("[cli] train losses", losses))
        require(train_launches["dense_message_rowsum_bwd"] > 0,
                ("[cli] train launches", train_launches))
        out["train"] = dict(losses=losses, last_line=lines_t[-1],
                            launches=train_launches)
    os.environ.pop("EPNN_PLATFORM")
    out["seconds"] = time.perf_counter() - t_start
    print(f"[cli] python -m epnn_tpu_torch on the card, {CKPT}: (a) infer "
          f"of {[m.natoms for m in mols]} atoms equal to the API's parity "
          f"Predictor bit for bit, golden max|dq| {golden_dq} (tol "
          f"{tol_g:.3e}), |sum q - Q| {max(cons):.3e}, parity routes "
          f"{routes_p}, fast within {max(fast_gap.values()):.3e} of parity "
          f"on routes {routes_f}; (b) the subprocess's files the same bits "
          f"({sub_s:.1f} s); (c) bench " + "; ".join(
              f"{k} {v['mean_s'] * 1e3:.3f} ms" for k, v in bench.items())
          + f" beside [slice b]/[slice c] warm medians {medians} ms "
          f"(highest, B = 2 at 2,220); (d) {lines_i[-1]!r}, imported and "
          f"--reference-models charges the same bits; (e) eval-pol sum "
          f"{pol_sum:.3e}, max|dq| {out['eval_pol']['max_abs']:.3e}; (f) "
          f"train {CLI_TRAIN_EPOCHS} epochs: train losses {losses}, launches "
          f"{train_launches}; {out['seconds']:.1f} s on {card}")
    return out, cli_launches, train_launches


def kmeans_alone(torch, rows, weights, c, reps=5):
    """(device-busy ms, launches, host ms) of one ``weighted_kmeans`` fit of
    ``rows`` into ``c`` clusters alone: ``torch.profiler`` over ``reps``
    fits after a warm-up (the card's kernels' self time and count, a fit),
    and the host clock around the fits, synchronized (the fit is a chain
    of small launches: the host issues them slower than the card runs
    them)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from epnn_tpu_torch.ops.cluster import weighted_kmeans

    weighted_kmeans(rows, weights, c)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            weighted_kmeans(rows, weights, c)
        torch.cuda.synchronize()
        host = (time.perf_counter() - t0) * 1e3 / reps
    busy = launches = 0.0
    for ev in prof.key_averages():
        if (ev.device_type != DeviceType.CUDA
                or getattr(ev, "is_user_annotation", False)):
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0)
        busy += us / 1e3 / reps
        launches += ev.count / reps
    return busy, launches, host


def device_split(torch, fn, reps=3):
    """(wall ms, device-busy ms, {kernel: ms}) a call of ``fn``, from
    ``torch.profiler`` over ``reps`` calls after one warm-up.  Device-busy
    is the sum of the self time of the card's kernels and copies (one
    stream, so they do not overlap); the wall time includes the
    profiler's own cost."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / reps
    kern = {}
    for ev in prof.key_averages():
        if (ev.device_type != DeviceType.CUDA
                or getattr(ev, "is_user_annotation", False)):
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0)
        if us > 0:
            kern[ev.key] = kern.get(ev.key, 0.0) + us / 1e3 / reps
    return wall, sum(kern.values()), kern


#: the layers a profiled call's device time is split into, by kernel name
PROFILE_GROUPS = (
    ("far field", ("dmr_partial", "dmr_bwd_partial", "dmr_int8_partial",
                   "sum_parts")),
    ("near kernels", ("nmc_kernel", "npr_kernel")),
    ("fused dense kernels", ("fmr_kernel", "fepn_kernel")),
    ("neighbor selection", ("topk", "Topk", "sort", "Sort", "radix")),
    ("matmul", ("gemm", "xmma", "cutlass")),
    ("copies", ("Memcpy", "Memset")),
)


def profile_groups(kern):
    """{layer: ms} of a ``device_split`` kernel table; the rest is "other
    PyTorch kernels" (elementwise, gathers, reductions, Adam)."""
    out = {name: 0.0 for name, _ in PROFILE_GROUPS}
    out["other PyTorch kernels"] = 0.0
    for key, ms in kern.items():
        group = next((name for name, keys in PROFILE_GROUPS
                      if any(k in key for k in keys)),
                     "other PyTorch kernels")
        out[group] += ms
    return out


def profile_phase(torch, card, pred, batch2, big, pred8, pred_c, tiers):
    """[profile] where a call's time goes: ``predict_batch`` at 2 x 2,220
    and 1 x 17,760 atoms, a Verlet-skin step (``[slice g]``'s settings, the
    table built in the warm-up) at 17,760, the dense fused forward of
    ``[slice d]`` and one
    fused train step at 2 x 2,220 atoms (the bucket tables built once, as
    ``train()`` does), and ``pred_c``'s clustered call at 17,760 atoms,
    each as device-busy against wall time and its largest kernels.  For
    the clustered call the k-means is a group of its own: its fits' rows
    recorded in the call, each fit profiled alone (:func:`kmeans_alone`:
    device-busy time and launches) and taken out of the groups its
    kernels fall in by name ("other", "matmul", "neighbor selection" for
    its sort) in proportion; also ``predict_batch`` of each Predictor of
    ``tiers`` ({tier: p}, [slice k]) at both sizes.  Returns the numbers;
    an empty dict if the profiler recorded no device time."""
    from epnn_tpu_torch.data import uniform_q0_contract
    from epnn_tpu_torch.infer import Predictor
    from epnn_tpu_torch.ops.fused import build_neighbors_batch, forward_blocked
    from epnn_tpu_torch.train import TrainConfig, loop

    cfg = pred.cfg
    g = np.random.default_rng(7)
    y = (batch2.node_mask * g.normal(0.0, 0.3, size=batch2.node_mask.shape)
         ).astype(np.float32)
    args = [torch.from_numpy(a).cuda() for a in (
        batch2.x, batch2.q0, batch2.xyz, batch2.node_mask, y,
        np.ones(2, np.float32))]
    k = pred._neighbor_k(batch2)
    nbrs = build_neighbors_batch(args[2], args[3], cfg.cutoff, k)
    uq0 = uniform_q0_contract(batch2.x, batch2.q0, batch2.node_mask)
    state = loop.create_state(cfg, TrainConfig(), device="cuda",
                              params=pred.params)

    def dense_fused():
        with torch.no_grad():
            return forward_blocked(pred._fused, *args[:4], cfg,
                                   use_pallas=True)

    skin = Predictor(pred.params, cfg, reuse_neighbors=True,
                     neighbor_skin=MD_SKIN)
    cases = {
        "predict_batch 2x2220": lambda: pred.predict_batch(batch2),
        "predict_batch 1x17760": lambda: pred.predict_batch(big),
        "MD skin step 1x17760": lambda: skin.predict_batch(big),
        "predict_batch int8 2x2220": lambda: pred8.predict_batch(batch2),
        "predict_batch int8 1x17760": lambda: pred8.predict_batch(big),
        "dense fused forward 2x2220": dense_fused,
        "train_step_fused 2x2220": lambda: loop.train_step_fused(
            state, cfg, "masked_mse", None, 256, k, *args, uniform_q0=uq0,
            remat=False, neighbors=nbrs),
        f"predict_batch C{pred_c.far_cluster} 1x17760":
            lambda: pred_c.predict_batch(big),
    }
    for tier, p in tiers.items():
        cases[f"predict_batch {tier} 2x2220"] = (
            lambda p=p: p.predict_batch(batch2))
        cases[f"predict_batch {tier} 1x17760"] = (
            lambda p=p: p.predict_batch(big))
    from epnn_tpu_torch.ops import fused
    fits = []
    restore = spy_calls(fused, "weighted_kmeans", fits)
    try:
        pred_c.predict_batch(big)
    finally:
        restore()
    kmeans = [kmeans_alone(torch, a[0], a[1], a[2]) for a, _ in fits]
    out = {}
    for label, fn in cases.items():
        wall, busy, kern = device_split(torch, fn)
        if busy <= 0.0:
            print(f"[profile] {label}: torch.profiler recorded no device "
                  "time; no split")
            return {}
        top = sorted(kern.items(), key=lambda kv: -kv[1])[:6]
        groups = profile_groups(kern)
        if label.startswith(f"predict_batch C{pred_c.far_cluster}"):
            km = sum(k[0] for k in kmeans)
            shared = ("other PyTorch kernels", "matmul", "neighbor selection")
            pool = sum(groups[name] for name in shared)
            for name in shared:
                groups[name] -= km * groups[name] / max(pool, 1e-30)
            groups["k-means (profiled alone)"] = km
            out["k-means fits"] = dict(fits=len(kmeans), rows=[
                int(a[0].shape[0]) for a, _ in fits],
                device_busy_ms=[k[0] for k in kmeans],
                launches=[k[1] for k in kmeans],
                host_ms=[k[2] for k in kmeans])
            print(f"[profile] k-means alone, a fit of {fits[0][0][0].shape[0]:,}"
                  f" rows into {pred_c.far_cluster}: device busy "
                  f"{kmeans[0][0]:.3f} ms, {kmeans[0][1]:.0f} launches, host "
                  f"{kmeans[0][2]:.3f} ms (synchronized), {len(kmeans)} fits "
                  f"a call on {card}")
        out[label] = dict(wall_ms=wall, device_busy_ms=busy,
                          idle_share=1.0 - busy / wall, groups=groups,
                          top={name: ms for name, ms in top})
        print(f"[profile] {label}: wall {wall:.3f} ms a call (profiled), "
              f"device busy {busy:.3f} ms, idle share "
              f"{1.0 - busy / wall:.1%}; by layer: " + ", ".join(
                  f"{name} {ms:.3f}" for name, ms in groups.items())
              + " ms; largest: " + "; ".join(
                  f"{name[:60]} {ms:.3f} ms" for name, ms in top)
              + f" on {card}")
    return out


#: near kernels' inputs the kernel reads one float at a time (any view will
#: do): the row inputs, the weights (mask or gh), W1e, W2 and b2
NEAR_SCALAR_READ = (0, 3, 4, 5, 6)


def flip_flags(torch, z, delta):
    """The one-pass tier's operand flips: where relu(z) (float32) lies
    within ``delta`` + 2 float32 ulps of a TF32 rounding midpoint (or of 0),
    the kernel's own z, whose epart sums the same TF32 products in another
    order, may round to the other TF32 neighbour.  Returns (flag, the most
    such an operand can move: one TF32 ulp, or delta + 2 ulps at 0)."""
    x = torch.relu(z).contiguous()
    ulp = torch.nextafter(x, torch.full_like(x, float("inf"))) - x
    low = (x.view(torch.int32) & 0x1FFF).to(torch.float32)
    dist = (low - 4096.0).abs() * ulp
    slack = delta + 2.0 * ulp
    flag = (dist <= slack) | (z.abs() <= slack)
    return flag, torch.where(z.abs() <= slack, slack, 8192.0 * ulp)


def flip_budget(torch, terms, w2):
    """The most the one-pass tier's operand flips (:func:`flip_flags`) can
    move each output entry: ``terms`` is [(weight (R, S), z (R, S, H),
    delta (R, S, H))], each the live slots' weights and the pre-activations
    relu(z) that meet W2 after an epart; a flipped operand moves its row of
    the mid layer by at most its move times |W2| (relu is 1-Lipschitz), and
    the slot's term by its |weight| times that.  (R, H) float32."""
    out = 0.0
    aw2 = w2.abs()
    for weight, z, delta in terms:
        flag, move = flip_flags(torch, z, delta)
        dz = torch.where(flag, move, 0.0)
        out = out + torch.einsum("rs,rsf,fo->ro", weight.abs(), dz, aw2)
    return out


def epart_delta(torch, rbf, w1e):
    """The bound on how far two float32 sums, in any order, of an epart's
    E exact TF32 products can lie apart: 2 (E − 1) 2^-23 Σ_e |terms|
    (truncating adds, as the tensor cores' accumulation)."""
    from epnn_tpu_torch.ops import kernels

    e = w1e.shape[0]
    mag = kernels.tf32_round(rbf).abs() @ kernels.tf32_round(w1e).abs()
    return 2.0 * max(e - 1, 1) * 2.0 ** -23 * mag


def near_flip_budget(torch, name, args):
    """:func:`flip_budget` of near kernel ``name`` on its ``args``: the
    epart of every live slot meets W2 in relu(base + epart) (message:
    weight = the mask; pass: both orderings, weight = gh)."""
    from epnn_tpu_torch.ops import kernels

    n, hh = args[0].shape[0], args[4].shape[1]
    k = args[3].shape[1]
    w1e, w2 = args[4], args[5]
    rbf = args[2]
    ep = kernels._mm_tf32(rbf, w1e).reshape(n, k, hh)
    delta = epart_delta(torch, rbf, w1e).reshape(n, k, hh)
    if name == "near_message_corr":
        z = (args[0][:, None, :] + args[1].reshape(n, k, hh)) + ep
        return flip_budget(torch, [(args[3], z, delta)], w2)
    rs, ppn = args[0], args[1].reshape(n, k, 2 * hh)
    zn = (rs[:, None, :hh] + ppn[..., hh:]) + ep
    zt = (ppn[..., :hh] + rs[:, None, hh:]) + ep
    return flip_budget(torch, [(args[3], zn, delta), (args[3], zt, delta)],
                       w2)


def near_bound(name, args, passes=3):
    """(live slots, ``kernels.work``, :func:`tc_bound` at ``passes``) of
    one launch of the near kernel ``name`` on ``args``.  A live slot: its
    gathered row and RBF row in, rbf @ W1e and two H x H products, ~8H
    (pass: 10H) elementwise; the row inputs of rows with a live slot, the
    whole (N, K) weights, the weights once and the output."""
    from epnn_tpu_torch.ops import kernels

    live = args[3] != 0
    n_live = int(live.sum())
    wk = kernels.work(name, n=args[0].shape[0], k=args[3].shape[1],
                      h=args[4].shape[1], e=args[4].shape[0], live=n_live,
                      live_rows=int(live.any(1).sum()))
    return n_live, wk, tc_bound(wk, passes)


def near_phase(torch, card, label, cases, table, iters, min_pairs,
               precision="highest"):
    """[kernel] both near kernels at ``precision`` on one size's ``cases``
    (``near_inputs``): each against its fp32 plain version and its tier's
    emulation (:data:`EMULATION`) within 1e-5·(max|ref| + 1) — at
    "default" against the emulation only, entry by entry within the bar
    plus :func:`near_flip_budget`, the fp32 gap being the tier's — the
    same bits on a second launch and with the scalar-read inputs off the
    16-byte boundary; kernel and plain times (``iters``; a plain iters of
    0 skips it) and bounds on this data (live slots only: TF32
    tensor-core rate at the tier's products, fp32 beside it).  Then the
    ``near_pass_rowsum`` probe on the size's neighbor ``table``: disjoint
    near pairs, one slot each, each pair's two rows exact negations, with
    the M rows (of 16) their two slots took (more than ``min_pairs``
    pairs).  Returns {kernel: measurements}."""
    from epnn_tpu_torch.ops import kernels
    from epnn_tpu_torch.testing import disjoint_pair_gh

    passes = kernels.tf32_passes(precision)
    key = TIER_KEY[precision]
    out = {}
    for name, args in cases.items():
        wrapper = at(getattr(kernels, name), precision)
        plain = getattr(kernels, name + "_plain")
        emu = getattr(kernels, name + EMULATION[precision])
        n, hh = args[0].shape[0], args[4].shape[1]
        k, ee = args[3].shape[1], args[4].shape[0]
        got = wrapper(*args)
        ref = plain(*args)
        ref_emu = emu(*args)
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        if precision == "highest":
            err_emu = float((got - ref_emu).abs().max())
            tol = 1e-5 * (float(ref.abs().max()) + 1.0)
            budget = 0.0
            ok = err <= tol and err_emu <= tol
        else:
            tol = 1e-5 * (float(ref_emu.abs().max()) + 1.0)
            flips = near_flip_budget(torch, name, args)
            err_emu = float((got - ref_emu).abs().max())
            over = float(((got - ref_emu).abs() - flips).max())
            budget = float(flips.max())
            ok = over <= tol
        require(np.isfinite(err) and ok,
                (name, label, precision, err, err_emu, tol, budget))
        require(torch.equal(wrapper(*args), got),
                (name, label, "not the same bits on a second launch"))
        off = [off_boundary(t) if i in NEAR_SCALAR_READ else t
               for i, t in enumerate(args)]
        require(torch.equal(wrapper(*off), got),
                (name, label, "inputs off the 16-byte boundary"))
        ms = device_ms(torch, lambda: wrapper(*args), iters[0])
        plain_ms = plain_time(torch, lambda: plain(*args), iters[1])
        n_live, wk, (b_ms, b_by, b32) = near_bound(name, args, passes)
        out[name] = dict(
            N=n, K=k, live_slots=n_live, max_abs_err=err_emu if
            precision != "highest" else err, max_abs_diff=err,
            tol=tol, ms=ms, plain_ms=plain_ms,
            bound_ms=b_ms, bound_by=b_by, bound_fp32_ms=b32,
            flop=wk.products + wk.elementwise, bytes=wk.bytes,
            **{f"max_abs_diff_{key}": err_emu,
               f"flop_{key}": passes * wk.products})
        if precision != "highest":
            out[name]["flip_budget_max"] = budget
        plain_text = "not timed" if plain_ms is None else f"{plain_ms:.4f} ms"
        print(f"[kernel] {name} at N={n} K={k} ({n_live:,} live slots), "
              f"{TIER_TEXT[precision]}: max|d| vs plain f32 {err:.3e}, vs "
              f"its emulation {err_emu:.3e} (tol {tol:.3e}"
              + (f" + flip budget, at most {budget:.3e}" if budget else "")
              + f"), same bits on a second launch "
              f"and with the scalar-read inputs off the 16-byte boundary; "
              f"kernel {ms:.4f} ms, plain {plain_text}, bound "
              f"{b_ms:.5f} ms ({b_by}: {passes * wk.products:,} "
              f"tensor-core FLOP in {TIER_TEXT[precision]}, {wk.bytes:,} B), "
              f"fp32 bound {b32:.5f} ms on {card}")

    # antisymmetry probe: disjoint near pairs of the box, one slot each
    idx, nbr_mask = table
    args = list(cases["near_pass_rowsum"])
    n = args[0].shape[0]
    gh_probe, pairs = disjoint_pair_gh(idx.cpu().numpy(),
                                       nbr_mask.cpu().numpy())
    args[3] = torch.from_numpy(gh_probe).to(args[0].device)
    got = kernels.near_pass_rowsum(*args, precision=precision)
    torch.cuda.synchronize()
    pt = torch.from_numpy(pairs).to(got.device)
    require(len(pairs) > min_pairs, (label, len(pairs)))
    require(torch.equal(got[pt[:, 0]], -got[pt[:, 1]]),
            ("antisymmetry", label))
    require(int(torch.count_nonzero(got[pt[:, 0]])) > 0,
            ("probe all zero", label))
    pos = kernels.near_tile_positions(args[3], kernels.near_warps(
        "near_pass_rowsum", n, args[4].shape[1], args[4].shape[0], passes)
    ).cpu().numpy()
    pos = pos.max(axis=1)  # each probe row has one live slot
    m_i, m_j = pos[pairs[:, 0]], pos[pairs[:, 1]]
    require(np.all(m_i >= 0) and np.all(m_j >= 0), ("probe slots", label))
    apart = int(np.sum(m_i != m_j))
    out["near_pass_rowsum"]["probe"] = dict(
        pairs=len(pairs), at_other_m_rows=apart,
        m_row_gap_histogram=np.bincount(np.abs(m_i - m_j),
                                        minlength=16).tolist())
    print(f"[kernel] near_pass_rowsum antisymmetry probe at N={n} "
          f"({TIER_TEXT[precision]}): "
          f"{len(pairs)} disjoint pairs, every pair's rows exact negations; "
          f"{apart} pairs with their two slots at different M rows of their "
          f"16-row tiles (|M_i - M_j| histogram "
          f"{out['near_pass_rowsum']['probe']['m_row_gap_histogram']})")
    return out


def fused_flip_budget(torch, name, args, kw):
    """:func:`flip_budget` of fused kernel ``name`` on ``args``: every
    pair within the cutoff (both atoms valid, i ≠ j) gathered into a
    table (``build_neighbors`` at the exact largest count), its epart
    meeting W2 in relu(base + epart) — the message kernel's live
    correction (weight the pair mask, or col_vec_j), both orderings of
    the pass kernel (weight 0.5 · gate); the channels by the call's
    ``rbf_method``.  (N, H)."""
    from epnn_tpu_torch.featurize import (envelope_rbf_method, hard_gate,
                                          rbf_table)
    from epnn_tpu_torch.ops import kernels
    from epnn_tpu_torch.ops.fused import build_neighbors, max_neighbor_count

    pi, pj, xyz, mask = args[:4]
    message = name == "fused_message_rowsum"
    w1e, w2 = args[5:7] if message else args[4:6]
    n, hh = pi.shape
    cutoff = kw["cutoff"]
    k = max(1, max_neighbor_count(xyz.cpu().numpy(), mask.cpu().numpy(),
                                  cutoff))
    idx, nbr, d2 = build_neighbors(xyz, mask, cutoff, k, with_d2=True)
    method = kw.get("rbf_method", "direct")
    rbf, c = envelope_rbf_method(
        d2, nbr, cutoff, kw["eta"],
        rbf_table(w1e.shape[0], cutoff, kw["eta"], method, xyz.device),
        method)
    rbf = rbf.reshape(n * k, -1)
    ep = kernels._mm_tf32(rbf, w1e).reshape(n, k, hh)
    delta = epart_delta(torch, rbf, w1e).reshape(n, k, hh)
    flat = idx.reshape(-1)
    pjn, pin = pj[flat].reshape(n, k, hh), pi[flat].reshape(n, k, hh)
    if message:
        wt = (mask[:, None] * mask[flat].reshape(n, k) if kw["masked"]
              else args[4][flat].reshape(n, k)) * nbr
        return flip_budget(torch, [(wt, (pi[:, None, :] + pjn) + ep,
                                    delta)], w2)
    gate = c if kw["soft_gate"] else hard_gate(rbf.reshape(n, k, -1),
                                               kw["tol"])
    wt = 0.5 * gate * nbr
    return flip_budget(torch, [(wt, (pi[:, None, :] + pjn) + ep, delta),
                               (wt, (pin + pj[:, None, :]) + ep, delta)], w2)


def fused_check(torch, kernels, name, args, kw, rows=None, off=True,
                precision="highest"):
    """Fused kernel ``name`` at ``precision`` on ``args`` against its
    plain version and its tier's emulation within 1e-5·(max|ref| + 1)
    (the two may differ only by summation order) — at "default" against
    the emulation only, entry by entry within the bar plus
    :func:`fused_flip_budget`, the fp32 gap being the tier's — on every
    row, or on the slice ``rows`` of both; the same bits on a second
    launch, and (``off``) with every input off the 16-byte boundary (the
    kernels read every input one float at a time).  Returns (max|Δ| vs
    plain, vs emulation, tol)."""
    wrapper = at(getattr(kernels, name), precision)
    out = wrapper(*args, **kw)
    ref = getattr(kernels, name + "_plain")(*args, **kw, rows=rows)
    emu = getattr(kernels, name + EMULATION[precision])(*args, **kw,
                                                        rows=rows)
    torch.cuda.synchronize()
    got = out if rows is None else out[rows]
    err = float((got - ref).abs().max())
    err_emu = float((got - emu).abs().max())
    if precision == "highest":
        tol = 1e-5 * (float(ref.abs().max()) + 1.0)
        ok = err <= tol and err_emu <= tol
    else:
        tol = 1e-5 * (float(emu.abs().max()) + 1.0)
        flips = fused_flip_budget(torch, name, args, kw)
        flips = flips if rows is None else flips[rows]
        ok = float(((got - emu).abs() - flips).max()) <= tol
    require(np.isfinite(err) and ok,
            (name, precision, tuple(args[0].shape), kw, err, err_emu, tol))
    require(torch.equal(wrapper(*args, **kw), out),
            (name, kw, "not the same bits on a second launch"))
    if off:
        require(torch.equal(wrapper(*[off_boundary(t) for t in args], **kw),
                            out), (name, kw, "inputs off the 16-byte boundary"))
    return err, err_emu, tol


def fused_kernel_phase(torch, card, cfg, boxes, wm, wp, sfu_rate,
                       widths="32x48", precision="highest", plain_iters=3,
                       rbf_method="direct"):
    """[kernel] the two fused dense kernels, with a message round's and a
    pass round's own weights, on each of ``boxes`` — (label, a, xyz, mask,
    counts), the 2,220-atom box first: :func:`fused_check` (at the larger
    box on a 128-row slice of the plain version and the emulation, and not
    off the boundary), kernel times (the plain version's at the first box)
    and bounds on this data (:func:`fused_bound`); then the dense pass
    kernel's dimer probe.  Returns their rows of the kernels' JSON line:
    each row's numbers are those of the mode the checkpoint runs (masked
    messages, hard gate) at the first box, the other mode's under
    ``other_mode``, the larger box's under ``sizes``.  ``precision``: the
    tier checked (:func:`fused_check`), timed and bounded;
    ``plain_iters`` 0 leaves the plain version untimed; ``rbf_method``:
    the channels' method, checked, timed and bounded."""
    from epnn_tpu_torch.ops import kernels

    passes = kernels.tf32_passes(precision)
    key = TIER_KEY[precision]

    hh, ee = cfg.mlp_hidden[0], cfg.e_dim
    pair = dict(cutoff=cfg.cutoff, eta=cfg.eta, tol=cfg.is_near_tol,
                rbf_method=rbf_method)
    w = (wm.w1_e, *wm.mids[0]), (wp.w1_e, *wp.mids[0])
    # the work (``kernels.work``): the far field's product and ~5H
    # elementwise for every weighted pair of a message round; a live
    # pair's products (rbf @ W1e and two mid layers), its channels
    # (``kernels.rbf_channel_work``: direct, ~6E + 15 FLOP, E exps, a cos
    # and a sqrt) and ~12H (message) or ~14H (pass) elementwise; the d²
    # scan of every valid pair.  The hard gate's products count only its
    # gated pairs: the others add exactly 0.
    rows = {}
    for bi, (label, a, xyz, mask, counts) in enumerate(boxes):
        n, nv = a.shape[0], counts["valid"]
        near, gated = counts["near"], counts["gated"]
        pm = ((a @ wm.w1_i + wm.b1).contiguous(), (a @ wm.w1_j).contiguous())
        pp = ((a @ wp.w1_i + wp.b1).contiguous(), (a @ wp.w1_j).contiguous())
        col_vec = torch.ones(n, device=a.device)
        cases = {
            "fused_message_rowsum": [
                ("masked", dict(masked=True),
                 (*pm, xyz, mask, col_vec, *w[0])),
                ("col_vec", dict(masked=False),
                 (*pm, xyz, mask, col_vec, *w[0]))],
            "fused_epn_rowsum": [
                ("hard_gate", dict(soft_gate=False), (*pp, xyz, mask, *w[1])),
                ("soft_gate", dict(soft_gate=True), (*pp, xyz, mask, *w[1]))],
        }
        first = bi == 0
        sl = None if first else slice(n // 2 - 64, n // 2 + 64)
        for name, modes in cases.items():
            wrapper = at(getattr(kernels, name), precision)
            plain = getattr(kernels, name + "_plain")
            measured = []
            for mode, kw, args in modes:
                wk = kernels.work(name, n=n, h=hh, e=ee, valid=nv, near=near,
                                  gated=gated, rbf_method=rbf_method, **kw)
                kw = {**pair, **kw}
                err, err_emu, tol = fused_check(torch, kernels, name, args,
                                                kw, sl, off=first,
                                                precision=precision)
                ms = device_ms(torch, lambda: wrapper(*args, **kw),
                               20 if first else 5)
                plain_ms = (plain_time(torch, lambda: plain(*args, **kw),
                                       plain_iters) if first else None)
                b_ms, b_by, b32 = fused_bound(wk, sfu_rate, passes)
                measured.append(dict(
                    mode=mode, N=n, valid_atoms=nv, live_pairs=near,
                    gated_pairs=gated, max_abs_err=(
                        err if precision == "highest" else err_emu),
                    max_abs_diff=err, tol=tol,
                    rows_checked="all" if sl is None else [sl.start, sl.stop],
                    ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                    bound_fp32_ms=b32, tc_flop=wk.products,
                    elem_flop=wk.elementwise,
                    scan_instructions=wk.instructions, sfu_ops=wk.special,
                    bytes=wk.bytes, rbf_method=rbf_method,
                    **{f"max_abs_diff_{key}": err_emu,
                       f"flop_{key}": passes * wk.products}))
                print(f"[kernel] {name} ({mode}, {TIER_TEXT[precision]}) at "
                      f"N={n} ({near:,} live "
                      f"pairs, {gated:,} hard-gated): max|d| vs plain "
                      f"{err:.3e}, vs its emulation {err_emu:.3e} (tol "
                      f"{tol:.3e}" + ("" if precision == "highest" else
                                      " + flip budget") + "; rows "
                      f"{'all' if sl is None else (sl.start, sl.stop)}), "
                      f"same bits on a second launch"
                      + (" and off the 16-byte boundary" if first else "")
                      + f"; kernel {ms:.4f} ms"
                      + (f", plain {plain_ms:.4f} ms" if plain_ms else "")
                      + f", bound {b_ms:.5f} ms ({b_by}: "
                      f"{passes * wk.products:,} tensor-core FLOP in "
                      f"{TIER_TEXT[precision]}, {wk.elementwise:,} "
                      f"elementwise FLOP, {wk.instructions:,} scan "
                      f"instructions, {wk.special:,} special-function ops, "
                      f"{wk.bytes:,} B), fp32 bound {b32:.5f} ms on {card}")
            main, other = measured
            if first:
                rows[name] = dict(
                    name=name, route="cuda", source=KERNEL_ROWS[name][1],
                    replaces=KERNEL_ROWS[name][0], launches=0,
                    library_ms=None,
                    ptxas=ptxas_usage(kernels, name, hh, ee, precision),
                    **{k: v for k, v in main.items() if k != "mode"},
                    mode=main["mode"], other_mode=other, sizes={})
            else:
                rows[name]["sizes"][label] = dict(main, other_mode=other)

    # dimer probe: disjoint pairs 1.0-2.5 Å apart, each >= 4 Å from every
    # other atom, the two atoms of most pairs in different tiles
    _, a, xyz, mask, _ = boxes[0]
    n = a.shape[0]
    pp = ((a @ wp.w1_i + wp.b1).contiguous(), (a @ wp.w1_j).contiguous())
    rows["fused_epn_rowsum"]["dimer_probe"] = dimer_check(
        torch, kernels, pp, w[1], n, pair, xyz.device, widths, precision)
    return rows


def dimer_check(torch, kernels, pp, w, n, pair, dev, label,
                precision="highest"):
    """The dense pass kernel's dimer probe at ``n`` atoms (``n // 2``
    disjoint pairs, ``testing.dimer_probe``), both gates, at
    ``precision``: every pair's two rows exact negations, some transfers
    live.  Returns the counts."""
    from epnn_tpu_torch.testing import dimer_probe

    xyz_d, pairs = dimer_probe(n // 2, seed=0)
    xyz_p = torch.zeros((n, 3), device=dev)
    xyz_p[:len(xyz_d)] = torch.from_numpy(xyz_d).to(dev)
    mask_p = torch.zeros(n, device=dev)
    mask_p[:len(xyz_d)] = 1.0
    pt = torch.from_numpy(pairs).to(dev)
    live = {}
    for soft in (False, True):
        out = kernels.fused_epn_rowsum(*pp, xyz_p, mask_p, *w, **pair,
                                       soft_gate=soft, precision=precision)
        torch.cuda.synchronize()
        require(torch.equal(out[pt[:, 0]], -out[pt[:, 1]]),
                ("dimer antisymmetry", label, soft))
        live[soft] = int(torch.count_nonzero(out[pt[:, 0]].abs().sum(1)))
        require(live[soft] > 0, ("dimer probe all zero", label, soft))
    straddle = float(np.mean(pairs[:, 0] // 16 != pairs[:, 1] // 16))
    print(f"[kernel] fused_epn_rowsum dimer probe at {label} "
          f"({TIER_TEXT[precision]}): {len(pairs)} "
          f"disjoint pairs ({straddle:.1%} across two 16-row tiles), "
          f"{live[False]} / {live[True]} with a live transfer (hard / soft "
          "gate); every pair's rows exact negations")
    return dict(pairs=len(pairs), across_tiles=straddle,
                live_hard=live[False], live_soft=live[True])


def fused_parts(wk, sfu_rate, passes=3):
    """The times (ms) of a fused kernel's work ``wk`` (``kernels.work``)
    on each unit :func:`fused_bound` weighs: the tensor cores, the CUDA
    cores (elementwise FLOP and scan instructions), the special-function
    unit, and its bytes at the HBM rate."""
    return dict(
        tensor_cores=passes * wk.products / PEAK_TF32_FLOPS * 1e3,
        cuda_cores=(wk.elementwise / PEAK_FP32_FLOPS
                    + wk.instructions / PEAK_INSTR) * 1e3,
        special=wk.special / sfu_rate * 1e3,
        bytes=wk.bytes / PEAK_BYTES * 1e3)


def fused_cases(cfg, box, wm, wp):
    """The main modes' calls of the two fused kernels on one box (label,
    a, xyz, mask, counts) — masked messages with a message round's
    weights, the hard gate with a pass round's — as {kernel: (args, kw)}."""
    import torch

    _, a, xyz, mask, _ = box
    pm = ((a @ wm.w1_i + wm.b1).contiguous(), (a @ wm.w1_j).contiguous())
    pp = ((a @ wp.w1_i + wp.b1).contiguous(), (a @ wp.w1_j).contiguous())
    pair = dict(cutoff=cfg.cutoff, eta=cfg.eta, tol=cfg.is_near_tol)
    ones = torch.ones(a.shape[0], device=a.device)
    return {"fused_message_rowsum": ((*pm, xyz, mask, ones, wm.w1_e,
                                      *wm.mids[0]), dict(pair, masked=True)),
            "fused_epn_rowsum": ((*pp, xyz, mask, wp.w1_e, *wp.mids[0]),
                                 dict(pair, soft_gate=False))}


def method_turns(torch, card, cfg, boxes, wm, wp, sfu_rate, precision):
    """[kernel] the fused kernels under ``rbf_method`` "direct" and
    "doubling" at ``precision``, timed in turns (direct, doubling,
    doubling, direct; 20 launches a turn at the first box, 5 after), each
    method's time beside its bound and the bound's parts on each unit
    (:func:`fused_parts`): which method is faster, and whether the bound
    moves from the special-function unit to the CUDA cores.  Returns
    {kernel: {box label: results}}."""
    from epnn_tpu_torch.ops import kernels

    passes = kernels.tf32_passes(precision)
    hh, ee = cfg.mlp_hidden[0], cfg.e_dim
    out = {}
    for bi, box in enumerate(boxes):
        label, a, _, _, counts = box
        iters = 20 if bi == 0 else 5
        for name, (args, kw) in fused_cases(cfg, box, wm, wp).items():
            fn = at(getattr(kernels, name), precision)
            times = {"direct": [], "doubling": []}
            for method in ("direct", "doubling", "doubling", "direct"):
                times[method].append(device_ms(
                    torch, lambda: fn(*args, **kw, rbf_method=method),
                    iters))
            entry = {}
            for method, ts in times.items():
                wk = kernels.work(name, n=a.shape[0], h=hh, e=ee,
                                  valid=counts["valid"],
                                  near=counts["near"], gated=counts["gated"],
                                  rbf_method=method, **{
                                      k: v for k, v in kw.items()
                                      if k in ("masked", "soft_gate")})
                b_ms, b_by, b32 = fused_bound(wk, sfu_rate, passes)
                parts = fused_parts(wk, sfu_rate, passes)
                entry[method] = dict(
                    ms=ts, ms_mean=float(np.mean(ts)), bound_ms=b_ms,
                    bound_by=b_by, bound_fp32_ms=b32,
                    bound_unit=max(parts, key=parts.get),
                    bound_parts_ms=parts, sfu_ops=wk.special,
                    elem_flop=wk.elementwise)
            d, b = entry["direct"], entry["doubling"]
            entry["doubling_over_direct"] = b["ms_mean"] / d["ms_mean"]
            out.setdefault(name, {})[label] = entry
            print(f"[kernel] {name} rbf_method in turns (direct, doubling, "
                  f"doubling, direct) at {label}, {TIER_TEXT[precision]}: "
                  f"direct {d['ms'][0]:.4f} / {d['ms'][1]:.4f} ms, doubling "
                  f"{b['ms'][0]:.4f} / {b['ms'][1]:.4f} ms (doubling / "
                  f"direct {entry['doubling_over_direct']:.3f}); bounds "
                  f"direct {d['bound_ms']:.5f} ms (on the "
                  f"{d['bound_unit']}: " + ", ".join(
                      f"{u} {v:.5f}" for u, v in d["bound_parts_ms"].items())
                  + f"), doubling {b['bound_ms']:.5f} ms (on the "
                  f"{b['bound_unit']}: " + ", ".join(
                      f"{u} {v:.5f}" for u, v in b["bound_parts_ms"].items())
                  + f"; {d['sfu_ops']:,} -> {b['sfu_ops']:,} special-"
                  f"function ops, {d['elem_flop']:,} -> {b['elem_flop']:,} "
                  f"CUDA-core FLOP) on {card}")
    return out


def doubling_phase(torch, card, cfg, boxes, wm, wp, sfu_rate):
    """[kernel] the fused kernels' ``rbf_method="doubling"`` (two exps a
    pair; ``kernels.envelope_rbf_doubling``): on the boxes of
    :func:`fused_kernel_phase` (2,224 atoms, and 17,760 on a 128-row
    slice) and at :data:`TIMED_WIDTH` (the wide path, [width]'s model and
    box), in both TF32 tiers, every mode against its plain version and
    its tier's emulation under the doubling, the same bits twice and off
    the boundary, the dimer probe's exact negations, times and bounds
    (:func:`fused_kernel_phase`); then direct against doubling in turns
    (:func:`method_turns`).  Returns {kernel: {"doubling": results}}."""
    from epnn_tpu_torch.ops.fused import build_neighbors, rbf_and_gate

    out = {"fused_message_rowsum": {}, "fused_epn_rowsum": {}}
    wide = WIDTH_CASES.index(TIMED_WIDTH)
    (wcfg, wpred, wbatch, _, wxyz, wmask, wa, wwm, wwp, *_) = width_inputs(
        torch, wide, *TIMED_WIDTH)
    _, nbr, d2 = build_neighbors(wxyz, wmask, wcfg.cutoff,
                                 wpred._neighbor_k(wbatch), with_d2=True)
    _, gate = rbf_and_gate(d2, nbr, wcfg)
    label = f"{TIMED_WIDTH[0]}x{TIMED_WIDTH[1]}"
    wbox = [(label, wa, wxyz, wmask, dict(
        valid=int(wmask.sum()), near=int(torch.count_nonzero(nbr)),
        gated=int(torch.count_nonzero(gate * nbr))))]
    for precision, plain_iters in (("highest", 3), ("default", 0)):
        key = TIER_KEY[precision]
        rows = fused_kernel_phase(torch, card, cfg, boxes, wm, wp, sfu_rate,
                                  precision=precision,
                                  plain_iters=plain_iters,
                                  rbf_method="doubling")
        wrows = fused_kernel_phase(torch, card, wcfg, wbox, wwm, wwp,
                                   sfu_rate, label, precision, 0,
                                   rbf_method="doubling")
        turns = method_turns(torch, card, cfg, boxes, wm, wp, sfu_rate,
                             precision)
        wturns = method_turns(torch, card, wcfg, wbox, wwm, wwp, sfu_rate,
                              precision)
        for name in out:
            row = {k: v for k, v in rows[name].items()
                   if k not in ("name", "route", "source", "replaces",
                                "launches", "library_ms")}
            row["sizes"][label] = {k: v for k, v in wrows[name].items()
                                   if k not in ("name", "route", "source",
                                                "replaces", "launches",
                                                "library_ms", "sizes")}
            row["turns"] = {**turns[name], **wturns[name]}
            out[name][key] = row
    return {name: {"doubling": entry} for name, entry in out.items()}


def dense_doubling_phase(torch, card, pred, batch2, q_direct, total_q,
                         timed):
    """[slice d] ``_forward_single_pallas(rbf_method="doubling")``, the
    dense fused forward with the doubled channels, on the two 2,220-atom
    boxes: 5 + 5 fused launches a graph, max|Δq| against the direct call
    (``q_direct``, [slice d]'s), the pairs whose hard gate the doubling
    flips (each box's pairs within the cutoff, channels by both methods),
    |Σq − Q| ≤ 1e-4 e, and the two methods' medians in turns.  Returns
    (results, launches)."""
    from epnn_tpu_torch.featurize import envelope_rbf_method, hard_gate
    from epnn_tpu_torch.featurize import rbf_table
    from epnn_tpu_torch.ops import fused, kernels
    from epnn_tpu_torch.ops.fused import build_neighbors

    cfg = pred.cfg
    dev = torch.device("cuda")
    tb = [torch.from_numpy(arr).to(dev) for arr in (
        batch2.x, batch2.q0, batch2.xyz, batch2.node_mask)]

    def forward(method):
        with torch.no_grad():
            return torch.stack([fused._forward_single_pallas(
                pred._fused, *(t[b] for t in tb), cfg, rbf_method=method)
                for b in range(batch2.batch_size)]).cpu().numpy()

    kernels.reset_launch_counts()
    q = forward("doubling")
    launches = dict(kernels.LAUNCHES)
    want = {kn: batch2.batch_size * PER_GRAPH_DENSE.get(kn, 0)
            for kn in kernels.SOURCES}
    require(launches == want, ("[slice d] doubling launches", launches))
    dq = float(np.abs(q - q_direct).max())
    cons = np.abs(q.astype(np.float64).sum(1) - total_q)
    require(np.all(np.isfinite(q)) and np.all(cons <= 1e-4),
            ("[slice d] doubling conservation", cons))
    flips, live = [], []
    k = pred._neighbor_k(batch2)
    for b in range(batch2.batch_size):
        _, nbr, d2 = build_neighbors(tb[2][b], tb[3][b], cfg.cutoff, k,
                                     with_d2=True)
        gates = [hard_gate(envelope_rbf_method(
            d2, nbr, cfg.cutoff, cfg.eta,
            rbf_table(cfg.e_dim, cfg.cutoff, cfg.eta, m, dev), m)[0],
            cfg.is_near_tol) * nbr for m in ("direct", "doubling")]
        flips.append(int(torch.count_nonzero(gates[0] != gates[1])))
        live.append(int(torch.count_nonzero(gates[0])))
    turns = {"direct": [], "doubling": []}
    for method in ("direct", "doubling", "doubling", "direct"):
        turns[method].append(timed(lambda: forward(method), 5))
    out = dict(launches=launches, max_abs_dq_vs_direct=dq,
               conservation=cons.tolist(), gate_flips=flips,
               hard_gated_slots=live, median_ms_turns=turns)
    print(f"[slice d] _forward_single_pallas(rbf_method='doubling'), 2 x "
          f"2,220 atoms: launches {launches}; max|dq| vs direct {dq:.3e}; "
          f"hard-gate flips against direct {flips} of {live} gated pair "
          f"slots; |sum q - Q| = {cons.tolist()} (<= 1e-4 e); medians in "
          f"turns direct {turns['direct']} ms, doubling "
          f"{turns['doubling']} ms on {card}")
    return out, launches


#: the host threads of :func:`cpu_flops_child` (the card's phases keep
#: the other cores), and the seconds [profile] waits for it at most
CPU_FLOPS_THREADS = 4
CPU_FLOPS_TIMEOUT = 600


def cpu_flops_child(path):
    """The CPU side of [profile]'s flop count, in a process of its own
    (``--cpu-flops <path>``, started after the build so that it runs
    beside the card's phases): ``Predictor.from_checkpoint`` on the CPU,
    the program ``benchmark_batch`` times at 2 x 2,220 and 1 x 17,760
    atoms, and its products (``utils.timing.count_flops``: what
    ``benchmark_batch(cost_analysis=True)`` reports), written to ``path``
    as JSON."""
    import torch

    from epnn_tpu_torch.data import pad_molecules
    from epnn_tpu_torch.elements import table_for_n_elems
    from epnn_tpu_torch.infer import Predictor
    from epnn_tpu_torch.testing import (SCALING_SIZE_MOLECULES, golden_boxes,
                                        water_box)
    from epnn_tpu_torch.utils.timing import count_flops

    torch.set_num_threads(CPU_FLOPS_THREADS)
    pred = Predictor.from_checkpoint(CKPT, device="cpu")
    table = table_for_n_elems(pred.cfg.n_elems)
    out = {}
    for label, mols in (("2x2220", golden_boxes()),
                        ("1x17760", [water_box(SCALING_SIZE_MOLECULES,
                                               seed=2)])):
        t0 = time.perf_counter()
        with torch.no_grad():
            out[label] = count_flops(*pred._bench_program(
                pad_molecules(mols, table)))
        out[label + "_s"] = time.perf_counter() - t0
    with open(path, "w") as f:
        json.dump(out, f)
    return 0


def flops_phase(torch, card, pred, batches, child, child_out):
    """[profile] ``benchmark_batch(cost_analysis=True)`` on the card at 2
    x 2,220 and 1 x 17,760 atoms: ``flops`` (the model's products,
    ``kernels.work`` for each kernel) equal to the same call's count on
    the CPU (:func:`cpu_flops_child`, waited for here), and the products'
    rate at the call's chained latency.  Returns the results."""
    rc, text = wait_children([child], CPU_FLOPS_TIMEOUT)
    require(rc == [0], ("cpu flops child", rc, text[0][-3000:]))
    with open(child_out) as f:
        cpu = json.load(f)
    out = {}
    for label, batch in batches:
        stats = pred.benchmark_batch(batch, iters=5, warmup_loops=1,
                                     cost_analysis=True)
        require(stats.get("flops") == cpu[label],
                ("flops card vs CPU", label, stats.get("flops"), cpu[label]))
        rate = stats["flops"] / stats["mean_s"]
        out[label] = dict(flops=stats["flops"], cpu_flops=cpu[label],
                          cpu_count_s=cpu[label + "_s"],
                          mean_s=stats["mean_s"], flops_per_s=rate)
        print(f"[profile] benchmark_batch(cost_analysis=True) at {label}: "
              f"flops {stats['flops']:.6e} on the card, the CPU's count of "
              f"the same call {cpu[label]:.6e} (equal); chained "
              f"{stats['mean_s'] * 1e3:.3f} ms a call, {rate:.4e} model "
              f"FLOP/s (products only) on {card}")
    return out


def width_inputs(torch, seed, hh, ee):
    """The [width] phase's inputs at (hh, ee): a seeded random-weight model
    (the port's ``init_params``: h 16, msg 8, mid widths (H, H), E
    channels, :data:`WIDTH_T` rounds) that ``Predictor`` serves on the
    card (its kernel rounds' weights padded once), a 600-atom water box,
    seeded h, and round 2's message and round 1's pass projections.
    Returns (cfg, pred, batch, n, xyz, mask, a, wm, wp, pm, pp, far_args,
    gbar)."""
    from epnn_tpu_torch.data import pad_molecules
    from epnn_tpu_torch.elements import table_for_n_elems
    from epnn_tpu_torch.infer import Predictor
    from epnn_tpu_torch.models import EPNNConfig
    from epnn_tpu_torch.models.epnn import init_params
    from epnn_tpu_torch.testing import water_box

    dev = torch.device("cuda")
    label = f"{hh}x{ee}"
    cfg = EPNNConfig(h_dim=16, e_dim=ee, msg_dim=8, mlp_hidden=(hh, hh),
                     T=WIDTH_T)
    pred = Predictor(init_params(cfg, torch.Generator().manual_seed(seed)),
                     cfg)
    fused_w = (*pred._fused.messages, *pred._fused.passes)
    require(all(w.padded is not None and w.padded.w2.shape[0] % 8 == 0
                for w in fused_w), (label, "weights padded once"))
    batch = pad_molecules([water_box(WIDTH_BOX_MOLECULES, seed=30 + seed)],
                          table_for_n_elems(cfg.n_elems))
    n = batch.padded_atoms
    g = np.random.default_rng(seed)
    x, xyz, mask, q0 = (torch.from_numpy(np.ascontiguousarray(arr[0]))
                        .to(dev) for arr in (batch.x, batch.xyz,
                                             batch.node_mask, batch.q0))
    h = torch.from_numpy(g.normal(size=(n, cfg.h_dim)).astype(
        np.float32)).to(dev) * mask[:, None]
    a = torch.cat([x, h, q0[:, None]], dim=-1)
    wm, wp = pred._fused.messages[1], pred._fused.passes[0]
    pm = ((a @ wm.w1_i + wm.b1).contiguous(), (a @ wm.w1_j).contiguous())
    pp = ((a @ wp.w1_i + wp.b1).contiguous(), (a @ wp.w1_j).contiguous())
    far_args = (*pm, mask.contiguous(), *wm.mids[0])
    gbar = torch.from_numpy(g.normal(size=(n, hh)).astype(np.float32)).to(
        dev)
    return (cfg, pred, batch, n, xyz, mask, a, wm, wp, pm, pp, far_args,
            gbar)


def width_phase(torch, card, sfu_rate):
    """[width] the width-carrying kernels at each (H, E) of
    :data:`WIDTH_CASES`, on a seeded random-weight model (the port's
    ``init_params``: h 16, msg 8, mid widths (H, H), E channels,
    :data:`WIDTH_T` rounds) that ``Predictor`` serves on the card (its
    kernel rounds' weights padded once), with round weights on a 600-atom
    water box: the far field and its backward (``far_forward``,
    ``far_backward``), its int8 tier (``int8_phase``), both near kernels
    with the near-pair probe (``near_phase``), both fused kernels in both
    modes (:func:`fused_check`) and the dimer probe (:func:`dimer_check`).
    At :data:`FORWARD_WIDTHS` also ``forward_blocked(neighbor_k=k)`` and
    the dense fused forward against the plain dense forward on the card,
    with their launches; at :data:`TIMED_WIDTH` every kernel's time beside
    its bound on this data (:func:`far_phase`, :func:`int8_phase`,
    :func:`near_phase`, :func:`fused_kernel_phase`).  Returns {"HxE":
    results}."""
    from epnn_tpu_torch.ops import kernels
    from epnn_tpu_torch.ops.fused import (build_neighbors, forward_blocked,
                                          rbf_and_gate)
    from epnn_tpu_torch.tools.near_field_pace import near_inputs

    dev = torch.device("cuda")
    results = {}
    clocks = []
    for seed, (hh, ee) in enumerate(WIDTH_CASES):
        label = f"{hh}x{ee}"
        (cfg, pred, batch, n, xyz, mask, a, wm, wp, pm, pp, far_args,
         gbar) = width_inputs(torch, seed, hh, ee)
        entry = dict(H=hh, E=ee, N=n, ptxas={
            name: ptxas_usage(kernels, name, hh, ee)
            for name, kinds in kernels._WIDTHS_OF.items() if kinds})
        timed = (hh, ee) == TIMED_WIDTH
        if timed:
            entry.update(far_phase(torch, card, far_args, gbar, label, clocks,
                                   (10, 2, 3, 1), ties=True))
        else:
            err, err_emu, tol = far_forward(torch, kernels, far_args)
            entry["dense_message_rowsum"] = dict(
                max_abs_err=err, max_abs_diff_3xtf32=err_emu, tol=tol)
            entry["dense_message_rowsum_bwd"] = far_backward(
                torch, kernels, (*far_args, gbar), ties=True)
        entry["dense_message_rowsum_int8"] = int8_phase(
            torch, card, far_args, label, (10, 2, 10) if timed else None)
        cases, table = near_inputs(pred, batch, np.random.default_rng(seed))
        entry.update(near_phase(torch, card, label, cases, table, (3, 1),
                                min_pairs=int(mask.sum()) // 4))
        pair = dict(cutoff=cfg.cutoff, eta=cfg.eta, tol=cfg.is_near_tol)
        col_vec = torch.ones(n, device=dev)
        for name, mode, args, kw in (
                ("fused_message_rowsum", "masked",
                 (*pm, xyz, mask, col_vec, wm.w1_e, *wm.mids[0]),
                 dict(masked=True)),
                ("fused_message_rowsum", "col_vec",
                 (*pm, xyz, mask, col_vec, wm.w1_e, *wm.mids[0]),
                 dict(masked=False)),
                ("fused_epn_rowsum", "hard_gate",
                 (*pp, xyz, mask, wp.w1_e, *wp.mids[0]),
                 dict(soft_gate=False)),
                ("fused_epn_rowsum", "soft_gate",
                 (*pp, xyz, mask, wp.w1_e, *wp.mids[0]),
                 dict(soft_gate=True))):
            err, err_emu, tol = fused_check(torch, kernels, name, args,
                                            {**pair, **kw})
            entry[f"{name} {mode}"] = dict(max_abs_err=err,
                                           max_abs_diff_3xtf32=err_emu,
                                           tol=tol)
            print(f"[width] {label} {name} ({mode}) at N={n}: max|d| vs "
                  f"plain {err:.3e}, vs 3xTF32 emulation {err_emu:.3e} (tol "
                  f"{tol:.3e}), same bits on a second launch and off the "
                  "16-byte boundary")
        entry["dimer_probe"] = dimer_check(torch, kernels, pp,
                                           (wp.w1_e, *wp.mids[0]), n, pair,
                                           dev, label)
        if timed:
            k = pred._neighbor_k(batch)
            _, nbr_mask, d2 = build_neighbors(xyz, mask, cfg.cutoff, k,
                                              with_d2=True)
            _, gate = rbf_and_gate(d2, nbr_mask, cfg)
            counts = dict(valid=int(mask.sum()),
                          near=int(torch.count_nonzero(nbr_mask)),
                          gated=int(torch.count_nonzero(gate * nbr_mask)))
            entry["timed_fused"] = fused_kernel_phase(
                torch, card, cfg, [(label, a, xyz, mask, counts)], wm, wp,
                sfu_rate, label)
        if (hh, ee) in FORWARD_WIDTHS:
            tb = [torch.from_numpy(arr).to(dev) for arr in (
                batch.x, batch.q0, batch.xyz, batch.node_mask)]
            k = pred._neighbor_k(batch)
            qs, launched = {}, {}
            for path, kw in (("neighbor split", dict(neighbor_k=k)),
                             ("dense fused", dict(use_pallas=True)),
                             ("plain dense", {})):
                kernels.reset_launch_counts()
                with torch.no_grad():
                    qs[path] = forward_blocked(pred._fused, *tb, cfg, **kw)
                torch.cuda.synchronize()
                launched[path] = {kn: c for kn, c in kernels.LAUNCHES.items()
                                  if c}
            t = cfg.T
            require(launched == {
                "neighbor split": {"dense_message_rowsum": t,
                                   "near_message_corr": t,
                                   "near_pass_rowsum": t},
                "dense fused": {"fused_message_rowsum": t,
                                "fused_epn_rowsum": t},
                "plain dense": {}}, (label, launched))
            ref = qs["plain dense"]
            tol_q = 1e-5 * (float(ref.abs().max()) + 1.0)
            total_q = float(batch.total_q[0])
            # conservation at the JAX suite's relative bar: the random
            # weights' charges run to thousands of e, where float32 sums
            # over 600 atoms round far above 1e-4 e
            tol_c = 2e-6 * (float(ref.abs().sum()) + 1.0)
            fwd = {}
            for path in ("neighbor split", "dense fused"):
                dq = float((qs[path] - ref).abs().max())
                cons = abs(float(qs[path].double().sum()) - total_q)
                require(np.isfinite(dq) and dq < tol_q and cons <= tol_c,
                        (label, path, dq, tol_q, cons, tol_c))
                fwd[path] = dict(max_abs_dq=dq, conservation=cons)
            entry["forward"] = dict(launches=launched, tol=tol_q,
                                    conservation_tol=tol_c, **fwd)
            print(f"[width] {label} forward_blocked on the card, {n} atoms, "
                  f"T={t}: launches {launched}; neighbor split max|dq| vs "
                  f"the plain dense forward {fwd['neighbor split']['max_abs_dq']:.3e}"
                  f", dense fused {fwd['dense fused']['max_abs_dq']:.3e} (tol "
                  f"{tol_q:.3e}); |sum q - Q| "
                  f"{fwd['neighbor split']['conservation']:.3e} / "
                  f"{fwd['dense fused']['conservation']:.3e} (tol "
                  f"{tol_c:.3e}, 2e-6 (sum |q| + 1))")
        results[label] = entry
        print(f"[width] {label}: every width-carrying kernel within the bar "
              f"of its plain version on {card}")
    return results


def compact_phase(torch, card, cfg, boxes):
    """[kernel] neighbor_compact on each (label, xyz, mask, k): the same set
    as top-k (build_neighbors) on every row and the same table as its plain
    version, bit for bit; its time beside top-k's and two bounds: the
    operations (``kernels.COMPACT_FLOP`` a valid pair at the fp32 peak)
    and the instruction issue (``kernels.COMPACT_INSTR`` a valid pair at
    :data:`PEAK_INSTR`).  The neighbor selection line beside it: the
    cell-list builder (its ``count_only`` k, which must equal top-k's
    largest row, then its tables, on ``Predictor``'s grid), the same set
    on every row, its device time beside top-k's and the kernel's.
    Returns the kernel's row (the first box's numbers, every box's under
    ``sizes``) and the selection times by box."""
    from epnn_tpu_torch.ops import kernels
    from epnn_tpu_torch.ops.fused import (
        batch_cell_grid,
        build_neighbors,
        build_neighbors_cell,
    )

    row, selection = None, {}
    for label, xyz, mask, k in boxes:
        n = xyz.shape[0]
        idx, m = kernels.neighbor_compact(xyz, mask, cfg.cutoff, k)
        ip, mp = kernels.neighbor_compact_plain(xyz, mask, cfg.cutoff, k)
        it, mt = build_neighbors(xyz, mask, cfg.cutoff, k)
        grid = batch_cell_grid(xyz[None].cpu().numpy(),
                               mask[None].cpu().numpy(), cfg.cutoff)
        count = int(build_neighbors_cell(xyz, mask, cfg.cutoff, 1, *grid,
                                         count_only=True))
        ic, mc = build_neighbors_cell(xyz, mask, cfg.cutoff, k, *grid)
        torch.cuda.synchronize()
        err = max(float((idx - ip).abs().max()), float((m - mp).abs().max()))
        require(torch.equal(idx, ip) and torch.equal(m, mp),
                ("neighbor_compact vs plain", label))
        # the same set on every row: sort each row with empty slots last
        fill = torch.full_like(idx, n)
        got = torch.sort(torch.where(m > 0, idx, fill), dim=1).values
        want = torch.sort(torch.where(mt > 0, it, fill), dim=1).values
        require(torch.equal(got, want), ("neighbor_compact vs top-k", label))
        require(int(m.sum(1).max()) < k, ("k too small", label))
        cell = torch.sort(torch.where(mc > 0, ic, fill), dim=1).values
        require(torch.equal(cell, want), ("cell builder vs top-k", label))
        require(count == int(mt.sum(1).max()), ("count_only", label, count))
        ms = device_ms(torch, lambda: kernels.neighbor_compact(
            xyz, mask, cfg.cutoff, k), 20)
        plain_ms = device_ms(torch, lambda: kernels.neighbor_compact_plain(
            xyz, mask, cfg.cutoff, k), 3)
        topk_ms = device_ms(torch, lambda: build_neighbors(
            xyz, mask, cfg.cutoff, k), 5)
        count_ms = device_ms(torch, lambda: build_neighbors_cell(
            xyz, mask, cfg.cutoff, 1, *grid, count_only=True), 20)
        build_ms = device_ms(torch, lambda: build_neighbors_cell(
            xyz, mask, cfg.cutoff, k, *grid), 20)
        selection[label] = dict(
            grid=list(grid), count_only_k=count, k=k,
            cell_ms=count_ms + build_ms, cell_count_ms=count_ms,
            cell_build_ms=build_ms, topk_ms=topk_ms, compact_ms=ms)
        print(f"[kernel] neighbor selection at N={n} ({label}) k={k}: the "
              f"cell builder (grid ncells {grid[0]}, cap {grid[1]}; "
              f"count_only {count} = top-k's largest row), top-k and "
              f"neighbor_compact give the same set on all {n} rows; cell "
              f"builder {count_ms + build_ms:.4f} ms (count_only "
              f"{count_ms:.4f} + build {build_ms:.4f}), top-k "
              f"{topk_ms:.4f} ms, neighbor_compact {ms:.4f} ms on {card}")
        wk = kernels.work("neighbor_compact", n=n, k=k,
                          valid=int((mask > 0).sum()))
        flop, nbytes = wk.elementwise, wk.bytes
        b_ms, b_by = bound(flop, 0, nbytes, 1.0)
        issue_ms = wk.instructions / PEAK_INSTR * 1e3
        print(f"[kernel] neighbor_compact at N={n} ({label}) k={k}: the same "
              f"set as top-k on all {n} rows, the same table as its plain "
              f"version ({int(m.sum()):,} pairs); kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, build_neighbors (top-k) {topk_ms:.4f} ms,"
              f" bound {b_ms:.5f} ms ({b_by}: {flop:,} FLOP, {nbytes:,} B), "
              f"issue bound {issue_ms:.5f} ms ({kernels.COMPACT_INSTR} "
              f"instructions "
              f"a valid pair) on {card}")
        entry = dict(ms=ms, plain_ms=plain_ms, topk_ms=topk_ms, bound_ms=b_ms,
                     bound_by=b_by, bound_issue_ms=issue_ms, flop=flop,
                     bytes=nbytes, k=k, max_abs_err=err)
        if row is None:
            row = dict(name="neighbor_compact", route="cuda",
                       source=KERNEL_ROWS["neighbor_compact"][1],
                       replaces=KERNEL_ROWS["neighbor_compact"][0],
                       launches=0, library_ms=None,
                       **entry, notes="no single PyTorch call builds the "
                       "list: topk_ms is the port's top-k selection "
                       "(build_neighbors) on the same atoms; max_abs_err is "
                       "the largest |Δ| of idx and of mask against the plain "
                       "table over all sizes", sizes={})
        row["max_abs_err"] = max(row["max_abs_err"], err)
        row["sizes"][label] = entry
    return row, selection


EXPORT_MD_FRAMES = 4
EXPORT_REPS = {"2x2220": 7, "1x17760": 3}
#: a loaded artifact, in a fresh process: its charges for every call of
#: the inputs file, the launches of the first call, and the call's median
EXPORT_CHILD = r"""
import json, sys, time
import numpy as np
import torch
from epnn_tpu_torch.io import load_serving
from epnn_tpu_torch.ops import kernels

art = load_serving(sys.argv[1])
data = np.load(sys.argv[2])
calls = sorted({int(key.split("_")[0][1:]) for key in data.files})
args = [[data[f"c{c}_{i}"] for i in range(len(art.manifest["inputs"]))]
        for c in calls]
kernels.reset_launch_counts()
out = {"q0": art(*args[0])}
torch.cuda.synchronize()
launches = dict(kernels.LAUNCHES)
out.update({f"q{c}": art(*a) for c, a in zip(calls[1:], args[1:])})
ts = []
for _ in range(int(sys.argv[4])):
    t0 = time.perf_counter()
    art(*args[0])
    ts.append((time.perf_counter() - t0) * 1e3)
np.savez(sys.argv[3], **out)
print(json.dumps({"launches": launches, "device": str(art.device),
                  "ms": float(np.median(ts))}))
"""


def export_child(art_dir, calls, reps):
    """Load the artifact at ``art_dir`` in a fresh Python process and call
    it on each input tuple of ``calls``: ``(charges a call, its report)``
    (the first call's launches, the device, a median over ``reps``)."""
    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "in.npz")
        np.savez(src, **{f"c{c}_{i}": np.asarray(a) for c, args in
                         enumerate(calls) for i, a in enumerate(args)})
        root = os.path.dirname(os.path.abspath(__file__))
        proc = subprocess.run(
            [sys.executable, "-c", EXPORT_CHILD, art_dir, src,
             os.path.join(tmp, "out.npz"), str(reps)],
            cwd=root, env=dict(os.environ, PYTHONPATH=root),
            capture_output=True, text=True, timeout=600)
        require(proc.returncode == 0, ("[export] child", proc.stderr[-3000:]))
        with np.load(os.path.join(tmp, "out.npz")) as f:
            qs = [f[f"q{c}"] for c in range(len(calls))]
    return qs, json.loads(proc.stdout.strip().splitlines()[-1])


def dispatch_phase(torch, pred, batch2, reps=200):
    """The registered operators' dispatch cost: each kernel of a [slice b]
    call timed on the host through its registered operator (the route of
    an exported program) and through the operator's body called directly
    (the eager wrappers' route), on the arguments of its first launch in
    the call, in turns (op, body, body, op), each the
    median µs a call of ``reps`` enqueued calls (the card kept busy, so
    the host's cost is what is timed)."""
    from epnn_tpu_torch.ops import fused, kernels

    seen = {}
    names = ("dense_message_rowsum", "near_message_corr", "near_pass_rowsum")
    undo = [spy_calls(fused, name, seen.setdefault(name, []))
            for name in names]
    try:
        pred.predict_batch(batch2)
    finally:
        for fn in undo:
            fn()
    out = {}
    with torch.no_grad():
        for name in names:
            a, kw = seen[name][0]
            with_w1e = name != "dense_message_rowsum"
            body = kernels._BODIES[name]
            pargs = kernels._padded_args(kw.get("padded"), with_w1e)
            op = kernels._OPS[name]
            calls = {"op": lambda: op(*a, *pargs, kw["precision"]),
                     "body": lambda: body(*a, *pargs, kw["precision"])}
            for fn in calls.values():
                fn()
            runs = {"op": [], "body": []}
            for which in ("op", "body", "body", "op"):
                torch.cuda.synchronize()
                torch.cuda._sleep(50_000_000)
                t0 = time.perf_counter()
                for _ in range(reps):
                    calls[which]()
                runs[which].append((time.perf_counter() - t0) * 1e6 / reps)
                torch.cuda.synchronize()
            out[name] = {k: [round(v, 3) for v in vs]
                         for k, vs in runs.items()}
            out[name]["cost_us"] = (min(runs["op"]) - min(runs["body"]))
    per_call = {name: 2 * PER_GRAPH[name] for name in names}
    out["launches_per_call"] = per_call
    out["cost_per_call_ms"] = sum(
        max(out[n]["cost_us"], 0.0) * per_call[n] for n in names) / 1e3
    return out


def export_phase(torch, card, pred, pred8, batch2, big, small, timed):
    """[export] ``export_predictor`` on the card in each calling convention:
    dense on the small molecules, blocked at 2 x 2,220 and 1 x 17,760
    atoms (the kernels as ``epnn_torch::`` operators), md on Verlet-skin
    frames, the clustered tier (C = 32), the int8 tier, and a
    multi-platform artifact (traced on the CPU, moved to the card when
    loaded).  Each artifact is loaded in a fresh process
    (:func:`export_child`) and held to the live call: bit for bit, or
    within 1e-5·(max|q| + 1) where the live Predictor cell-sorts the atoms
    (17,760) or the artifact was traced on the CPU; the launches of each
    kernel equal to the live call's; |Σq − Q| ≤ 1e-4.  Times: the export, and the artifact's call (loaded
    here) beside the live ``predict_batch``, in turns (live, artifact,
    artifact, live)."""
    from epnn_tpu_torch.data import pad_molecules
    from epnn_tpu_torch.data.xyz import Molecule
    from epnn_tpu_torch.elements import table_for_n_elems
    from epnn_tpu_torch.infer import Predictor
    from epnn_tpu_torch.io import export_predictor, load_serving
    from epnn_tpu_torch.io.export_serving import ARTIFACT_FILE
    from epnn_tpu_torch.ops import kernels
    from epnn_tpu_torch.testing import golden_boxes

    cfg = pred.cfg
    table = table_for_n_elems(cfg.n_elems)
    small_batch = pad_molecules(small, table, pad_to=64)
    # md: a 2,220-atom box drifting within the skin (one selection)
    mol = golden_boxes()[1]
    g = np.random.default_rng(12)
    frames = (mol.xyz[None] + np.cumsum(g.uniform(
        -MD_DRIFT, MD_DRIFT, size=(EXPORT_MD_FRAMES, mol.natoms, 3)),
        axis=0)).astype(np.float32)
    md_batch = pad_molecules([Molecule(name=mol.name, symbols=mol.symbols,
                                       xyz=frames[0],
                                       total_charge=mol.total_charge)],
                             table)
    skin = Predictor(pred.params, cfg, reuse_neighbors=True,
                     neighbor_skin=MD_SKIN)
    pred_c = Predictor(pred.params, cfg, far_cluster=CLUSTER_CS[0])
    cases = [
        # label, Predictor, batch, mode, export keywords, the live call's
        # launches a graph, whether the artifact is held to the bar (the
        # live call sorts the atoms, or the artifact was traced on the CPU)
        ("dense small", pred, small_batch, "dense", {}, {}, False),
        ("blocked 2x2220", pred, batch2, "blocked", {}, PER_GRAPH, False),
        ("blocked 1x17760", pred, big, "blocked", {}, PER_GRAPH, True),
        ("md 1x2220", skin, md_batch, "md", {}, PER_GRAPH, False),
        (f"far_cluster {CLUSTER_CS[0]} 2x2220", pred_c, batch2, "blocked",
         {}, PER_GRAPH, False),
        ("int8 2x2220", pred8, batch2, "blocked", {}, PER_GRAPH_INT8,
         False),
        ("multi-platform 2x2220", pred, batch2, "blocked",
         {"platforms": ("cuda", "cpu")}, PER_GRAPH, True),
    ]
    out, path_launches = {}, None
    with tempfile.TemporaryDirectory() as tmp:
        for i, (label, p, batch, mode, kw, per_graph, at_bar) in enumerate(
                cases):
            art_dir = os.path.join(tmp, f"art{i}")
            _, export_ms = host_ms(torch, lambda: export_predictor(
                p, batch, art_dir, mode=mode, **kw))
            manifest = json.load(open(os.path.join(art_dir,
                                                   "manifest.json")))
            size = os.path.getsize(os.path.join(art_dir, ARTIFACT_FILE))
            # the live calls (md: a frame each, the skin tables as inputs)
            if mode == "md":
                calls, live_q = [], []
                kernels.reset_launch_counts()
                for f in range(EXPORT_MD_FRAMES):
                    batch.xyz[0, :mol.natoms] = frames[f]
                    live_q.append(p.predict_batch(batch))
                    if f == 0:
                        live_launches = dict(kernels.LAUNCHES)
                    idx, nbr = p._neighbors_skin(batch)
                    calls.append((batch.x, batch.q0, batch.xyz.copy(),
                                  batch.node_mask,
                                  idx.cpu().numpy().astype(np.int32),
                                  nbr.cpu().numpy()))
                require(p.skin_rebuilds == 1, ("[export] md rebuilds",
                                               p.skin_rebuilds))
            else:
                kernels.reset_launch_counts()
                live_q = [p.predict_batch(batch)]
                live_launches = dict(kernels.LAUNCHES)
                calls = [(batch.x, batch.q0, batch.xyz, batch.node_mask)]
            reps = EXPORT_REPS.get(label.split()[-1], 7)
            art_q, child = export_child(art_dir, calls, reps)
            want = {kn: batch.batch_size * per_graph.get(kn, 0)
                    for kn in kernels.SOURCES}
            require(live_launches == want, (label, live_launches, want))
            require(child["launches"] == live_launches
                    and child["device"].startswith("cuda"),
                    (label, child["device"], child["launches"],
                     live_launches))
            # the bar: the suite's between two paths of the same math, or
            # JAX's own artifact bar (5e-6 e) where the same operators
            # should give the same bits (whether they do is reported)
            dqs, tols, cons = [], [], []
            for qa, ql in zip(art_q, live_q):
                require(np.all(np.isfinite(qa)) and qa.shape == ql.shape,
                        label)
                dqs.append(float(np.abs(qa - ql).max()))
                tols.append(1e-5 * (float(np.abs(ql).max()) + 1.0)
                            if at_bar else 5e-6)
                cons.append(float(np.abs(
                    (qa.astype(np.float64) * batch.node_mask).sum(1)
                    - batch.total_q).max()))
            require(all(d <= t for d, t in zip(dqs, tols)),
                    (label, dqs, tols))
            require(max(cons) <= 1e-4, (label, cons))
            extra = {}
            if label == "blocked 1x17760":
                # the artifact keeps the caller's order: against an
                # unsorted live call, the same operators
                q_uns = Predictor(pred.params, cfg, spatial_sort="off"
                                  ).predict_batch(batch)
                extra["max_dq_unsorted"] = float(np.abs(art_q[0]
                                                        - q_uns).max())
                require(extra["max_dq_unsorted"] <= 5e-6, (label, extra))
            art = load_serving(art_dir)
            one = calls[-1]
            arms = {"live": lambda: p.predict_batch(batch),
                    "artifact": lambda: art(*one)}
            for fn in arms.values():
                fn()
            turns_ms = {"live": [], "artifact": []}
            for which in ("live", "artifact", "artifact", "live"):
                turns_ms[which].append(round(timed(arms[which], reps), 3))
            out[label] = dict(
                mode=mode, platforms=manifest["platforms"],
                neighbor_k=manifest["neighbor_k"], export_ms=export_ms,
                artifact_bytes=size, launches=child["launches"],
                live_launches=live_launches, max_dq=dqs, tol=tols,
                bitwise=max(dqs) == 0.0, conservation=cons,
                child_ms=child["ms"], child_device=child["device"],
                turns_ms=turns_ms, **extra)
            if label == "blocked 2x2220":
                path_launches = child["launches"]
            print(f"[export] {label} ({mode}, platforms "
                  f"{manifest['platforms']}, k {manifest['neighbor_k']}): "
                  f"export {export_ms:.1f} ms, {size:,} bytes; fresh process "
                  f"on {child['device']}: launches {child['launches']} (live "
                  f"{live_launches}); max|dq| vs live {max(dqs):.3e} "
                  f"(bar {min(tols):.3e}; bit for bit: {max(dqs) == 0.0})"
                  f"{'; ' + str(extra) if extra else ''}; "
                  f"|sum q - Q| <= {max(cons):.3e}; call medians in turns "
                  f"(live, artifact, artifact, live) live "
                  f"{turns_ms['live']} ms, artifact {turns_ms['artifact']} "
                  f"ms (fresh process {child['ms']:.3f} ms) on {card}")
    return out, path_launches


#: [train f]: every option of ROADMAP item 9.2 on [train b]'s fused
#: bucket (the cosine schedule; the plateau in a second run, the two
#: exclude each other), a minibatch a box so that a window of two is the
#: bucket.  The checkpoint sits at its loss minimum on [train b]'s labels:
#: Adam's first steps move every weight by about the rate, and at 1e-3 or
#: 1e-4 they overshoot (the bucket's loss rose under these options in CPU
#: runs of this phase's data, with or without the small molecules in the
#: windows), so the rate is 3e-5
TRAIN_OPTIONS = dict(learning_rate=3e-5, lr_schedule="cosine",
                     warmup_steps=1, total_steps=12, grad_clip_norm=1.0,
                     grad_accum=2, ema_decay=0.9, batch_size=1)
TRAIN_PLATEAU = dict(learning_rate=3e-5, lr_plateau_factor=0.5,
                     lr_plateau_patience=1, grad_clip_norm=1.0,
                     grad_accum=2, ema_decay=0.9, batch_size=1)
TRAIN_OPTIONS_PLATEAU_EPOCHS = 3


def schedule_f64(tc, count):
    """The warmup-cosine rate of update ``count`` in float64 (the closed
    form of optax's schedule), to hold the trainer's float32 rates to."""
    peak, warm = tc.learning_rate, tc.warmup_steps
    if warm and count < warm:
        return peak * count / warm
    end = peak * tc.lr_final_fraction
    t = min(count - warm, tc.total_steps - warm)
    return end + (peak - end) * 0.5 * (1.0 + np.cos(
        np.pi * t / (tc.total_steps - warm)))


def train_options_phase(torch, pred, card, train_mols, val_mols):
    """[train f] the trainer's options of ROADMAP items 9.2 and 9.5 on the
    card: (a) a window of two fused step calls (2 x 900 atoms) with
    clipping, the cosine schedule and ``grad_accum=2``, card against CPU:
    the weights still after the first, and the gradient Adam took (the
    clipped mean) within 1e-3 relative Frobenius a leaf, as [train a];
    (b) ``train()`` on [train b]'s fused bucket (its two boxes and labels;
    its small molecules validate) with :data:`TRAIN_OPTIONS`
    (``debug_nans`` on, quiet): the bucket's loss, averaged over an
    epoch's two boxes, falls from the first epoch to the last, the
    far-field backward launches, every rate Adam took equals the float64
    schedule within float32 rounding, ``best/`` and ``ema/`` are written;
    (c) the same with the plateau (:data:`TRAIN_PLATEAU`), finite; (d)
    ``debug_nans`` raising ``FloatingPointError`` at a NaN coordinate.
    Returns the numbers and (b)'s launches."""
    from epnn_tpu_torch.data import pad_molecules, uniform_q0_contract
    from epnn_tpu_torch.elements import table_for_n_elems
    from epnn_tpu_torch.models import tree_leaves
    from epnn_tpu_torch.ops import kernels
    from epnn_tpu_torch.testing import water_box
    from epnn_tpu_torch.train import TrainConfig, loop, train

    cfg = pred.cfg
    g = np.random.default_rng(6)
    out = {}

    # (a) one accumulation window, card against CPU
    boxes = [water_box(TRAIN_BOX_MOLECULES, seed=30, charge=0.0),
             water_box(TRAIN_BOX_MOLECULES, seed=31, charge=-1.0)]
    batch = pad_molecules(boxes, table_for_n_elems(cfg.n_elems))
    y = (batch.node_mask * g.normal(0.0, 0.3, size=batch.node_mask.shape)
         ).astype(np.float32)
    arrays = (batch.x, batch.q0, batch.xyz, batch.node_mask, y,
              np.ones(2, np.float32))
    k = pred._neighbor_k(batch)
    uq0 = uniform_q0_contract(batch.x, batch.q0, batch.node_mask)
    tc_a = TrainConfig(lr_schedule="cosine", total_steps=10,
                       grad_clip_norm=0.5, grad_accum=2)
    grads, losses, norms = {}, {}, {}
    for side, device in (("card", "cuda"), ("host", "cpu")):
        state = loop.create_state(cfg, tc_a, device=device,
                                  params=pred.params)
        args = [torch.from_numpy(a).to(device) for a in arrays]
        p0 = [p.detach().clone() for p in tree_leaves(state.params)]
        losses[side] = []
        for call in range(2):
            _, loss, _, _ = loop.train_step_fused(
                state, cfg, "masked_mse", None, 256, k, *args,
                uniform_q0=uq0, remat=False)
            losses[side].append(float(loss))
            if call == 0:
                norms[side] = float(torch.sqrt(sum(
                    (p.grad.double() ** 2).sum()
                    for p in tree_leaves(state.params))))
                require(all(torch.equal(a, b) for a, b in zip(
                    tree_leaves(state.params), p0)), "[train f] window")
        require(state.opt.count == 1, state.opt.count)
        grads[side] = [p.grad.cpu() for p in tree_leaves(state.params)]
    worst = 0.0
    for gc, gr in zip(grads["card"], grads["host"]):
        fro = float(torch.linalg.norm(gc - gr)
                    / max(float(torch.linalg.norm(gr)), 1e-30))
        require(np.isfinite(fro) and fro <= 1e-3, ("[train f] grad", fro))
        worst = max(worst, fro)
    applied = float(torch.sqrt(sum((gr.double() ** 2).sum()
                                   for gr in grads["host"])))
    require(norms["host"] > tc_a.grad_clip_norm
            and abs(applied - tc_a.grad_clip_norm) <= 1e-5, (norms,
                                                             applied))
    for lc, lh in zip(losses["card"], losses["host"]):
        require(abs(lc - lh) <= 1e-5 * (abs(lh) + 1.0), ("loss", losses))
    out["window"] = dict(losses=losses, grad_norm_first=norms,
                         applied_norm=applied, worst_fro=worst)
    print(f"[train f] (a) grad_accum 2, grad_clip_norm "
          f"{tc_a.grad_clip_norm}, cosine: a window of two fused step "
          f"calls, 2 x {batch.natoms[0]:,} atoms: weights still after the "
          f"first; losses card {losses['card']} CPU {losses['host']}; "
          f"first gradient norm {norms['card']:.4e} (card), the applied "
          f"mean clipped to {applied:.6f}; card vs CPU relative Frobenius "
          f"<= 1e-3 a leaf (worst {worst:.3e}); Adam count 1")

    # (b), (c) train() with every option of 9.2, on [train b]'s boxes
    boxes = [m for m in train_mols if m.natoms > TrainConfig.dense_max_atoms]
    per_step = {kn: PER_GRAPH_TRAIN.get(kn, 0) for kn in kernels.SOURCES}
    for label, opts, epochs in (("cosine", TRAIN_OPTIONS, TRAIN_EPOCHS),
                                ("plateau", TRAIN_PLATEAU,
                                 TRAIN_OPTIONS_PLATEAU_EPOCHS)):
        rates, fused_losses = [], []
        real_rate, real_fused = loop.Optimizer.rate, loop.train_step_fused

        def rate(self):
            rates.append((self.count, real_rate(self)))
            return rates[-1][1]

        def fused_step(*a, **kw):
            res = real_fused(*a, **kw)
            fused_losses.append(float(res[1]))
            return res

        with tempfile.TemporaryDirectory() as tmp:
            run = os.path.join(tmp, "run")
            tc = TrainConfig(epochs=epochs, checkpoint_dir=run,
                             init_from=CKPT, debug_nans=True, **opts)
            loop.Optimizer.rate, loop.train_step_fused = rate, fused_step
            try:
                kernels.reset_launch_counts()
                t0 = time.perf_counter()
                res = train(boxes, cfg, tc, val_mols=val_mols)
                torch.cuda.synchronize()
                secs = time.perf_counter() - t0
                launches = dict(kernels.LAUNCHES)
            finally:
                loop.Optimizer.rate, loop.train_step_fused = (real_rate,
                                                              real_fused)
            saved = sorted(d for d in ("best", "ema")
                           if os.path.isdir(os.path.join(run, d)))
        require(saved == ["best", "ema"], saved)
        # the loss falls under every option of 9.2 (the cosine run); the
        # plateau run's shorter one only has to stay finite
        steps = len(boxes) * epochs
        epoch_loss = np.mean(np.reshape(fused_losses, (epochs, -1)), 1)
        require(len(fused_losses) == steps and np.all(np.isfinite(
            fused_losses)) and (label == "plateau"
                                or epoch_loss[-1] < epoch_loss[0]),
            (label, fused_losses))
        require(launches == {kn: steps * n for kn, n in per_step.items()},
                (label, launches))
        require(res.state.opt.count == len(rates) > 0, (label, len(rates)))
        if label == "cosine":
            errs = [abs(r - schedule_f64(tc, c)) / max(schedule_f64(tc, c),
                                                       1e-30)
                    for c, r in rates]
            require(rates[0][1] == 0.0 and max(errs[1:]) <= 1e-6,
                    ("rates", rates))
            main_launches = launches
        else:
            lrs = [r["lr"] for r in res.history]
            require(all(r == float(np.float32(lrs[0]))
                        or r < lrs[0] for _, r in rates), rates)
            errs = []
        out[label] = dict(options=opts, epochs=epochs, seconds=secs,
                          fused_losses=fused_losses,
                          epoch_losses=epoch_loss.tolist(),
                          launches=launches,
                          rates=rates, rate_rel_err_max=max(errs or [0.0]),
                          lr_rows=[r.get("lr") for r in res.history],
                          best_val_masked_mae=res.best_val_masked_mae)
        print(f"[train f] ({'b' if label == 'cosine' else 'c'}) train() "
              f"{epochs} epochs from {CKPT} on {len(boxes)} x "
              f"{boxes[0].natoms:,} atoms with {opts}, "
              f"debug_nans: fused-bucket loss an epoch "
              f"{' -> '.join(f'{v:.6e}' for v in epoch_loss)} (a step "
              f"{' '.join(f'{v:.6e}' for v in fused_losses)}); launches "
              f"{launches}; {len(rates)} Adam updates, rates "
              f"{[round(r, 9) for _, r in rates]}"
              + (f" (vs the float64 schedule: max rel {max(errs):.2e})"
                 if errs else f", rows' lr {out[label]['lr_rows']}")
              + f"; best/ and ema/ written; {secs:.1f} s on {card}")

    # (d) debug_nans at a NaN coordinate
    bad = [water_box(5, seed=40 + i) for i in range(4)]
    for m in bad:
        m.labels = np.zeros(m.natoms, np.float32)
    bad[2].xyz[1, 0] = np.nan
    try:
        train(bad, cfg, TrainConfig(epochs=1, batch_size=2, debug_nans=True,
                                    init_from=CKPT), progress=False)
        raised = None
    except FloatingPointError as e:
        raised = str(e)
    require(raised is not None and "non-finite xyz at step" in raised,
            ("[train f] debug_nans", raised))
    out["debug_nans"] = raised
    print(f"[train f] (d) debug_nans, a NaN coordinate: FloatingPointError "
          f"{raised!r}")
    return out, main_launches


# ---------------------------------------------------------------------------
# [mesh] multi-device serving on the one card
# ---------------------------------------------------------------------------

#: [mesh]: the clustered tier's C, the two-rank part's world size, its
#: children's timeout (s), and the far-field kernel's reps at the ranks'
#: shapes (kernel, plain)
MESH_C = 32
MESH_RANKS = 2
MESH_CHILD_TIMEOUT = 480
MESH_SHAPE_ITERS = (20, 3)
#: the gloo collectives the probe tries on CUDA tensors, in order (the
#: point-to-point exchange last: a backend that takes its device pointer
#: for a host one would fail there, after the others have answered)
GLOO_PROBE_OPS = ("all_reduce_sum", "all_reduce_max", "broadcast",
                  "all_gather", "all_gather_into_tensor", "reduce_scatter",
                  "reduce_scatter_tensor", "send_recv")
#: [mesh c]: ``train(mesh=...)``'s epochs on the two ranks, and the reps of
#: the far-field backward and the near kernels at the ranks' shapes
#: (kernel, plain)
MESH_TRAIN_EPOCHS = 2
MESH_TRAIN_ITERS = (20, 3)


def mesh_boxes(table):
    """[mesh]'s batches: the two 2,220-atom golden boxes (B = 2) and the
    17,760-atom box (B = 1), with their net charges."""
    from epnn_tpu_torch.data import pad_molecules
    from epnn_tpu_torch.testing import (SCALING_SIZE_MOLECULES,
                                        golden_boxes, water_box)

    return [("2x2220", pad_molecules(golden_boxes(), table),
             np.array([0.0, 1.0])),
            ("1x17760", pad_molecules([water_box(SCALING_SIZE_MOLECULES,
                                                 seed=2)], table),
             np.array([0.0]))]


def mesh_want(mode, c, d, b, t=5):
    """Launches of each kernel a call of B graphs on one of D ranks (T
    rounds, round 1 collapsed): the far field once a round after the
    first (ring, exact: once a ring step), each near kernel once a round
    (ring: once a step)."""
    steps = d if mode == "ring" else 1
    far = (t - 1) * (steps if mode == "ring" and c == 0 else 1)
    return {"dense_message_rowsum": b * far,
            "near_message_corr": b * t * steps,
            "near_pass_rowsum": b * t * steps}


def mesh_train_want(mode, c, d, b, t):
    """:func:`mesh_want` for a train step: one far-field backward launch
    for each far-field forward (the near kernels recompute through their
    plain versions)."""
    want = mesh_want(mode, c, d, b, t)
    return {**want, "dense_message_rowsum_bwd": want["dense_message_rowsum"]}


def mesh_random_model():
    """``[width]``'s seeded random-weight model at the shipped widths: one
    that reads the far field (``mixed_b16``'s charges do not on water, so
    its far-field backward gets a zero cotangent)."""
    import torch

    from epnn_tpu_torch.infer import Predictor
    from epnn_tpu_torch.models import EPNNConfig
    from epnn_tpu_torch.models.epnn import init_params

    hh, ee = SHIPPED_WIDTHS
    cfg = EPNNConfig(h_dim=16, e_dim=ee, msg_dim=8, mlp_hidden=(hh, hh),
                     T=WIDTH_T)
    return Predictor(init_params(cfg, torch.Generator().manual_seed(0)), cfg)


def mesh_one_rank_phase(torch, card, pred, boxes, refs, timed):
    """[mesh a] A real NCCL process group of world size 1 on the card
    (``make_mesh(1, 1)``): ``Predictor(mesh=..., shard_mode=...)`` in
    'atom' and 'ring', exact and at ``far_cluster=MESH_C``, on each box of
    ``boxes``: charges against the one-card Predictor's (``refs``: exact;
    the clustered one-card Predictor for C > 0) — bit for bit where it
    holds, else within 1e-5·(max|q| + 1) —, |Σq − Q| ≤ 1e-4, each
    kernel's launches (:func:`mesh_want`), and the medians in turns
    against the one-card call; then [mesh c] (a) on the same world
    (:func:`mesh_train_one_rank`).  Returns ({case: report}, launches
    summed over the calls, [mesh c] (a)'s report and launches)."""
    import torch.distributed as dist

    from epnn_tpu_torch.infer import Predictor
    from epnn_tpu_torch.ops import kernels
    from epnn_tpu_torch.parallel import initialize_distributed, make_mesh

    initialize_distributed()
    require(dist.get_backend() == "nccl" and dist.get_world_size() == 1,
            ("[mesh a] process group", dist.get_backend()))
    mesh = make_mesh(1, 1)
    probe = torch.ones(4, device="cuda")
    dist.all_reduce(probe)
    require(torch.equal(probe.cpu(), torch.ones(4)), "[mesh a] NCCL all_reduce")
    singles = {0: pred, MESH_C: Predictor(pred.params, pred.cfg,
                                          far_cluster=MESH_C)}
    out, total = {}, dict.fromkeys(kernels.SOURCES, 0)
    for mode in ("atom", "ring"):
        for c in (0, MESH_C):
            mp = Predictor(pred.params, pred.cfg, mesh=mesh, shard_mode=mode,
                           far_cluster=c)
            for label, batch, total_q in boxes:
                ref = refs[label] if c == 0 else singles[c].predict_batch(
                    batch)
                kernels.reset_launch_counts()
                q = mp.predict_batch(batch)
                got = dict(kernels.LAUNCHES)
                for kn, v in got.items():
                    total[kn] += v
                want = mesh_want(mode, c, 1, batch.batch_size)
                require({kn: v for kn, v in got.items() if v} == want,
                        ("[mesh a] launches", mode, c, label, got, want))
                dq = float(np.abs(q - ref).max())
                tol = 1e-5 * (float(np.abs(ref).max()) + 1.0)
                cons = np.abs(q.astype(np.float64).sum(1) - total_q)
                require(np.all(np.isfinite(q)) and dq <= tol
                        and np.all(cons <= 1e-4),
                        ("[mesh a]", mode, c, label, dq, tol, cons))
                reps = 5 if label == "2x2220" else 2
                t = turns(timed, {"one card": singles[c], mode: mp},
                          lambda p: p.predict_batch(batch), reps)
                out[f"{mode} C={c} {label}"] = dict(
                    bit_for_bit=bool(np.array_equal(q, ref)), max_dq=dq,
                    tol=tol, sum_q_err=cons.tolist(), launches=want,
                    ms_turns=t)
                print(f"[mesh a] one NCCL rank, shard_mode={mode!r}, "
                      f"far_cluster={c}, {label}: vs the one-card call "
                      f"{'bit for bit' if np.array_equal(q, ref) else ''} "
                      f"max|dq| {dq:.3e} (tol {tol:.3e}); |sum q - Q| "
                      f"{cons.tolist()}; launches {want}; medians in turns "
                      f"(one card, mesh, mesh, one card) {t} ms on {card}")
    train_out, train_total = mesh_train_one_rank(torch, card, pred, mesh)
    dist.destroy_process_group()
    return out, total, train_out, train_total


def mesh_shape_rows(torch, card, far_args, big_args, rows):
    """[mesh] the far-field kernel at the ranks' shapes of the two-rank
    split: atom-sharded R = N/2 rows against all N columns (1,112 × 2,224
    and 8,880 × 17,760), the ring's N/2 × N/2 blocks (8,880 × 8,880, the
    second block's columns), and R × C over MESH_C centroids of the pj
    rows: each against its plain version and 3xTF32 emulation
    (:func:`far_forward`), kernel and plain times, and the bound on this
    data, added to ``rows["dense_message_rowsum"]["sizes"]``."""
    from epnn_tpu_torch.ops import kernels
    from epnn_tpu_torch.ops.cluster import weighted_kmeans

    def cut(args, rows_sl, cols_sl):
        pi, pj, cv, w2, b2 = args
        return (pi[rows_sl].contiguous(), pj[cols_sl].contiguous(),
                cv[cols_sl].contiguous(), w2, b2)

    def clustered(args, rows_sl):
        pi, pj, cv, w2, b2 = args
        cent, wts, _ = weighted_kmeans(pj, cv, MESH_C)
        return pi[rows_sl].contiguous(), cent.contiguous(), wts, w2, b2

    n2, n3 = far_args[0].shape[0], big_args[0].shape[0]
    cases = {
        f"atom {n2 // 2}x{n2}": cut(far_args, slice(0, n2 // 2),
                                     slice(0, n2)),
        f"atom {n3 // 2}x{n3}": cut(big_args, slice(0, n3 // 2),
                                     slice(0, n3)),
        f"ring {n3 // 2}x{n3 // 2}": cut(big_args, slice(0, n3 // 2),
                                          slice(n3 // 2, n3)),
        f"cluster {n2 // 2}x{MESH_C}": clustered(far_args,
                                                  slice(0, n2 // 2)),
        f"cluster {n3 // 2}x{MESH_C}": clustered(big_args,
                                                  slice(0, n3 // 2)),
    }
    fwd = at(kernels.dense_message_rowsum, "highest")
    out = {}
    for label, args in cases.items():
        err, err_emu, tol = far_forward(torch, kernels, args)
        r, hh = args[0].shape
        nc = args[1].shape[0]
        live = int(torch.count_nonzero(args[2]))
        ms = device_ms(torch, lambda: fwd(*args), MESH_SHAPE_ITERS[0])
        plain_ms = device_ms(
            torch, lambda: kernels.dense_message_rowsum_plain(*args),
            MESH_SHAPE_ITERS[1])
        wk = kernels.work("dense_message_rowsum", rows=r, cols=nc, h=hh,
                          live=live)
        nbytes = wk.bytes
        b_ms, b_by, b32 = tc_bound(wk)
        out[label] = dict(R=r, N=nc, live_cols=live, max_abs_err=err,
                          max_abs_diff_3xtf32=err_emu, tol=tol, ms=ms,
                          plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                          bound_fp32_ms=b32, bytes=nbytes)
        print(f"[mesh] dense_message_rowsum at a rank's shape {label} "
              f"({live} live columns): max|d| vs plain f32 {err:.3e}, vs "
              f"3xTF32 emulation {err_emu:.3e} (tol {tol:.3e}); kernel "
              f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {b_ms:.5f} ms "
              f"({b_by}), fp32 bound {b32:.5f} ms on {card}")
    rows["dense_message_rowsum"]["sizes"]["mesh"] = out
    return out


def mesh_children(args):
    """``MESH_RANKS`` processes of this script with ``args``, one gloo
    world on a free local port, every rank on ``cuda:0``, started and not
    waited for (:func:`wait_children`)."""
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    root = os.path.dirname(os.path.abspath(__file__))
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), *args], cwd=root,
        env=dict(os.environ, PYTHONPATH=root, MASTER_ADDR="localhost",
                 MASTER_PORT=str(port), WORLD_SIZE=str(MESH_RANKS),
                 RANK=str(r), LOCAL_RANK="0"),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(MESH_RANKS)]
    return procs


def wait_children(procs, timeout):
    """(return codes, outputs) of ``procs``, every one killed past
    ``timeout`` seconds from now."""
    deadline = time.monotonic() + timeout
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(
                timeout=max(1.0, deadline - time.monotonic()))[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            outs.append(p.communicate()[0] + "\n[killed at the timeout]")
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()
    return [p.returncode for p in procs], outs


def gloo_probe_child():
    """One rank of the gloo probe: each collective of
    :data:`GLOO_PROBE_OPS` on CUDA tensors, its result checked, one
    ``GLOO_PROBE`` JSON line each (rank 0)."""
    import torch
    import torch.distributed as dist

    from epnn_tpu_torch.parallel import initialize_distributed

    initialize_distributed(backend="gloo", initialization_timeout=60)
    rank, world = dist.get_rank(), dist.get_world_size()
    dev = torch.device("cuda", 0)
    for op in GLOO_PROBE_OPS:
        t = torch.full((4,), float(rank + 1), device=dev)
        try:
            if op == "all_reduce_sum":
                dist.all_reduce(t)
                ok = torch.equal(t.cpu(), torch.full((4,), 3.0))
            elif op == "all_reduce_max":
                dist.all_reduce(t, op=dist.ReduceOp.MAX)
                ok = torch.equal(t.cpu(), torch.full((4,), 2.0))
            elif op == "broadcast":
                dist.broadcast(t, src=0)
                ok = torch.equal(t.cpu(), torch.full((4,), 1.0))
            elif op == "all_gather":
                outs = [torch.empty_like(t) for _ in range(world)]
                dist.all_gather(outs, t)
                ok = [float(o[0]) for o in outs] == [1.0, 2.0]
            elif op == "all_gather_into_tensor":
                o = torch.empty(4 * world, device=dev)
                dist.all_gather_into_tensor(o, t)
                ok = o.cpu().tolist() == [1.0] * 4 + [2.0] * 4
            elif op == "reduce_scatter":
                # rank r sends (r + 1)·(i + 1) to rank i: rank 0 gets 3
                parts = [t * float(i + 1) for i in range(world)]
                dist.reduce_scatter(t, parts)
                ok = torch.equal(t.cpu(), torch.full((4,), 3.0 * (rank + 1)))
            elif op == "reduce_scatter_tensor":
                o = torch.empty(4, device=dev)
                dist.reduce_scatter_tensor(
                    o, torch.cat([t * float(i + 1) for i in range(world)]))
                ok = torch.equal(o.cpu(), torch.full((4,), 3.0 * (rank + 1)))
            else:
                r = torch.empty_like(t)
                ops = [dist.P2POp(dist.isend, t, (rank + 1) % world),
                       dist.P2POp(dist.irecv, r, (rank - 1) % world)]
                for w in dist.batch_isend_irecv(ops):
                    w.wait()
                ok = float(r[0]) == float((rank - 1) % world + 1)
            res = dict(op=op, accepted=True, correct=bool(ok))
        except Exception as e:  # the probe's finding: what gloo refuses
            res = dict(op=op, accepted=False,
                       error=f"{type(e).__name__}: {str(e)[:200]}")
        if rank == 0:
            print("GLOO_PROBE " + json.dumps(res), flush=True)
        dist.barrier()
    dist.destroy_process_group()
    return 0


def mesh_pass_probe(torch, pred, batch, mesh, mode):
    """The pass round's pair terms across the two ranks on the card: graph
    0 of ``batch``, [pi | pj] of seeded h with round 1's pass weights, its
    top-k table, one slot per disjoint near pair
    (``testing.disjoint_pair_gh``); each rank launches
    ``near_pass_rowsum`` on its rows as the atom-sharded forward does, or
    (``'ring'``) its block against each block passing by, the staged ring
    exchange carrying [pi | pj].  Every rank's rows gathered: (rows,
    pairs), each cross-rank pair's two rows to be exact negations."""
    from epnn_tpu_torch.ops import kernels
    from epnn_tpu_torch.ops.fused import build_neighbors, rbf_and_gate
    from epnn_tpu_torch.parallel import _collectives as C
    from epnn_tpu_torch.testing import disjoint_pair_gh

    cfg, dev = pred.cfg, pred.device
    g = np.random.default_rng(0)
    n = batch.padded_atoms
    x, xyz, mask = (torch.from_numpy(np.ascontiguousarray(a[0])).to(dev)
                    for a in (batch.x, batch.xyz, batch.node_mask))
    h = torch.from_numpy(g.normal(size=(n, cfg.h_dim)).astype(np.float32)
                         ).to(dev) * mask[:, None]
    k = pred._neighbor_k(batch)
    idx, nbr_mask, d2 = build_neighbors(xyz, mask, cfg.cutoff, k,
                                        with_d2=True)
    gh_np, pairs = disjoint_pair_gh(idx.cpu().numpy(), nbr_mask.cpu().numpy())
    gh = torch.from_numpy(gh_np).to(dev)
    w = pred._fused.passes[0]
    a = torch.cat([x, h, torch.zeros_like(mask)[:, None]], dim=-1)
    rs = torch.cat([a @ w.w1_i + w.b1, a @ w.w1_j], dim=-1).contiguous()
    rbf, _ = rbf_and_gate(d2, nbr_mask, cfg)
    rbf = rbf.reshape(n * k, -1)
    group = mesh.get_group("atoms")
    d, me = C.size(group), C.index(group)
    r = n // d
    rows = slice(me * r, (me + 1) * r)
    mids = w.mids[0]
    if mode == "atom":
        out = kernels.near_pass_rowsum(
            rs[rows].contiguous(), rs[idx[rows].reshape(-1)].contiguous(),
            rbf[me * r * k:(me + 1) * r * k].contiguous(),
            gh[rows].contiguous(), w.w1_e, *mids, precision="highest")
    else:
        out = torch.zeros((r, rs.shape[1] // 2), device=dev)
        blk = (rs[rows].contiguous(),)
        for step in range(d):
            start = (me - step) % d * r
            local = (idx[rows] >= start) & (idx[rows] < start + r)
            out = out + kernels.near_pass_rowsum(
                rs[rows].contiguous(),
                blk[0][torch.where(local, idx[rows] - start, 0)
                       .reshape(-1)].contiguous(),
                rbf[me * r * k:(me + 1) * r * k].contiguous(),
                torch.where(local, gh[rows], 0.0).contiguous(), w.w1_e,
                *mids, precision="highest")
            blk = C.ppermute(blk, group)
    full = C.all_gather(out.contiguous(), group)
    cross = pairs[(pairs[:, 0] // r) != (pairs[:, 1] // r)]
    ct = torch.from_numpy(cross).to(dev)
    exact = bool(torch.equal(full[ct[:, 0]], -full[ct[:, 1]]))
    live = int(torch.count_nonzero(full[ct[:, 0]]))
    return dict(cross_rank_pairs=len(cross), exact_negations=exact,
                nonzero_entries=live)


def launch_error(kn, a, got):
    """One launch of kernel ``kn`` (output ``got``) against its plain
    version on its own arguments ``a``: (max|Δ|, bar).  A near kernel
    against the float32 plain version, within 1e-5·(S + 1), S the largest
    row's sum of the magnitudes of the two MLP evaluations it subtracts a
    slot (full and featureless, or the pair's two orderings): on a trained
    model's late rounds (pi, pj ~1e6 on water boxes) they dwarf their
    difference.  The far field sums N relu terms ≥ 0 (pi, pj ~1e6 there:
    sums ~1e14 at 17,760 columns) in float32, whose own error grows with
    N: so the kernel against the plain version in float64, within twice
    the float32 plain version's distance to it plus 1e-5·(max|ref| + 1),
    the bar of the far field's backward in [kernel]."""
    from epnn_tpu_torch.ops import kernels

    ref = getattr(kernels, kn + "_plain")(*a)
    if kn == "dense_message_rowsum":
        ref64 = kernels.dense_message_rowsum_plain(*(t.double() for t in a))
        plain64 = float((ref.double() - ref64).abs().max())
        return (float((got.double() - ref64).abs().max()),
                2.0 * plain64 + 1e-5 * (float(ref64.abs().max()) + 1.0))
    err = float((got - ref).abs().max())
    if kn == "near_message_corr":
        pi, pjn, rbf, wgt, w1e, w2, b2 = a
    else:
        rs, ppn, rbf, wgt, w1e, w2, b2 = a
        h = rs.shape[1] // 2
    n, k = wgt.shape
    worst = 0.0
    for s0 in range(0, n, 1024):
        rows = slice(s0, min(s0 + 1024, n))
        nr = rows.stop - rows.start
        e = (rbf[rows.start * k:rows.stop * k] @ w1e).reshape(nr, k, -1)
        if kn == "near_message_corr":
            base = pi[rows, None, :] + pjn[rows.start * k:rows.stop * k
                                           ].reshape(nr, k, -1)
            one, two = base + e, base
        else:
            pp = ppn[rows.start * k:rows.stop * k].reshape(nr, k, -1)
            one = (rs[rows, None, :h] + pp[..., h:]) + e
            two = (pp[..., :h] + rs[rows, None, h:]) + e
        mags = sum(kernels._mid_layers(z, ((w2, b2),), kernels._mm_fp32).abs()
                   for z in (one, two))
        worst = max(worst, float((wgt[rows, :, None].abs() * mags).sum(1)
                                 .max()))
    return err, 1e-5 * (worst + 1.0)


def mesh_child(work):
    """One rank of [mesh b]: two gloo ranks on ``cuda:0``, a (1, 2) mesh;
    ``Predictor(mesh=...)`` 'atom' and 'ring' exact and ring at
    ``far_cluster=MESH_C`` on :func:`mesh_boxes`, each call's charges
    against the one-card charges the parent saved (``work/refs.npz``)
    within 1e-5·(max|q| + 1), |Σq − Q| ≤ 1e-4, each kernel's launches and
    their shapes, every launch again against its plain version on its own
    inputs, the ring's distributed fits counted, the pass probe both ways
    (:func:`mesh_pass_probe`), and the medians (two ranks sharing one
    card).  Rank 0 writes ``work/result.json``."""
    import torch
    import torch.distributed as dist

    from epnn_tpu_torch.elements import table_for_n_elems
    from epnn_tpu_torch.infer import Predictor
    from epnn_tpu_torch.ops import kernels
    from epnn_tpu_torch.parallel import (_collectives, initialize_distributed,
                                         make_mesh, ring_shard)

    if not torch.cuda.is_available():
        return 2
    initialize_distributed(backend="gloo", initialization_timeout=120)
    mesh = make_mesh(1, MESH_RANKS)
    rank = dist.get_rank()
    group = mesh.get_group("atoms")
    staged = {op: _collectives.host_staged(op, group, torch.device("cuda"))
              for op in ("all_gather", "reduce_scatter", "ppermute",
                         "all_reduce")}
    base = Predictor.from_checkpoint(CKPT)
    boxes = mesh_boxes(table_for_n_elems(base.cfg.n_elems))
    with np.load(os.path.join(work, "refs.npz")) as f:
        refs = {k: f[k] for k in f.files}
    spied = ("dense_message_rowsum", "near_message_corr", "near_pass_rowsum")
    report = dict(staged=staged, cases={})
    fits = []
    real_fit = ring_shard.weighted_kmeans_sharded

    def fit_counted(*a, **kw):
        fits.append(tuple(a[0].shape))
        return real_fit(*a, **kw)

    ring_shard.weighted_kmeans_sharded = fit_counted

    def timed(fn, reps):
        ts = []
        for _ in range(reps):
            dist.barrier()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ts.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(ts))

    for mode, c in (("atom", 0), ("ring", 0), ("ring", MESH_C)):
        mp = Predictor(base.params, base.cfg, mesh=mesh, shard_mode=mode,
                       far_cluster=c)
        for label, batch, total_q in boxes:
            seen = {kn: [] for kn in spied}
            restores = [spy_calls(kernels, kn, seen[kn]) for kn in spied]
            fits.clear()
            try:
                kernels.reset_launch_counts()
                q = mp.predict_batch(batch)
                launched = dict(kernels.LAUNCHES)
            finally:
                for undo in restores:
                    undo()
            want = mesh_want(mode, c, MESH_RANKS, batch.batch_size)
            got = {kn: v for kn, v in launched.items() if v}
            require(got == want, ("[mesh b] launches", mode, c, label, got,
                                  want))
            n_fits = len(fits)
            require(n_fits == (4 * batch.batch_size if c else 0),
                    ("[mesh b] distributed fits", mode, c, label, fits))
            ref = refs[label]
            dq = float(np.abs(q - ref).max())
            tol = 1e-5 * (float(np.abs(ref).max()) + 1.0)
            cons = np.abs(q.astype(np.float64).sum(1) - total_q)
            require(np.all(np.isfinite(q)) and dq <= tol
                    and np.all(cons <= 1e-4),
                    ("[mesh b]", mode, c, label, dq, tol, cons))
            # every launch of the call again, on its own inputs, against
            # its plain version (3xTF32 is float32-grade: :func:`launch_error`)
            errs, shapes = {}, {}
            for kn, calls in seen.items():
                worst = 0.0
                for a, kw in calls:
                    err, bar = launch_error(kn, a,
                                            getattr(kernels, kn)(*a, **kw))
                    worst = max(worst, err / bar)
                    shapes.setdefault(kn, set()).add(
                        (tuple(a[0].shape[:1]) + tuple(a[1].shape[:1]))
                        if kn == "dense_message_rowsum"
                        else (a[0].shape[0], a[3].shape[1]))
                require(worst <= 1.0, ("[mesh b] launch vs plain", mode, c,
                                       label, kn, worst))
                errs[kn] = worst
            reps = 5 if label == "2x2220" else 2
            mp.predict_batch(batch)
            ms = timed(lambda: mp.predict_batch(batch), reps)
            report["cases"][f"{mode} C={c} {label}"] = dict(
                max_dq=dq, tol=tol, bit_for_bit=bool(np.array_equal(q, ref)),
                sum_q_err=cons.tolist(), launches=want,
                launch_shapes={kn: sorted(s) for kn, s in shapes.items()},
                launch_err_over_bar=errs, fits=n_fits,
                ms_two_ranks_one_card=ms)
            if rank == 0:
                print(f"[mesh b] rank 0 of two gloo ranks sharing one card, "
                      f"shard_mode={mode!r}, far_cluster={c}, {label}: vs "
                      f"the one-card call max|dq| {dq:.3e} (tol {tol:.3e}); "
                      f"|sum q - Q| {cons.tolist()}; launches a rank {want} "
                      f"at shapes {report['cases'][f'{mode} C={c} {label}']['launch_shapes']}; "
                      f"every launch vs its plain version at most "
                      f"{max(errs.values()):.3e} of the bar; distributed "
                      f"fits {n_fits}; median {ms:.3f} ms (two ranks "
                      f"sharing one card: no scaling figure)", flush=True)
    ring_shard.weighted_kmeans_sharded = real_fit
    probes = {mode: mesh_pass_probe(torch, base, boxes[0][1], mesh, mode)
              for mode in ("atom", "ring")}
    for mode, p in probes.items():
        require(p["exact_negations"] and p["cross_rank_pairs"] > 10
                and p["nonzero_entries"] > 0, ("[mesh b] probe", mode, p))
    report["pass_probe"] = probes
    if rank == 0:
        print(f"[mesh b] pass probe across the two ranks: {probes}; "
              f"staged through the host (gloo on CUDA): {staged}",
              flush=True)
    report["train"], report["train_launches"] = mesh_train_child(
        torch, base, mesh, boxes, refs)
    if rank == 0:
        with open(os.path.join(work, "result.json"), "w") as f:
            json.dump(report, f)
    dist.barrier()
    dist.destroy_process_group()
    return 0


def mesh_two_rank_phase(torch, card, boxes, refs):
    """[mesh b] Two gloo ranks on the one card (NCCL refuses two ranks on
    one GPU): the gloo probe's pair (which collectives gloo takes on CUDA
    tensors) and the [mesh b] pair (:func:`mesh_child`, then [mesh c] (b)
    in the same processes), started together.  Returns (report, each
    kernel's launches a call summed over the serving cases on rank 0,
    gloo probe)."""
    with tempfile.TemporaryDirectory() as work:
        np.savez(os.path.join(work, "refs.npz"), **refs)
        probe = mesh_children(["--gloo-probe"])
        kids = mesh_children(["--mesh-child", work])
        rc_p, out_p = wait_children(probe, 120)
        rc, outs = wait_children(kids, MESH_CHILD_TIMEOUT)
        for ln in outs[0].splitlines():
            if ln.startswith(("[mesh b]", "[mesh c]")):
                print(ln)
        require(all(r == 0 for r in rc), ("[mesh b] children", rc,
                                          [o[-4000:] for o in outs]))
        with open(os.path.join(work, "result.json")) as f:
            report = json.load(f)
    gloo = [json.loads(ln[len("GLOO_PROBE "):]) for ln in
            out_p[0].splitlines() if ln.startswith("GLOO_PROBE ")]
    answered = {g["op"] for g in gloo}
    gloo += [dict(op=op, accepted=False, error=f"no answer (probe exit "
                  f"codes {rc_p})") for op in GLOO_PROBE_OPS
             if op not in answered]
    # the mesh's rule (``_collectives.GLOO_CUDA_NATIVE``) must be what
    # gloo takes in this torch: each native collective accepted, correct
    from epnn_tpu_torch.parallel._collectives import GLOO_CUDA_NATIVE

    native = {"all_reduce": ("all_reduce_sum", "all_reduce_max"),
              "broadcast": ("broadcast",), "all_gather": ("all_gather",),
              "reduce_scatter": ("reduce_scatter",)}
    for op in GLOO_CUDA_NATIVE:
        for probe_op in native[op]:
            g = next(g for g in gloo if g["op"] == probe_op)
            require(g["accepted"] and g.get("correct"),
                    ("[mesh b] gloo on CUDA tensors", g))
    print(f"[mesh b] gloo on CUDA tensors, in the card's torch "
          f"{torch.__version__}: " + "; ".join(
              f"{g['op']} " + ("accepted, correct" if g.get("correct")
                               else "accepted, wrong result"
                               if g["accepted"] else f"refused ({g['error']})")
              for g in gloo))
    launches = {}
    for case in report["cases"].values():
        for kn, v in case["launches"].items():
            launches[kn] = launches.get(kn, 0) + v
    return report, launches, gloo


# ---------------------------------------------------------------------------
# [mesh c] training on the mesh, on the one card
# ---------------------------------------------------------------------------

def bwd_launch_error(torch, kernels, a, got):
    """One launch of ``dense_message_rowsum_bwd`` (its four outputs
    ``got``) against its plain version on its own arguments ``a``: each
    output within twice the float32 plain version's distance to the
    float64 plain version plus 1e-5·(max|ref| + 1) (:func:`far_backward`'s
    bar).  Returns the worst error over its bar."""
    ins = a[:6]
    refs32 = kernels.dense_message_rowsum_bwd_plain(*ins)
    refs64 = kernels.dense_message_rowsum_bwd_plain(*(t.double()
                                                      for t in ins))
    worst = 0.0
    for o, r32, r64 in zip(got, refs32, refs64):
        plain64 = float((r32.double() - r64).abs().max())
        tol = 2.0 * plain64 + 1e-5 * (float(r64.abs().max()) + 1.0)
        worst = max(worst, float((o.double() - r64).abs().max()) / tol)
    return worst


def grad_gap(torch, loss, grads, ref_loss, ref_grads):
    """(worst relative Frobenius of a gradient leaf, loss gap, bit for bit)
    of a step against its reference, held to [train a]'s bar: 1e-3 a
    leaf, the loss within 1e-5·(|loss| + 1)."""
    fro = max(float(torch.linalg.norm(g - r)
                    / max(float(torch.linalg.norm(r)), 1e-30))
              for g, r in zip(grads, ref_grads))
    dl = abs(loss - ref_loss)
    require(np.isfinite(fro) and fro <= 1e-3
            and dl <= 1e-5 * (abs(ref_loss) + 1.0), (fro, loss, ref_loss))
    same = loss == ref_loss and all(torch.equal(g, r)
                                    for g, r in zip(grads, ref_grads))
    return fro, dl, same


def mesh_train_batch(torch, pred, batch, seed):
    """A batch's train-step arguments on the card (labels seeded around
    zero on real atoms), its k and its round-1 collapse contract."""
    from epnn_tpu_torch.data import uniform_q0_contract

    g = np.random.default_rng(seed)
    y = (batch.node_mask * g.normal(0.0, 0.3, size=batch.node_mask.shape)
         ).astype(np.float32)
    arrays = (batch.x, batch.q0, batch.xyz, batch.node_mask, y,
              np.ones(batch.batch_size, np.float32))
    return ([torch.from_numpy(np.ascontiguousarray(a)).cuda()
             for a in arrays], pred._neighbor_k(batch),
            uniform_q0_contract(batch.x, batch.q0, batch.node_mask))


def mesh_step(torch, pred, step_fn):
    """One step of ``step_fn(state)`` from ``pred``'s weights on the card:
    (loss, gradients on the host, each kernel's launches, ms)."""
    from epnn_tpu_torch.models import tree_leaves
    from epnn_tpu_torch.ops import kernels
    from epnn_tpu_torch.train import TrainConfig, loop

    state = loop.create_state(pred.cfg, TrainConfig(), device="cuda",
                              params=pred.params)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    _, loss, _, _ = step_fn(state)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    return (float(loss), [p.grad.detach().cpu() for p in
                          tree_leaves(state.params)],
            dict(kernels.LAUNCHES), ms, state)


def mesh_train_one_rank(torch, card, pred, mesh):
    """[mesh c] (a) On the NCCL world of one (``mesh``, (1, 1)):
    ``make_sharded_train_step`` in atom mode, exact and at C = MESH_C
    (``far_cluster_grad``), and in ring mode, one step each on [train
    a]'s two 900-atom boxes, against ``train_step_fused`` on the card at
    [train a]'s bar (bit for bit printed where it holds), and the
    launches of a step (a world of one: the one-card step's); for
    ``mixed_b16`` and for a random-weight model that reads the far field
    (:func:`mesh_random_model`).  Returns ({case: report}, launches
    summed over the cases)."""
    from epnn_tpu_torch.data import pad_molecules
    from epnn_tpu_torch.elements import table_for_n_elems
    from epnn_tpu_torch.ops import kernels
    from epnn_tpu_torch.parallel import make_sharded_train_step
    from epnn_tpu_torch.testing import water_box
    from epnn_tpu_torch.train import loop

    batch = pad_molecules([water_box(TRAIN_BOX_MOLECULES, seed=30),
                           water_box(TRAIN_BOX_MOLECULES, seed=31,
                                     charge=-1.0)],
                          table_for_n_elems(pred.cfg.n_elems))
    out, total = {}, dict.fromkeys(kernels.SOURCES, 0)
    for model, mp in (("mixed_b16", pred), ("random", mesh_random_model())):
        cfg = mp.cfg
        args, k, uq0 = mesh_train_batch(torch, mp, batch, 5)
        refs = {c: mesh_step(torch, mp, lambda st, c=c: loop.train_step_fused(
            st, cfg, "masked_mse", None, 256, k, *args, uniform_q0=uq0,
            far_cluster=c, far_cluster_grad=True, remat=False))
            for c in (0, MESH_C)}
        want = mesh_train_want("atom", 0, 1, batch.batch_size, cfg.T)
        for mode, c in (("atom", 0), ("atom", MESH_C), ("ring", 0)):
            step = make_sharded_train_step(
                cfg, None, mesh, neighbor_k=k, shard_mode=mode,
                uniform_q0=uq0, far_cluster=c, far_cluster_grad=True,
                remat=False)
            loss, grads, launched, ms, _ = mesh_step(
                torch, mp, lambda st: step(st, *args))
            got = {kn: v for kn, v in launched.items() if v}
            require(got == want, ("[mesh c] one rank launches", model, mode,
                                  c, got, want))
            for kn, v in launched.items():
                total[kn] += v
            fro, dl, same = grad_gap(torch, loss, grads, *refs[c][:2])
            out[f"{model} {mode} C={c}"] = dict(
                loss=loss, ref_loss=refs[c][0], grad_rel_fro_max=fro,
                loss_gap=dl, bit_for_bit=same, launches=want, step_ms=ms,
                one_card_ms=refs[c][3])
            print(f"[mesh c] one NCCL rank, {model}, make_sharded_train_step "
                  f"shard_mode={mode!r}, far_cluster={c}, 2 x "
                  f"{batch.natoms[0]:,} atoms, k={k}: loss {loss:.6e} "
                  f"against train_step_fused {refs[c][0]:.6e}"
                  f"{'; loss and gradients bit for bit' if same else ''}; "
                  f"gradients worst relative Frobenius {fro:.3e} (bar "
                  f"1e-3); launches {want}; step {ms:.3f} ms (one-card "
                  f"step {refs[c][3]:.3f} ms, host clock, first call) on "
                  f"{card}")
    return out, total


def mesh_train_shape_rows(torch, card, far_args, gbar, near_sets, rows):
    """[mesh c] the kernels training on two ranks launches, at a rank's
    shapes: ``dense_message_rowsum_bwd`` at R = 1,112 rows against the
    2,224 columns (atom), the ring's 1,112 × 1,112 block and 1,112 × MESH_C
    centroids, each held to the float64 plain version
    (:func:`far_backward`), timed beside its plain version and its bound
    on this data; the two near kernels on a rank's rows (1,112 and 8,880
    of the two boxes' tables, ``near_sets``: {label: {kernel: args}}),
    each launch against its plain version (:func:`launch_error`), timed
    beside its bound (:func:`near_bound`).  Added to ``rows[...]["sizes"]
    ["mesh_train"]``."""
    from epnn_tpu_torch.ops import kernels
    from epnn_tpu_torch.ops.cluster import weighted_kmeans

    pi, pj, cv, w2, b2 = far_args
    n = pi.shape[0]
    r = n // 2
    cent, wts, _ = weighted_kmeans(pj, cv, MESH_C)
    g_rows = gbar[:r].contiguous()
    cases = {
        f"atom {r}x{n}": (pi[:r].contiguous(), pj, cv, w2, b2, g_rows),
        f"ring {r}x{r}": (pi[:r].contiguous(), pj[r:].contiguous(),
                          cv[r:].contiguous(), w2, b2, g_rows),
        f"cluster {r}x{MESH_C}": (pi[:r].contiguous(), cent.contiguous(),
                                  wts, w2, b2, g_rows),
    }
    bwd = at(kernels.dense_message_rowsum_bwd, "highest")
    out = {}
    for label, args in cases.items():
        errs = far_backward(torch, kernels, args, ties=True)
        rr, hh = args[0].shape
        nc = args[1].shape[0]
        live = int(torch.count_nonzero(args[2]))
        ms = device_ms(torch, lambda: bwd(*args), MESH_TRAIN_ITERS[0])
        plain_ms = device_ms(
            torch, lambda: kernels.dense_message_rowsum_bwd_plain(*args),
            MESH_TRAIN_ITERS[1])
        wk = kernels.work("dense_message_rowsum_bwd", rows=rr, cols=nc,
                          h=hh, live=live)
        nbytes = wk.bytes
        b_ms, b_by, b32 = tc_bound(wk)
        out[label] = dict(R=rr, N=nc, live_cols=live,
                          max_abs_err=max(e[0] for e in errs.values()),
                          max_abs_diff_f64={p: e[1] for p, e in
                                            errs.items()},
                          tol_f64={p: e[4] for p, e in errs.items()},
                          ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                          bound_by=b_by, bound_fp32_ms=b32, bytes=nbytes)
        print(f"[mesh c] dense_message_rowsum_bwd at a rank's shape {label} "
              f"({live} live columns): {bwd_errs_text(errs)}; kernel "
              f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {b_ms:.5f} ms "
              f"({b_by}), fp32 bound {b32:.5f} ms on {card}")
    rows["dense_message_rowsum_bwd"]["sizes"]["mesh_train"] = out
    near = {}
    for label, sets in near_sets.items():
        for name, a in sets.items():
            rr = a[0].shape[0] // 2
            kk = a[3].shape[1]
            args = (a[0][:rr].contiguous(), a[1][:rr * kk].contiguous(),
                    a[2][:rr * kk].contiguous(), a[3][:rr].contiguous(),
                    *a[4:])
            fn = at(getattr(kernels, name), "highest")
            err, bar = launch_error(name, args, fn(*args))
            require(err <= bar, ("[mesh c] near kernel at a rank's rows",
                                 name, label, err, bar))
            ms = device_ms(torch, lambda: fn(*args), MESH_TRAIN_ITERS[0])
            plain_ms = device_ms(
                torch, lambda: getattr(kernels, name + "_plain")(*args),
                MESH_TRAIN_ITERS[1])
            n_live, wk, (b_ms, b_by, b32) = near_bound(name, args)
            entry = dict(R=rr, K=kk, live_slots=n_live, max_abs_err=err,
                         bar=bar, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                         bound_by=b_by, bound_fp32_ms=b32, bytes=wk.bytes)
            rows[name]["sizes"].setdefault("mesh_train", {})[
                f"{rr} rows"] = entry
            near[f"{name} {rr} rows"] = entry
            print(f"[mesh c] {name} on a rank's {rr:,} rows, K = {kk} "
                  f"({n_live:,} live slots): max|d| vs plain {err:.3e} (bar "
                  f"{bar:.3e}); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                  f"bound {b_ms:.5f} ms ({b_by}), fp32 bound {b32:.5f} ms "
                  f"on {card}")
    return dict(far_bwd=out, near=near)


def mesh_train_molecules(base, boxes, refs):
    """[train b]'s molecules for the two ranks: the golden boxes and the
    small waters, labelled by the checkpoint's own charges (the one-card
    charges of ``refs`` for the boxes) plus seeded noise that keeps each
    net charge (another seed than [train b]'s).  Returns (all, small)."""
    from epnn_tpu_torch.testing import golden_boxes, water_box

    g = np.random.default_rng(16)
    big = golden_boxes()
    q2 = refs[boxes[0][0]]
    for m, q in zip(big, q2):
        m.labels = noisy_labels(g, q[:m.natoms])
    small = [water_box(m, seed=20 + m, charge=c)
             for m, c in ((1, 0.0), (3, -1.0), (8, 1.0), (20, 0.0))]
    for m, q in zip(small, base.predict_molecules(small)):
        m.labels = noisy_labels(g, q)
    return big + small, small


def mesh_train_case(torch, mp, model, mesh, group, label, batch, args, k,
                    uq0, ref, mode, c, real_fit):
    """One [mesh c] (b) case on the two ranks: a ``make_sharded_train_step``
    step of model ``mp`` (``mode``, ``c``) against the one-card step
    ``ref`` (at C > 0 the one-card step on the ring's partitions), its
    far-field backward launches against their plain version, its
    launches, every rank's parameters the same bits.  Returns the case's
    report."""
    import torch.distributed as dist

    from epnn_tpu_torch.ops import fused, kernels
    from epnn_tpu_torch.parallel import (_collectives as C,
                                         make_sharded_train_step, ring_shard,
                                         shard_state)
    from epnn_tpu_torch.train import loop

    cfg = mp.cfg
    step = make_sharded_train_step(
        cfg, None, mesh, neighbor_k=k, shard_mode=mode, uniform_q0=uq0,
        far_cluster=c, far_cluster_grad=True, remat=False)
    fits, seen = [], []

    def fit_spy(rows, w, c_, axis, iters=8, differentiable=False):
        fits.append((rows.detach().clone(), w.detach().clone(), c_, iters))
        return real_fit(rows, w, c_, axis, iters=iters,
                        differentiable=differentiable)

    ring_shard.weighted_kmeans_sharded = fit_spy
    undo = spy_calls(kernels, "dense_message_rowsum_bwd", seen)
    n_data, n_atoms = mesh.mesh.shape
    try:
        dist.barrier()
        loss, grads, launched, ms, state = mesh_step(
            torch, mp, lambda st: step(st, *args))
    finally:
        undo()
        ring_shard.weighted_kmeans_sharded = real_fit
    shard_state(state.params, mesh)
    want = mesh_train_want(mode, c, n_atoms, batch.batch_size // n_data,
                           cfg.T)
    got = {kn: v for kn, v in launched.items() if v}
    require(got == want, ("[mesh c] launches", model, mode, c, got, want))
    errs = [bwd_launch_error(torch, kernels, a,
                             kernels.dense_message_rowsum_bwd(*a))
            for a, _ in seen]
    worst = max(errs)
    require(worst <= 1.0, ("[mesh c] far-field backward vs plain", model,
                           mode, c, worst))
    live = sum(bool(torch.count_nonzero(a[5])) for a, _ in seen)
    shapes = sorted({(a[0].shape[0], a[1].shape[0]) for a, _ in seen})
    one = ref
    if c:
        # the one-card step on the ring's partitions: each fit's Lloyd
        # centroids and its rows' assignment, gathered in rank order
        parts = []
        for rows_, w_, c_, iters in fits:
            cent, _, _ = real_fit(rows_, w_, c_, group, iters=iters)
            score = ((cent * cent).sum(1)[None, :]
                     - 2.0 * (rows_.float() @ cent.T))
            parts.append((C.all_gather(w_.float(), group).cpu(), cent.cpu(),
                          C.all_gather(score.argmin(1), group).cpu()))
        real = fused.weighted_kmeans
        fused.weighted_kmeans = replay_fits(torch, parts)
        try:
            one = mesh_step(torch, mp, lambda st: loop.train_step_fused(
                st, cfg, "masked_mse", None, 256, k, *args, uniform_q0=uq0,
                far_cluster=c, far_cluster_grad=True, remat=False))
        finally:
            fused.weighted_kmeans = real
    fro, dl, same = grad_gap(torch, loss, grads, *one[:2])
    if dist.get_rank() == 0:
        print(f"[mesh c] rank 0 of {dist.get_world_size()} "
              f"{dist.get_backend()} ranks, mesh (data, atoms) = "
              f"{(n_data, n_atoms)}, {model}, "
              f"make_sharded_train_step shard_mode={mode!r}, far_cluster={c}"
              f", {label}: loss {loss:.6e} against the one-card step "
              f"{one[0]:.6e}; gradients worst relative Frobenius {fro:.3e} "
              f"(bar 1e-3); launches a rank {want}; far-field backward at "
              f"{shapes}, {live} of {len(seen)} launches with a nonzero "
              f"cotangent, every launch vs its plain version at most "
              f"{worst:.3e} of the bar; distributed fits {len(fits)}; every "
              f"rank's parameters the same bits; step {ms:.3f} ms (first "
              f"call)", flush=True)
    return dict(loss=loss, ref_loss=one[0], grad_rel_fro_max=fro,
                loss_gap=dl, bit_for_bit=same, launches=want,
                bwd_shapes=shapes, bwd_live_cotangents=live,
                bwd_err_over_bar=worst, fits=len(fits), step_ms=ms)


def mesh_train_child(torch, base, mesh, boxes, refs, mesh_2d=None):
    """[mesh c] (b) On the two gloo ranks of :func:`mesh_child` (``mesh``
    (1, 2)), one step each of ``make_sharded_train_step`` in atom mode,
    ring mode and ring at C = MESH_C (the distributed fit's gradient) on
    the two 2,220-atom boxes, for ``mixed_b16`` and for the random-weight
    model that reads the far field (:func:`mesh_train_case`): against the
    one-card ``train_step_fused`` (each rank computes it; at C > 0 it
    replays the ring's partitions, :func:`replay_fits`, as the fits tie
    within float32 noise) at [train a]'s bar; every far-field backward
    launch of the step against its plain version
    (:func:`bwd_launch_error`), its shapes, the launches a rank, every
    rank's parameters the same bits (``shard_state``); then the
    data-parallel step on a (D, 1) mesh (or ``mesh_2d``) against the
    one-card step, loss at rtol 1e-5; then ``train(mesh=...)`` for
    MESH_TRAIN_EPOCHS epochs on [train b]'s molecules
    (:func:`mesh_train_molecules`), its big bucket through the sharded
    step, whose loss falls.  ``mesh_2d``: a (2, D/2) mesh whose atom step
    also runs (each ``data`` coordinate one box), and the data-parallel
    step's layout.  Returns (report, rank's launches in the ``train()``
    run)."""
    import torch.distributed as dist

    from epnn_tpu_torch.ops import kernels
    from epnn_tpu_torch.parallel import (atom_shard, make_mesh, ring_shard,
                                         shard_state)
    from epnn_tpu_torch.train import TrainConfig, loop, train

    rank = dist.get_rank()
    group = mesh.get_group("atoms")
    label, batch, _ = boxes[0]
    report = dict(cases={})
    real_fit = ring_shard.weighted_kmeans_sharded
    for model, mp in (("random", mesh_random_model()), ("mixed_b16", base)):
        cfg = mp.cfg
        args, k, uq0 = mesh_train_batch(torch, mp, batch, 6)
        ref = mesh_step(torch, mp, lambda st: loop.train_step_fused(
            st, cfg, "masked_mse", None, 256, k, *args, uniform_q0=uq0,
            remat=False))
        for mode, c in (("atom", 0), ("ring", 0), ("ring", MESH_C)):
            report["cases"][f"{model} {mode} C={c}"] = mesh_train_case(
                torch, mp, model, mesh, group, label, batch, args, k, uq0,
                ref, mode, c, real_fit)
        if mesh_2d is not None:
            report["cases"][f"{model} atom C=0 mesh_2d"] = mesh_train_case(
                torch, mp, model, mesh_2d, mesh_2d.get_group("atoms"), label,
                batch, args, k, uq0, ref, "atom", 0, real_fit)
    # the data-parallel step (mixed_b16, the last model above): one box a
    # data coordinate
    mesh_dp = mesh_2d or make_mesh(dist.get_world_size(), 1)
    loss, grads, launched, ms, state = mesh_step(
        torch, base, lambda st: loop.data_parallel_train_step(
            st, cfg, "masked_mse", None, mesh_dp, *args, neighbor_k=k,
            block=256, uniform_q0=uq0, remat=False))
    shard_state(state.params, mesh_dp)
    require(abs(loss - ref[0]) <= 1e-5 * abs(ref[0]), ("[mesh c] data "
                                                        "parallel", loss,
                                                        ref[0]))
    per_graph = {kn: v for kn, v in PER_GRAPH_TRAIN.items() if v}
    require({kn: v for kn, v in launched.items() if v} == per_graph,
            ("[mesh c] data-parallel launches", launched))
    fro, dl, _ = grad_gap(torch, loss, grads, *ref[:2])
    report["data_parallel"] = dict(loss=loss, ref_loss=ref[0],
                                   grad_rel_fro_max=fro, launches=per_graph,
                                   step_ms=ms)
    if rank == 0:
        print(f"[mesh c] data-parallel step on a "
              f"{tuple(mesh_dp.mesh.shape)} mesh, one 2,220-atom box a data "
              f"coordinate: loss {loss:.6e} against the one-card step "
              f"{ref[0]:.6e} (rtol 1e-5); gradients worst relative Frobenius "
              f"{fro:.3e}; launches a rank {per_graph}; every rank's "
              f"parameters the same bits", flush=True)
    # train(mesh=...): the big bucket through the sharded step
    mols, small = mesh_train_molecules(base, boxes, refs)
    steps = []
    orig = atom_shard.make_sharded_train_step

    def spy(*a, **kw):
        inner = orig(*a, **kw)

        def wrapped(*sa, **skw):
            res = inner(*sa, **skw)
            steps.append(float(res[1]))
            return res
        return wrapped

    atom_shard.make_sharded_train_step = spy
    try:
        kernels.reset_launch_counts()
        res = train(mols, cfg, TrainConfig(epochs=MESH_TRAIN_EPOCHS,
                                           init_from=CKPT),
                    val_mols=small, mesh=mesh, progress=False)
        torch.cuda.synchronize()
        run_launches = dict(kernels.LAUNCHES)
    finally:
        atom_shard.make_sharded_train_step = orig
    shard_state(res.state.params, mesh)
    require(len(steps) == MESH_TRAIN_EPOCHS and np.all(np.isfinite(steps))
            and steps[-1] < steps[0]
            and np.isfinite(res.best_val_masked_mae), ("[mesh c] train()",
                                                       steps, res.history))
    report["train"] = dict(sharded_step_losses=steps,
                           history=res.history, launches=run_launches)
    if rank == 0:
        print(f"[mesh c] train(mesh={tuple(mesh.mesh.shape)}) "
              f"{MESH_TRAIN_EPOCHS} epochs from "
              f"{CKPT} on the golden boxes + {len(small)} small molecules: "
              f"sharded-step loss {' -> '.join(f'{v:.6e}' for v in steps)}; "
              f"epoch rows {[round(r['train_loss'], 8) for r in res.history]}"
              f"; launches on rank 0 {run_launches}; every rank's parameters "
              f"the same bits", flush=True)
    return report, run_launches


def mesh_train_cards():
    """[mesh c] (b) on the world torchrun started, a card a rank over NCCL
    (``torchrun --nproc-per-node N chip_smoke.py --mesh-train-cards``, N
    even): :func:`mesh_train_child` on a (1, N) mesh, with the (2, N/2)
    mesh's atom step and data-parallel step.  Rank 0 prints the report as
    a JSON line and the card line.  Not part of the one-card run."""
    import torch
    import torch.distributed as dist

    from epnn_tpu_torch.elements import table_for_n_elems
    from epnn_tpu_torch.infer import Predictor
    from epnn_tpu_torch.ops import kernels
    from epnn_tpu_torch.parallel import initialize_distributed, make_mesh

    initialize_distributed()
    world = dist.get_world_size()
    require(dist.get_backend() == "nccl" and world >= 2 and world % 2 == 0,
            ("[mesh c] cards", dist.get_backend(), world))
    if dist.get_rank() == 0:
        kernels.build(widths=[SHIPPED_WIDTHS])
    dist.barrier()
    mesh = make_mesh(1, world)
    mesh_2d = make_mesh(2, world // 2) if world >= 4 else None
    base = Predictor.from_checkpoint(CKPT)
    boxes = mesh_boxes(table_for_n_elems(base.cfg.n_elems))[:1]
    refs = {boxes[0][0]: base.predict_batch(boxes[0][1])}
    report, launches = mesh_train_child(torch, base, mesh, boxes, refs,
                                        mesh_2d)
    if dist.get_rank() == 0:
        print(json.dumps({"mesh_train_cards": report, "world": world,
                          "train_launches_rank0": launches}))
        print(card_line())
    dist.barrier()
    dist.destroy_process_group()
    return 0


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["--gloo-probe"]:
        return gloo_probe_child()
    if sys.argv[1:2] == ["--mesh-train-cards"]:
        return mesh_train_cards()
    if sys.argv[1:2] == ["--mesh-child"]:
        return mesh_child(sys.argv[2])
    if sys.argv[1:2] == ["--cpu-flops"]:
        return cpu_flops_child(sys.argv[2])
    from epnn_tpu_torch.data import pad_molecules
    from epnn_tpu_torch.elements import table_for_n_elems
    from epnn_tpu_torch.infer import Predictor
    from epnn_tpu_torch.ops import fused, kernels
    from epnn_tpu_torch.ops.fused import (
        build_neighbors,
        forward_blocked,
        rbf_and_gate,
    )
    from epnn_tpu_torch.testing import (
        SCALING_SIZE_MOLECULES,
        golden_boxes,
        water_box,
    )
    from epnn_tpu_torch.tools.near_field_pace import near_inputs

    count_selection()

    # ---- 1. device --------------------------------------------------------
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"[device] {card} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | {torch.cuda.get_device_name(0)} x "
          f"{torch.cuda.device_count()}")
    print(f"[device] matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}"
          f" cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")

    # ---- 2. build ---------------------------------------------------------
    # the 3xTF32 libraries at every width and the one-pass tier's
    # ([slice k]) at the shipped and the timed width, all nvcc at once
    widths = (SHIPPED_WIDTHS, *WIDTH_CASES)
    tier_widths = (SHIPPED_WIDTHS, TIMED_WIDTH)
    with ThreadPoolExecutor(2) as pool:
        jobs = [pool.submit(kernels.build, widths=widths),
                pool.submit(kernels.build, kernels.TIERED, tier_widths,
                            ("default",))]
        secs = [job.result() for job in jobs]
    print(f"[build] {len(kernels.SOURCES)} kernels at widths {widths} and "
          f"the {len(kernels.TIERED)} tensor-core kernels' one-pass tier at "
          f"{tier_widths} in {max(secs):.1f} s ({kernels.BUILD_DIR})")
    for name, kinds in kernels._WIDTHS_OF.items():
        for hw, ew in widths if kinds else widths[:1]:
            tag = {"he": f"{hw}x{ew}", "h": f"H={hw}"}.get(kinds, "")
            for tier in (("highest", "default")
                         if name in kernels.TIERED
                         and (hw, ew) in tier_widths else ("highest",)):
                for ln in kernels.build_log(name, hw, ew,
                                            tier).splitlines():
                    if "registers" in ln or "spill" in ln:
                        print(f"[build] {name} {tag} "
                              f"{TIER_TEXT[tier]}: {ln.strip()}")
    # the CPU side of [profile]'s flop count runs beside the card's phases
    flops_dir = tempfile.mkdtemp(prefix="chip_smoke_flops")
    flops_out = os.path.join(flops_dir, "cpu_flops.json")
    root = os.path.dirname(os.path.abspath(__file__))
    flops_child = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--cpu-flops",
         flops_out], cwd=root,
        env=dict(os.environ, PYTHONPATH=root,
                 OMP_NUM_THREADS=str(CPU_FLOPS_THREADS)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    atexit.register(lambda: flops_child.poll() is None and flops_child.kill())

    # ---- 3. kernels against their plain versions --------------------------
    dev = torch.device("cuda")
    pred = Predictor.from_checkpoint(CKPT)
    cfg = pred.cfg
    table = table_for_n_elems(cfg.n_elems)
    batch2 = pad_molecules(golden_boxes(), table)
    n = batch2.padded_atoms
    k = pred._neighbor_k(batch2)
    g = np.random.default_rng(0)
    x = torch.from_numpy(batch2.x[0]).to(dev)
    xyz = torch.from_numpy(batch2.xyz[0]).to(dev)
    mask = torch.from_numpy(batch2.node_mask[0]).to(dev)
    q0 = torch.from_numpy(batch2.q0[0]).to(dev)
    h = torch.from_numpy(g.normal(size=(n, cfg.h_dim)).astype(np.float32)
                         ).to(dev) * mask[:, None]
    _, nbr_mask, d2 = build_neighbors(xyz, mask, cfg.cutoff, k, with_d2=True)
    _, gate = rbf_and_gate(d2, nbr_mask, cfg)
    a = torch.cat([x, h, q0[:, None]], dim=-1)
    wm, wp = pred._fused.messages[1], pred._fused.passes[0]
    pi = (a @ wm.w1_i + wm.b1).contiguous()
    pj = (a @ wm.w1_j).contiguous()
    hh = cfg.mlp_hidden[0]
    n_valid = int(mask.sum())

    # the far field: round-2 inputs at the box's shapes, then its backward
    # (a seeded cotangent), then both on a ragged rectangular slice of the
    # same inputs with zeros in cv; the SM clock around the timings
    clocks = []
    far_args = (pi, pj, mask.contiguous(), *wm.mids[0])
    gbar = torch.from_numpy(g.normal(size=(n, hh)).astype(np.float32)).to(dev)
    rows = {name: dict(name=name, route="cuda", source=KERNEL_ROWS[name][1],
                       replaces=KERNEL_ROWS[name][0], launches=0,
                       library_ms=None, ptxas=ptxas_usage(kernels, name),
                       **entry, sizes={})
            for name, entry in far_phase(torch, card, far_args, gbar, "2220",
                                         clocks, (50, 5, 20, 3)).items()}
    cv_r = mask[:RAGGED[1]].clone()
    cv_r[torch.from_numpy(g.uniform(size=RAGGED[1]) < 0.3).to(dev)] = 0.0
    rag_args = (pi[:RAGGED[0]].contiguous(), pj[:RAGGED[1]].contiguous(),
                cv_r, *wm.mids[0])
    err, err_emu, tol = far_forward(torch, kernels, rag_args)
    rag_errs = far_backward(torch, kernels,
                            (*rag_args, gbar[:RAGGED[0]].contiguous()))
    rows["dense_message_rowsum"]["ragged"] = dict(
        R=RAGGED[0], N=RAGGED[1], live_cols=int(cv_r.sum()),
        max_abs_diff=err, max_abs_diff_3xtf32=err_emu, tol=tol)
    rows["dense_message_rowsum_bwd"]["ragged"] = dict(
        R=RAGGED[0], N=RAGGED[1], errs=rag_errs)
    print(f"[kernel] far field, ragged R={RAGGED[0]} N={RAGGED[1]} "
          f"({int(cv_r.sum())} live columns): forward max|d| vs plain f32 "
          f"{err:.3e}, vs 3xTF32 emulation {err_emu:.3e} (tol {tol:.3e}); "
          f"backward {bwd_errs_text(rag_errs)}; same bits on a second launch "
          "and off the 16-byte boundary")
    # the far field's int8 tier on the same inputs, then the ragged slice
    name = "dense_message_rowsum_int8"
    rows[name] = dict(name=name, route="cuda", source=KERNEL_ROWS[name][1],
                      replaces=KERNEL_ROWS[name][0], launches=0,
                      library_ms=None, ptxas=ptxas_usage(kernels, name),
                      **int8_phase(torch, card, far_args, "2220",
                                   (50, 5, 50)), sizes={})
    rows[name]["ragged"] = int8_phase(torch, card, rag_args, "ragged")

    # the near kernels at both sizes, on each box's own neighbor table
    big = pad_molecules([water_box(SCALING_SIZE_MOLECULES, seed=2)], table)
    for label, batch, reps in (("2220", batch2, (50, 5)),
                               ("17760", big, (50, 3))):
        cases, nbr_table = near_inputs(pred, batch, np.random.default_rng(0))
        for name, entry in near_phase(
                torch, card, label, cases, nbr_table, reps,
                min_pairs=int(batch.node_mask[0].sum()) // 4).items():
            if label == "2220":
                rows[name] = dict(
                    name=name, route="cuda", source=KERNEL_ROWS[name][1],
                    replaces=KERNEL_ROWS[name][0], launches=0,
                    library_ms=None, ptxas=ptxas_usage(kernels, name),
                    **entry, sizes={})
            else:
                rows[name]["sizes"][label] = entry

    # the fused dense kernels, then the kernel-built neighbor list
    clock = max_sm_clock_hz()
    sfu_rate = SFU_PER_CLOCK_SM * SMS * clock
    print(f"[kernel] SM clock (nvidia-smi clocks.max.sm) {clock / 1e6:.0f} "
          f"MHz: {sfu_rate:.4e} special-function ops/s")
    counts = dict(valid=n_valid, near=int(torch.count_nonzero(nbr_mask)),
                  gated=int(torch.count_nonzero(gate * nbr_mask)))
    xyz_b = torch.from_numpy(big.xyz[0]).to(dev)
    mask_b = torch.from_numpy(big.node_mask[0]).to(dev)
    a_b = torch.cat([torch.from_numpy(big.x[0]).to(dev),
                     torch.from_numpy(g.normal(size=(big.padded_atoms,
                                                     cfg.h_dim)).astype(
                         np.float32)).to(dev) * mask_b[:, None],
                     torch.from_numpy(big.q0[0]).to(dev)[:, None]], dim=-1)
    _, nbr_mask_b, d2_b = build_neighbors(xyz_b, mask_b, cfg.cutoff,
                                          pred._neighbor_k(big), with_d2=True)
    _, gate_b = rbf_and_gate(d2_b, nbr_mask_b, cfg)
    counts_b = dict(valid=int(mask_b.sum()),
                    near=int(torch.count_nonzero(nbr_mask_b)),
                    gated=int(torch.count_nonzero(gate_b * nbr_mask_b)))
    fused_boxes = [("2220", a, xyz, mask, counts),
                   ("17760", a_b, xyz_b, mask_b, counts_b)]
    rows.update(fused_kernel_phase(torch, card, cfg, fused_boxes, wm, wp,
                                   sfu_rate))
    for name, entry in doubling_phase(torch, card, cfg, fused_boxes, wm, wp,
                                      sfu_rate).items():
        rows[name].update(entry)
    # neighbor_compact on each box as it comes (lattice order) and on a
    # seeded shuffle of it, the cull's best and worst case
    compact_boxes = []
    for label, xb, mb, kb in (
            ("2220", xyz, mask, k),
            ("17760", torch.from_numpy(big.xyz[0]).to(dev),
             torch.from_numpy(big.node_mask[0]).to(dev),
             pred._neighbor_k(big))):
        perm = torch.from_numpy(
            np.random.default_rng(7).permutation(xb.shape[0])).to(dev)
        compact_boxes += [(label, xb, mb, kb),
                          (label + " shuffled", xb[perm].contiguous(),
                           mb[perm].contiguous(), kb)]
    rows["neighbor_compact"], selection = compact_phase(torch, card, cfg,
                                                        compact_boxes)
    # the width-carrying kernels at the other widths
    width_results = width_phase(torch, card, sfu_rate)

    # ---- 4. the slice through Predictor ----------------------------------
    def timed(fn, reps):
        ts = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ts.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(ts))

    # (a) small molecules: the dense path launches no kernel
    small = [water_box(m, seed=20 + m, charge=c)
             for m, c in ((1, 0.0), (3, -1.0), (8, 1.0), (20, 0.0))]
    kernels.reset_launch_counts()
    qs = pred.predict_molecules(small)
    launched = dict(kernels.LAUNCHES)
    require(sum(launched.values()) == 0, launched)
    qs_cpu = Predictor(pred.params, cfg, device="cpu").predict_molecules(small)
    for q, qc, m in zip(qs, qs_cpu, small):
        require(np.all(np.isfinite(q)) and q.shape == (m.natoms,), m.name)
        cons = abs(float(q.astype(np.float64).sum()) - m.total_charge)
        require(cons <= 1e-4, (m.name, cons))
        dq = float(np.abs(q - qc).max())
        require(dq < 1e-5 * (np.abs(qc).max() + 1.0), (m.name, dq))
    print(f"[slice a] dense path, {len(small)} molecules of "
          f"{[m.natoms for m in small]} atoms: launches {launched}; "
          "card vs CPU within 1e-5*(max|q|+1), |sum q - Q| <= 1e-4")

    # (b) the 2,220-atom boxes, B = 2, against the JAX golden; selection by
    # the cell builder, one build a graph (k cached), never top-k
    kernels.reset_launch_counts()
    reset_selection()
    q2 = pred.predict_batch(batch2)
    main_launches = dict(kernels.LAUNCHES)
    sel_b = dict(SELECTION)
    want = {kn: 2 * PER_GRAPH.get(kn, 0) for kn in kernels.SOURCES}
    require(main_launches == want, (main_launches, want))
    require(sel_b["cell"] == 2 and sel_b["topk"] == 0, ("[slice b]", sel_b))
    with np.load(GOLDEN) as gf:
        golden, total_q = gf["charges"], gf["total_q"]
    q2v = q2[:, :golden.shape[1]]
    dq = float(np.abs(q2v - golden).max())
    tol_q = 1e-5 * (float(np.abs(golden).max()) + 1.0)
    cons2 = np.abs(q2.astype(np.float64).sum(1) - total_q)
    require(np.all(np.isfinite(q2)) and dq < tol_q, (dq, tol_q))
    require(np.all(cons2 <= 1e-4), cons2)
    # a padded width that is no multiple of 4 starts graph 1's node mask
    # off the 16-byte boundary: the card takes it as the CPU does
    q_odd = pred.predict_molecules(golden_boxes(), pad_to=n + 1)
    dq_odd = max(float(np.abs(qo - qb[:len(qo)]).max())
                 for qo, qb in zip(q_odd, q2))
    require(dq_odd < tol_q, ("pad_to", n + 1, dq_odd))
    ms2 = timed(lambda: pred.predict_batch(batch2), 7)
    # the selection's end-to-end effect: 'auto' (cell builder) and 'topk'
    # in turns (topk, auto, auto, topk), each a median of 7 calls, warm (one
    # batch object) and cold (predict_molecules: a new batch a call)
    pred_topk = Predictor(pred.params, cfg, neighbor_method="topk",
                          spatial_sort="off")
    preds_b = {"topk": pred_topk, "auto": pred}
    golden_mols = golden_boxes()
    turns_b = turns(timed, preds_b, lambda p: p.predict_batch(batch2), 7)
    cold_b = turns(timed, preds_b,
                   lambda p: p.predict_molecules(golden_mols), 7)
    parts_b = {name: cold_parts(torch, p, golden_mols)
               for name, p in preds_b.items()}
    print(f"[slice b] 2 x 2,220 atoms (Q=0,+1), k={k}: launches "
          f"{main_launches} (per graph {PER_GRAPH}); neighbor selection "
          f"calls {sel_b}, grid {pred._neighbor_grid(batch2)}; "
          f"max|dq| vs JAX golden "
          f"{dq:.3e} (tol {tol_q:.3e}); |sum q - Q| = {cons2.tolist()}; "
          f"padded to {n + 1}: max|dq| {dq_odd:.3e}; "
          f"predict_batch median {ms2:.3f} ms; in turns warm auto "
          f"{turns_b['auto']} ms, topk {turns_b['topk']} ms; cold "
          f"(predict_molecules) auto {cold_b['auto']} ms, topk "
          f"{cold_b['topk']} ms; cold set-up (ms) {parts_b} on {card}")

    # (c) the 17,760-atom box, B = 1: cell-sorted (spatial_sort 'auto'),
    # selection by the cell builder, held to an unsorted top-k Predictor
    kernels.reset_launch_counts()
    reset_selection()
    q3 = pred.predict_batch(big)
    big_launches = dict(kernels.LAUNCHES)
    sel_c = dict(SELECTION)
    require(big_launches == {kn: PER_GRAPH.get(kn, 0)
                             for kn in kernels.SOURCES}, big_launches)
    require(sel_c["cell"] == 1 and sel_c["topk"] == 0, ("[slice c]", sel_c))
    sort_state = pred._sort_cache.get(big)
    require(sort_state is not None and not np.array_equal(
        sort_state[1][0], np.arange(big.padded_atoms)), "[slice c] sorted")
    twin = sort_state[3]
    moved = int((sort_state[1][0] != np.arange(big.padded_atoms)).sum())
    grid_c, k_c = pred._neighbor_grid(twin), pred._neighbor_k(twin)
    cons3 = abs(float(q3.astype(np.float64).sum()))
    require(np.all(np.isfinite(q3)) and cons3 <= 1e-4, cons3)
    nat = big.natoms[0]
    o_mean, h_mean = float(q3[0, 0:nat:3].mean()), float(q3[0, 1:nat:3].mean())
    require(o_mean < -0.5 < 0.2 < h_mean, (o_mean, h_mean))
    q3_topk = pred_topk.predict_batch(big)
    dq3 = float(np.abs(q3 - q3_topk).max())
    tol3 = 1e-5 * (float(np.abs(q3_topk).max()) + 1.0)
    cons3_topk = abs(float(q3_topk.astype(np.float64).sum()))
    require(dq3 < tol3 and cons3_topk <= 1e-4, (dq3, tol3, cons3_topk))
    ms3 = timed(lambda: pred.predict_batch(big), 3)
    turns_c = turns(timed, preds_b, lambda p: p.predict_batch(big), 3)
    # cold: also 'auto' unsorted, which isolates the sort's share
    big_mol = [water_box(SCALING_SIZE_MOLECULES, seed=2)]
    preds_c = {"topk": pred_topk,
               "auto unsorted": Predictor(pred.params, cfg,
                                          spatial_sort="off"),
               "auto": pred}
    cold_c = turns(timed, preds_c, lambda p: p.predict_molecules(big_mol),
                   5)
    parts_c = {name: cold_parts(torch, p, big_mol)
               for name, p in preds_c.items()}
    sort_rows = sort_phase(torch, card, big_mol[0])
    print(f"[slice c] 1 x {nat:,} atoms, k={pred._neighbor_k(big)}: launches "
          f"{big_launches}; spatially sorted ({moved:,} atoms moved); "
          f"neighbor selection calls "
          f"{sel_c}, grid (ncells, cap) {grid_c}, count_only k {k_c}; "
          f"max|dq| vs a topk/unsorted Predictor {dq3:.3e} (tol "
          f"{tol3:.3e}); raw |sum q - Q| = {cons3:.3e} (topk/unsorted "
          f"{cons3_topk:.3e}); mean q O {o_mean:.4f} H {h_mean:.4f}; "
          f"predict_batch median {ms3:.3f} ms; in turns warm auto (cell, "
          f"sorted) {turns_c['auto']} ms, topk/unsorted {turns_c['topk']} "
          f"ms; cold (predict_molecules) {cold_c} ms; cold set-up (ms) "
          f"{parts_c} on {card}")
    # the far-field kernel at this size, the O(N²) term of every round
    nb = big.padded_atoms
    mb = torch.from_numpy(big.node_mask[0]).to(dev)
    ab = torch.cat([torch.from_numpy(big.x[0]).to(dev),
                    torch.from_numpy(g.normal(size=(nb, cfg.h_dim)).astype(
                        np.float32)).to(dev) * mb[:, None],
                    torch.from_numpy(big.q0[0]).to(dev)[:, None]], dim=-1)
    big_args = ((ab @ wm.w1_i + wm.b1).contiguous(),
                (ab @ wm.w1_j).contiguous(), mb.contiguous(), *wm.mids[0])
    gbig = torch.from_numpy(g.normal(size=(nb, hh)).astype(np.float32)).to(
        dev)
    for name, entry in far_phase(torch, card, big_args, gbig, "17760",
                                 clocks, (5, 2, 5, 2)).items():
        rows[name]["sizes"]["17760"] = entry
    rows["dense_message_rowsum_int8"]["sizes"]["17760"] = int8_phase(
        torch, card, big_args, "17760", (5, 2, 5))
    print(f"[slice c] far field at N={nb}: dense_message_rowsum "
          f"{rows['dense_message_rowsum']['sizes']['17760']['ms']:.3f} ms "
          f"(bound {rows['dense_message_rowsum']['sizes']['17760']['bound_ms']:.3f}"
          f" ms in 3xTF32, "
          f"{rows['dense_message_rowsum']['sizes']['17760']['bound_fp32_ms']:.3f}"
          f" ms in fp32), dense_message_rowsum_bwd "
          f"{rows['dense_message_rowsum_bwd']['sizes']['17760']['ms']:.3f} ms "
          f"on {card}")

    # (d) the fully fused dense forward (no neighbor_k), B = 2, and the
    # plain dense forward on the card as its reference
    tb = [torch.from_numpy(arr).to(dev) for arr in (
        batch2.x, batch2.q0, batch2.xyz, batch2.node_mask)]

    def dense(use_pallas):
        with torch.no_grad():
            return forward_blocked(pred._fused, *tb, cfg,
                                   use_pallas=use_pallas).cpu().numpy()

    kernels.reset_launch_counts()
    qd = dense(True)
    dense_launches = dict(kernels.LAUNCHES)
    want = {kn: 2 * PER_GRAPH_DENSE.get(kn, 0) for kn in kernels.SOURCES}
    require(dense_launches == want, (dense_launches, want))
    dq_d = float(np.abs(qd[:, :golden.shape[1]] - golden).max())
    dq_db = float(np.abs(qd - q2).max())
    cons_d = np.abs(qd.astype(np.float64).sum(1) - total_q)
    require(np.all(np.isfinite(qd)) and dq_d < tol_q and dq_db < tol_q,
            (dq_d, dq_db, tol_q))
    require(np.all(cons_d <= 1e-4), cons_d)
    ms_d = timed(lambda: dense(True), 5)
    kernels.reset_launch_counts()
    qp = dense(False)
    plain_launches = dict(kernels.LAUNCHES)
    require(sum(plain_launches.values()) == 0, plain_launches)
    dq_p = float(np.abs(qp[:, :golden.shape[1]] - golden).max())
    dq_pd = float(np.abs(qp - qd).max())
    cons_p = np.abs(qp.astype(np.float64).sum(1) - total_q)
    require(dq_p < tol_q and dq_pd < tol_q, (dq_p, dq_pd, tol_q))
    require(np.all(cons_p <= 1e-4), cons_p)
    ms_p = timed(lambda: dense(False), 2)
    print(f"[slice d] forward_blocked(use_pallas=True), no neighbor_k, 2 x "
          f"2,220 atoms: launches {dense_launches} (per graph "
          f"{PER_GRAPH_DENSE}); max|dq| vs JAX golden {dq_d:.3e}, vs "
          f"[slice b] {dq_db:.3e} (tol {tol_q:.3e}); |sum q - Q| = "
          f"{cons_d.tolist()}; median {ms_d:.3f} ms. Plain dense forward "
          f"(_forward_single) on the card: no launches, max|dq| vs golden "
          f"{dq_p:.3e}, vs the fused path {dq_pd:.3e}, |sum q - Q| = "
          f"{cons_p.tolist()}, median {ms_p:.3f} ms on {card}")
    dense_dbl, dense_dbl_launches = dense_doubling_phase(
        torch, card, pred, batch2, qd, total_q, timed)

    # (e) kernel-built neighbor tables through the neighbor-split forward
    uq0 = pred._uniform_q0(batch2)

    def compact_forward():
        tables = [kernels.neighbor_compact(tb[2][b], tb[3][b], cfg.cutoff, k)
                  for b in range(batch2.batch_size)]
        nbrs = tuple(torch.stack(parts) for parts in zip(*tables))
        with torch.no_grad():
            return forward_blocked(pred._fused, *tb, cfg, neighbor_k=k,
                                   neighbors=nbrs,
                                   uniform_q0=uq0).cpu().numpy()

    kernels.reset_launch_counts()
    qe = compact_forward()
    compact_launches = dict(kernels.LAUNCHES)
    want = {kn: 2 * PER_GRAPH_COMPACT.get(kn, 0) for kn in kernels.SOURCES}
    require(compact_launches == want, (compact_launches, want))
    dq_e = float(np.abs(qe - q2).max())
    cons_e = np.abs(qe.astype(np.float64).sum(1) - total_q)
    require(np.all(np.isfinite(qe)) and dq_e < tol_q, (dq_e, tol_q))
    require(np.all(cons_e <= 1e-4), cons_e)
    ms_e = timed(compact_forward, 5)
    print(f"[slice e] neighbor_compact tables -> forward_blocked(neighbor_k="
          f"{k}, neighbors=(idx, mask)), 2 x 2,220 atoms: launches "
          f"{compact_launches} (per graph {PER_GRAPH_COMPACT}); max|dq| vs "
          f"[slice b] {dq_e:.3e} (tol {tol_q:.3e}); |sum q - Q| = "
          f"{cons_e.tolist()}; tables + forward median {ms_e:.3f} ms on "
          f"{card}")

    # (f) the int8 serving tier through Predictor: (b)'s boxes and (c)'s
    pred8 = Predictor(pred.params, cfg.replace(dense_matmul_precision="int8"))
    require(pred8._use_pallas(), "Predictor on the card takes the int8 tier")
    seen = []
    tier_fn = fused.dense_message_rowsum_int8

    def spy(*a, **kw):
        seen.append((tuple(t.clone() for t in a), kw))
        return tier_fn(*a, **kw)

    fused.dense_message_rowsum_int8 = spy
    try:
        kernels.reset_launch_counts()
        q8 = pred8.predict_batch(batch2)
        int8_launches = dict(kernels.LAUNCHES)
    finally:
        fused.dense_message_rowsum_int8 = tier_fn
    want = {kn: 2 * PER_GRAPH_INT8.get(kn, 0) for kn in kernels.SOURCES}
    require(int8_launches == want, (int8_launches, want))
    # every launch of the run again on its own inputs, padding rows and
    # cached weights: against the plain version (the fp32 bar), and its far
    # sums against the 3xTF32 kernel's (the tier moves them: more than 0,
    # less than 0.02 of max|out| + 1; 0.3-1% measured)
    far_errs, far_gaps = [], []
    for a, kw in seen:
        got = kernels.dense_message_rowsum_int8(*a, **kw)
        ref = kernels.dense_message_rowsum_int8_plain(*a, kw["pad_pi"])
        f32 = kernels.dense_message_rowsum(*a, **HI)
        far_errs.append(float((got - ref).abs().max())
                        / (1e-5 * (float(ref.abs().max()) + 1.0)))
        far_gaps.append(float((got - f32).abs().max())
                        / (float(f32.abs().max()) + 1.0))
    require(len(seen) == 8 and all(kw["w2_int8"] is not None
                                   for _, kw in seen), len(seen))
    require(max(far_errs) <= 1.0, ("int8 launches vs plain", far_errs))
    require(0.0 < min(far_gaps) and max(far_gaps) < 0.02, far_gaps)
    gap8 = float(np.abs(q8 - q2).max())
    dq8 = float(np.abs(q8[:, :golden.shape[1]] - golden).max())
    tier_bar = 0.05 * (float(np.abs(q2).max()) + 1.0)
    cons8 = np.abs(q8.astype(np.float64).sum(1) - total_q)
    require(np.all(np.isfinite(q8)) and gap8 < tier_bar, (gap8, tier_bar))
    require(np.all(cons8 <= 1e-4), cons8)
    kernels.reset_launch_counts()
    q8b = pred8.predict_batch(big)
    big8_launches = dict(kernels.LAUNCHES)
    require(big8_launches == {kn: PER_GRAPH_INT8.get(kn, 0)
                              for kn in kernels.SOURCES}, big8_launches)
    gap8b = float(np.abs(q8b - q3).max())
    cons8b = abs(float(q8b.astype(np.float64).sum()))
    require(np.all(np.isfinite(q8b)) and cons8b <= 1e-4, cons8b)
    require(gap8b < 0.05 * (float(np.abs(q3).max()) + 1.0), gap8b)
    # both tiers' medians, in turns (fp32, int8, int8, fp32)
    tiers = {"fp32": pred, "int8": pred8}
    medians = {}
    for label, batch, reps in (("2x2220", batch2, 7), ("1x17760", big, 3)):
        runs = {"fp32": [], "int8": []}
        for tier in ("fp32", "int8", "int8", "fp32"):
            runs[tier].append(timed(lambda: tiers[tier].predict_batch(batch),
                                    reps))
        medians[label] = runs
    print(f"[slice f] int8 tier (dense_matmul_precision='int8'), Predictor "
          f"on the card: 2 x 2,220 atoms launches {int8_launches} (per graph "
          f"{PER_GRAPH_INT8}); each launch again vs its plain version: "
          f"max|d| at most {max(far_errs):.3e} of the bar 1e-5(max|ref|+1); "
          f"far sums of the run vs the 3xTF32 kernel: max|d|/(max|out|+1) "
          f"{min(far_gaps):.3e} .. {max(far_gaps):.3e} (bar 0.02); "
          f"charges vs [slice b] max|dq| {gap8:.3e} (tier bar "
          f"{tier_bar:.3e}), vs JAX golden {dq8:.3e}; |sum q - Q| = "
          f"{cons8.tolist()}. 1 x {big.natoms[0]:,} atoms: launches "
          f"{big8_launches}; vs [slice c] max|dq| {gap8b:.3e}; |sum q - Q| "
          f"= {cons8b:.3e}. predict_batch medians (fp32, int8, int8, fp32 "
          f"turns): " + "; ".join(
              f"{lb} fp32 {r['fp32'][0]:.3f}/{r['fp32'][1]:.3f} ms, int8 "
              f"{r['int8'][0]:.3f}/{r['int8'][1]:.3f} ms"
              for lb, r in medians.items()) + f" on {card}")

    # (g) MD serving: Verlet-skin trajectories at both sizes
    md = md_phase(torch, card, pred, [
        ("2220", golden_boxes()[1]),
        ("17760", water_box(SCALING_SIZE_MOLECULES, seed=2))])

    # (h) the clustered far-field tier: mixed_b16 at both sizes, then a
    # random-weight model that reads the far field
    cluster, cluster_launches = cluster_phase(
        torch, card, pred, [("2x2220", batch2, 7), ("1x17760", big, 3)],
        timed, rows, clocks)
    cluster_acc = cluster_accuracy_phase(torch, card, golden_boxes()[0])
    # (i) the charges' pullback through the positions
    vjp, vjp_launches = vjp_phase(torch, card, pred, golden_boxes()[0],
                                  timed)
    # (j) the huge-N memory mode
    huge, huge_launches = huge_serving_phase(
        torch, card, pred, [("2x2220", batch2), ("1x17760", big)], timed,
        rows)
    # (k) the precision tiers: the kernels' one-pass tier on the inputs of
    # the 3xTF32 checks above, then every tier through Predictor
    tier_kernels = tier_kernels_phase(
        torch, card, pred, batch2, big,
        [("2220", far_args, gbar, (50, 0, 20, 0)),
         ("17760", big_args, gbig, (5, 0, 2, 0))],
        fused_boxes, sfu_rate, clocks)
    tier_serve, tier_launches = tier_serving_phase(
        torch, card, pred, batch2, big, golden, total_q, timed)
    # [export] the serving artifacts, and the operators' dispatch cost
    export_out, export_launches = export_phase(
        torch, card, pred, pred8, batch2, big, small, timed)
    runs = [timed(lambda: pred.predict_batch(batch2), 1) for _ in range(9)]
    dispatch = dispatch_phase(torch, pred, batch2)
    dispatch["predict_batch_2x2220_ms"] = dict(
        median=float(np.median(runs)), spread=max(runs) - min(runs),
        calls=[round(r, 3) for r in runs])
    print(f"[export] dispatch of the registered operators (an exported "
          f"program's route; eager calls run the bodies), host us a call "
          f"in turns (op, body, body, op): " + "; ".join(
              f"{n} op {dispatch[n]['op']} body {dispatch[n]['body']}"
              for n in dispatch["launches_per_call"])
          + f"; x the launches of a 2 x 2,220 call "
          f"{dispatch['launches_per_call']}: {dispatch['cost_per_call_ms']:.4f}"
          f" ms a call, beside the call's warm median "
          f"{dispatch['predict_batch_2x2220_ms']['median']:.3f} ms and spread "
          f"(max - min of 9) {dispatch['predict_batch_2x2220_ms']['spread']:.3f}"
          f" ms on {card}")

    # [mesh] multi-device serving: one NCCL rank, the kernel at the ranks'
    # shapes, then two gloo ranks sharing the card
    mboxes = mesh_boxes(table)
    mesh_refs = {"2x2220": q2, "1x17760": q3}
    mesh_a, mesh_a_launches, mesh_c_a, mesh_c_a_launches = \
        mesh_one_rank_phase(torch, card, pred, mboxes, mesh_refs, timed)
    mesh_shapes = mesh_shape_rows(torch, card, far_args, big_args, rows)
    mesh_c_shapes = mesh_train_shape_rows(
        torch, card, far_args, gbar,
        {label: near_inputs(pred, b, np.random.default_rng(0))[0]
         for label, b in (("2220", batch2), ("17760", big))}, rows)
    mesh_b, mesh_b_launches, gloo = mesh_two_rank_phase(torch, card, mboxes,
                                                        mesh_refs)
    mesh_c_b_launches = mesh_b.pop("train_launches")

    # ---- 5. training ------------------------------------------------------
    small_labels = [q.copy() for q in qs]
    train_launches, step_ms, step_list, train_mols = train_phase(
        torch, pred, card, small, small_labels, batch2, golden)
    train_c, _ = train_cluster_phase(torch, pred, card, train_mols, small,
                                     step_list)
    train_d, huge_train_launches = huge_train_phase(torch, pred, card)
    train_e, tier_train_launches = tier_train_phase(torch, card, pred,
                                                    train_mols, small)
    train_f, options_launches = train_options_phase(torch, pred, card,
                                                    train_mols, small)
    cli_out, cli_launches, cli_train_launches = cli_phase(
        torch, card, pred, golden, {"2x2220": ms2, "1x17760": ms3},
        train_mols, small)
    profile = profile_phase(
        torch, card, pred, batch2, big, pred8,
        Predictor(pred.params, cfg, far_cluster=CLUSTER_CS[0]),
        {tier: Predictor(pred.params, cfg.replace(**PRECISION_TIERS[tier]))
         for tier in ("parity", "fast")})
    flops = flops_phase(torch, card, pred, [("2x2220", batch2),
                                            ("1x17760", big)], flops_child,
                        flops_out)
    shutil.rmtree(flops_dir, ignore_errors=True)

    # ---- 6. result lines --------------------------------------------------
    # launches: each kernel's count in the main path of its slice
    # (serving: the 2 x 2,220 predict_batch; training: the train() run)
    for name in rows:
        path_launches = {"serve": main_launches[name],
                         "train": train_launches[name],
                         "dense_fused": dense_launches[name],
                         "dense_fused_doubling": dense_dbl_launches[name],
                         "compact_nbrs": compact_launches[name],
                         "int8": int8_launches[name],
                         "cluster": cluster_launches[name],
                         "position_vjp": vjp_launches[name],
                         "huge_serve": huge_launches[name],
                         "huge_train": huge_train_launches[name],
                         "cli_infer": cli_launches[name],
                         "cli_train": cli_train_launches[name],
                         "export": export_launches[name],
                         "train_options": options_launches[name],
                         "mesh_one_rank": mesh_a_launches[name],
                         "mesh_two_ranks_rank0": mesh_b_launches.get(name,
                                                                     0),
                         "mesh_train_one_rank": mesh_c_a_launches[name],
                         "mesh_train_two_ranks_rank0":
                             mesh_c_b_launches.get(name, 0)}
        rows[name]["launches_by_path"] = path_launches
        rows[name]["launches"] = path_launches[MAIN_PATH.get(name, "serve")]
        require(rows[name]["launches"] > 0, (name, path_launches))
        if name in kernels.TIERED:
            # the one-pass tier: its checks and times ([slice k]), and its
            # launches in each tier's 2 x 2,220 call and in [train e]
            rows[name]["tier"] = {"default": dict(
                tier_kernels[name], launches_by_tier={
                    tier: tier_launches[tier][name]
                    for tier in PRECISION_TIERS},
                launches_train_fast=tier_train_launches[name])}
    require(sorted(rows) == sorted(kernels.SOURCES), sorted(rows))
    print(json.dumps({"kernels": list(rows.values()),
                      "predict_batch_ms": {"2x2220": ms2, "1x17760": ms3},
                      "selection_turns_ms": {"2x2220": turns_b,
                                             "1x17760": turns_c},
                      "cold_turns_ms": {"2x2220": cold_b,
                                        "1x17760": cold_c},
                      "cold_setup_ms": {"2x2220": parts_b,
                                        "1x17760": parts_c},
                      "sort_random_weights": sort_rows,
                      "fused_train_step_ms": {"2x2220": step_ms,
                                              "2x2220_steps": step_list},
                      "dense_fused_ms": {"2x2220": ms_d},
                      "dense_fused_doubling": dense_dbl,
                      "dense_plain_ms": {"2x2220": ms_p},
                      "compact_nbrs_ms": {"2x2220": ms_e},
                      "neighbor_selection": selection,
                      "md_serving": md,
                      "slice_c": {"selection_calls": sel_c,
                                  "sort_moved_atoms": moved,
                                  "grid": list(grid_c), "count_only_k": k_c,
                                  "max_dq_vs_topk_unsorted": dq3,
                                  "tol": tol3, "raw_sum_q": cons3,
                                  "raw_sum_q_topk_unsorted": cons3_topk},
                      "int8_tier": {
                          "predict_batch_ms_turns": medians,
                          "far_sum_gap_rel": far_gaps,
                          "launch_err_over_bar": far_errs,
                          "charges_gap": {"2x2220": gap8, "1x17760": gap8b},
                          "golden_dq": dq8,
                          "conservation": {"2x2220": cons8.tolist(),
                                           "1x17760": cons8b}},
                      "cluster": cluster, "cluster_accuracy": cluster_acc,
                      "position_vjp": vjp, "train_cluster": train_c,
                      "huge_serving": huge, "huge_train": train_d,
                      "precision_tiers": tier_serve, "train_fast": train_e,
                      "cli": cli_out, "export": export_out,
                      "dispatch": dispatch, "train_options": train_f,
                      "mesh": {"one_rank": mesh_a, "two_ranks": mesh_b,
                               "rank_shapes": mesh_shapes,
                               "gloo_cuda": gloo,
                               "train_one_rank": mesh_c_a,
                               "train_rank_shapes": mesh_c_shapes},
                      "widths": width_results,
                      "profile": profile, "flops": flops,
                      "sm_clocks": clocks,
                      "card": card}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
