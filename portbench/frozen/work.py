"""The model's work, frozen: the work formulas of the port's far-field and
near kernels (``epnn_tpu_torch.ops.kernels.work`` as of its copy) and the
products of a whole serving call, worked out from the call's shapes alone.

A product counts 2 FLOP a multiply-add, over the whole grid the model
defines, whatever kernel runs it: the far field over every (row, column)
pair, a near kernel over every slot of its (N, k) table.  That is what
``epnn_tpu_torch.utils.timing.count_flops`` reads of a call
(``portbench/tests`` holds the two equal); ``mfu`` reads this copy, so no
change to the port moves its numerator.  The rooflines count instead what
the inputs need: the live pairs and slots, each input byte read once and
each output byte written once.

At the clustered tier (``far_cluster`` = C > 0) a far round runs over C
centroid columns, R × C pairs; its k-means fit is no product of the
model and is not counted."""

from __future__ import annotations

from typing import Dict, NamedTuple, Sequence


def round_up(n: int, m: int) -> int:
    return -(-int(n) // m) * m


def padded_atoms(natoms: int) -> int:
    """The padded width of a graph of ``natoms`` atoms: a multiple of 8."""
    return round_up(max(int(natoms), 1), 8)


def safe_k(count: int, n_pad: int) -> int:
    """The neighbor slots a graph's table has for a largest neighbor
    count ``count``: four slots of room, rounded up to 8, at most N − 1."""
    return max(min(round_up(count + 4, 8), n_pad - 1), 1)


class Work(NamedTuple):
    """One kernel call: ``flops`` (the model's count, above), and the
    least ``products`` (tensor-core FLOP, one product where 3xTF32 runs
    three) and ``bytes`` that the call's inputs need."""

    flops: int
    products: float
    bytes: float


def far_field(rows: int, cols: int, h: int, live: int = None) -> Work:
    """``dense_message_rowsum`` on R × C pairs at hidden width H: per live
    pair (a column with a non-zero weight; default every column) the
    H × H mid product; pi, the column weights and the output whole, pj of
    the live columns, W2 and b2 once, float32."""
    live = cols if live is None else live
    return Work(2 * rows * cols * h * (h + 1), rows * live * 2 * h * h,
                4 * (2 * rows * h + cols + live * h + h * h + h))


def near(n: int, k: int, h: int, e: int, row_width: int, live: int = None,
         live_rows: int = None) -> Work:
    """A near kernel on N rows of k slots (``row_width`` = H for
    ``near_message_corr``, 2H for ``near_pass_rowsum``): per live slot
    rbf @ W1e and two H × H products; a live slot's gathered row and RBF
    row in, the row inputs of rows with a live slot, the whole (N, k)
    weights, the output, the weights once."""
    live = n * k if live is None else live
    live_rows = n if live_rows is None else live_rows
    per = 2 * e * h + 4 * h * h
    return Work(n * k * per, live * per,
                4 * (live * (row_width + e) + live_rows * row_width
                     + n * k + n * h) + 4 * (e * h + h * h + h))


def _mlp(widths: Sequence[int]) -> int:
    return sum(2 * a * b for a, b in zip(widths[:-1], widths[1:]))


def graph_flops(model: dict, n_pad: int, k: int, collapse: bool = True,
                far_cluster: int = 0) -> Dict[str, int]:
    """The products of one graph through the port's neighbor split at
    padded width ``n_pad`` and ``k`` neighbor slots, as ``{"far": the far
    field's, "rest": every other product}``: per message round the two
    atom projections, the far field (round 1 collapsed to the element
    grid where ``collapse``; the others over every column, or over
    ``far_cluster`` = C centroid columns), the near correction, the
    message head and the update MLP; per pass round the two projections,
    the near pass kernel and its head."""
    n, e, hd = n_pad, model["e_dim"], model["h_dim"]
    hid = list(model["mlp_hidden"])
    h, msg, elems = hid[0], model["msg_dim"], model["n_elems"]
    if len(hid) != 2:
        raise ValueError("the count follows the kernels' one mid layer")
    fa = elems + hd + 1                       # [x, h, q]
    proj = 2 * (2 * n * fa * h)               # a @ W1_i, a @ W1_j
    far = rest = 0
    for t in range(model["T"]):
        rest += proj
        if t == 0 and collapse:
            grid = elems                      # E elements + the padding row
            rest += (2 * n * (elems - 1)      # counts: jvec @ onehot
                     + 2 * grid * fa * h      # grid @ W1_j
                     + 2 * n * grid * h * hid[1]   # the mid layer
                     + 2 * n * grid * h)      # the count-weighted sum
        else:
            far += far_field(n, far_cluster or n, h).flops
        rest += near(n, k, h, e, h).flops
        rest += 2 * n * h * msg               # the message head
        rest += n * _mlp([hd + msg, *hid, hd])    # the update MLP
    for _ in range(model["T"]):
        rest += proj + near(n, k, h, e, 2 * h).flops + 2 * n * h
    return {"far": far, "rest": rest}


def call_flops(model: dict, n_pads: Sequence[int], ks: Sequence[int],
               collapse: bool = True,
               far_cluster: int = 0) -> Dict[str, int]:
    """The products of one ``predict_batch`` call, split as
    :func:`graph_flops`: its graphs at their padded widths and slots."""
    out = {"far": 0, "rest": 0}
    for n, k in zip(n_pads, ks):
        for key, v in graph_flops(model, n, k, collapse,
                                  far_cluster).items():
            out[key] += v
    return out
