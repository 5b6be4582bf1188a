"""The weights a cell runs: a seeded draw made on the device.  Both sides
get the same numbers: the program a float32 tree, the reference the same
values widened to float64.  The draw is fixed by the configuration's
``weights.seed``, as a served checkpoint is fixed: the run's seed draws
only the traffic."""

from __future__ import annotations

import math

import torch


def shapes(model: dict) -> dict:
    """{mlp: {dense_k: (in, out)}} of the model's tree."""
    fa = model["n_elems"] + model["h_dim"] + 1
    pair = 2 * fa + model["e_dim"]
    hid = list(model["mlp_hidden"])

    def mlp(i, o):
        w = [i, *hid, o]
        return {f"dense_{k}": (w[k], w[k + 1]) for k in range(len(w) - 1)}

    tree = {f"message_{t}": mlp(pair, model["msg_dim"])
            for t in range(model["T"])}
    tree["update"] = mlp(model["h_dim"] + model["msg_dim"], model["h_dim"])
    tree.update({f"pass_{t}": mlp(pair, 1) for t in range(model["T"])})
    return tree


def seeded(model: dict, init: dict, seed: int, device) -> dict:
    """A float32 tree drawn from ``seed`` on ``device`` in one call:
    every kernel uniform in ±gain·sqrt(6 / (fan_in + fan_out)) (Glorot),
    every bias uniform in ±``bias``; the gain is ``init["gain"]``, and
    ``init["message_out_gain"]`` for the last layer of each message MLP,
    whose outputs the model sums over every atom of a graph."""
    tree = shapes(model)
    sizes = [(name, d, i, o) for name, layers in tree.items()
             for d, (i, o) in layers.items()]
    total = sum(i * o + o for _, _, i, o in sizes)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    flat = torch.rand(total, generator=gen, device=device,
                      dtype=torch.float32) * 2.0 - 1.0
    out, at = {}, 0
    last = f"dense_{len(model['mlp_hidden'])}"
    for name, d, i, o in sizes:
        gain = (init["message_out_gain"]
                if name.startswith("message_") and d == last
                else init["gain"])
        limit = gain * math.sqrt(6.0 / (i + o))
        kernel = flat[at:at + i * o].view(i, o) * limit
        at += i * o
        bias = flat[at:at + o] * init["bias"]
        at += o
        out.setdefault(name, {})[d] = {"kernel": kernel, "bias": bias}
    return out


def load(cfg_spec: dict, device) -> dict:
    """The cell's float32 tree on ``device``: ``weights.kind`` "seeded"
    draws it from ``weights.seed``, the same weights in every run, as a
    served checkpoint."""
    w = cfg_spec["weights"]
    if w["kind"] == "seeded":
        return seeded(cfg_spec["model"], w, w["seed"], device)
    raise ValueError(f"weights kind {w['kind']!r}")
