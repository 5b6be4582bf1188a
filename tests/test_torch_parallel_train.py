"""Training on the mesh, atom-sharded: ``make_sharded_train_step`` in its
dense and neighbor-split forms on two gloo ranks (one thread each),
against the JAX package's sharded step on two virtual CPU devices
(``tests/torch_mesh.py``; the cases of ``tests/test_sharding.py``'s
training tests, the same weights and batches on both sides) and against
the port's own one-device step; then the trainer on the mesh.

JAX's bars: the first step's loss within rtol 1e-4 of JAX's sharded step
(``tests/test_sharding.py:283``, ``:389``), the parameters after one Adam
step within 1e-3 relative Frobenius a leaf, the loss falling over the
steps.  Against the port's one-device step (``train_step_fused``, or
``train_step`` for the dense form) the first step's gradients are held
to ``chip_smoke.py``'s [train a] bar (1e-3 relative Frobenius a leaf,
the loss within 1e-5·(|loss| + 1)), and both ranks end with the same
parameters, bit for bit.  The trainer's cases are the port's alone:
``train(mesh=...)`` sending its big bucket through the sharded step, and
``train --data-parallel`` / ``--multihost`` on the two ranks.  The ring
and the data-parallel step: ``test_torch_parallel_train_ring.py``.
"""

import json
import os

import numpy as np
import pytest
import torch

import torch_mesh as M
from torch_mesh import Case, result, train_case

torch.set_num_threads(2)

CLI_SMALL = ["--rounds", "1", "--h-dim", "8", "--e-dim", "8", "--msg-dim",
             "8", "--layers", "8"]


def cases(tmp: str):
    batch = M.train_batch()
    k = M.neighbor_k(batch[2], batch[3])
    (x, q0, xyz, mask), k_win, nbrs, win = M.window_case()
    wbatch = M.with_labels((x, q0, xyz, mask), 8)
    return {
        "dense": train_case("dense", batch),
        "atom": train_case("atom", batch, k, step=dict(remat=False)),
        "atom_remat": train_case("atom", batch, k, jax=False),
        "chunked": train_case("atom", wbatch, k_win, neighbors=nbrs,
                              step=dict(near_row_chunk=8, near_window=win)),
        "cluster": train_case("atom", batch, k, steps=4,
                              step=dict(far_cluster=4,
                                        far_cluster_grad=True)),
        "cluster_stop": train_case("atom", batch, k, steps=4,
                                   step=dict(far_cluster=4)),
        "trainer": Case("trainer", kw=dict(
            mols=M.labelled_molecules(12, 3, 17, 24, 5.0),
            tc=dict(epochs=4, batch_size=1, dense_max_atoms=16, seed=1)),
            mesh=(1, 2), jax=False),
        "cli_dp": Case("cli_train", kw=dict(
            mols=M.labelled_molecules(5, 6, 3, 9, 3.0),
            argv=["--data-parallel", *CLI_SMALL],
            dir=os.path.join(tmp, "cli_dp"), out=os.path.join(tmp, "run_dp")),
            mesh=(2, 1), jax=False),
        "cli_multihost": Case("cli_train", kw=dict(
            mols=M.labelled_molecules(6, 6, 3, 9, 3.0),
            argv=["--multihost", *CLI_SMALL],
            dir=os.path.join(tmp, "cli_mh"), out=os.path.join(tmp, "run_mh")),
            mesh=(2, 1), jax=False),
        "dcp": Case("dcp", batch, dict(k=k, dir=os.path.join(tmp, "state")),
                    mesh=(1, 2), jax=False),
    }


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("mesh_train"))
    cs = cases(tmp)
    port, ref, extras = M.run(cs, tmp)
    return port, ref, extras, cs


ATOM = ["dense", "atom", "chunked", "cluster", "cluster_stop"]


@pytest.mark.parametrize("name", ATOM)
def test_sharded_step_matches_jax(runs, name):
    port, ref, _, _ = runs
    M.assert_trains_like_jax(port, ref, name)
    want = ref[name]["losses"]
    assert want[-1] < want[0], want


@pytest.mark.parametrize("name", ATOM + ["atom_remat"])
def test_sharded_step_matches_one_device(runs, name):
    port, _, extras, _ = runs
    M.assert_trains_like_one_device(port, extras, name)


def test_remat_changes_nothing(runs):
    """Checkpointed rounds recompute the same values: the losses and the
    first step's gradients of ``remat`` equal the plain step's."""
    port = runs[0]
    a, b = result(port, "atom"), result(port, "atom_remat")
    assert a["losses"] == b["losses"]
    for ga, gb in zip(a["grads1"], b["grads1"]):
        np.testing.assert_array_equal(ga, gb)


def test_trainer_dispatches_big_buckets_to_the_sharded_step(runs):
    """JAX's ``test_public_trainer_atom_sharded_dispatch``: on a (1, 2)
    mesh the buckets padded past ``dense_max_atoms`` to a width the atoms
    axis divides train through ``make_sharded_train_step``; the loss falls
    and both ranks end with the same parameters and history."""
    port, _, extras, _ = runs
    out = result(port, "trainer")
    assert out["calls"]["sharded"] > 0 and out["calls"]["built"] >= 1
    losses = [r["train_loss"] for r in out["history"]]
    assert np.all(np.isfinite(losses)) and losses[-1] < losses[0], losses
    a, b = (extras[r]["trainer"] for r in range(M.WORLD))
    assert np.array_equal(a["final"], b["final"])
    assert [r["train_loss"] for r in a["history"]] == \
        [r["train_loss"] for r in b["history"]]


def test_sharding_aware_state_format_on_the_mesh(runs):
    """Both ranks save one atom-sharded step's state together with
    ``save_train_state_orbax`` (``torch.distributed.checkpoint``) and load
    it back bit for bit; both see one checkpoint (the same files, the
    metadata once) of the same parameters."""
    _, _, extras, _ = runs
    a, b = (extras[r]["dcp"] for r in range(M.WORLD))
    assert a["same"] and b["same"]
    assert a["files"] == b["files"] and ".metadata" in a["files"]
    assert np.array_equal(a["final"], b["final"])


@pytest.mark.parametrize("name,flag", [("cli_dp", "data-parallel over"),
                                       ("cli_multihost", "multi-host mesh")])
def test_cli_trains_on_the_world(runs, name, flag):
    """``train --data-parallel`` / ``--multihost`` on the two ranks: each
    names its mesh, rank 0 alone writes the log (one row an epoch) and
    the checkpoint."""
    _, _, extras, cs = runs
    for r in range(M.WORLD):
        text = extras[r][name]
        assert isinstance(text, str), text
        assert flag in text and "{'data': 2, 'atoms': 1}" in text, text
        assert "best val masked MAE" in text
    out = cs[name].kw["out"]
    rows = [json.loads(ln) for ln in open(os.path.join(out, "metrics.jsonl"))]
    assert [r["epoch"] for r in rows] == [0, 1]
    assert os.path.exists(os.path.join(out, "best", "params.msgpack"))


@pytest.mark.parametrize("mode", ["atom", "ring", "dense"])
def test_world_of_one_equals_the_one_device_step(mode):
    """A mesh of one process in this one (gloo on the CPU): the sharded
    step's loss and gradients are the one-device step's, at [train a]'s
    bar."""
    from epnn_tpu_torch.io.checkpoint import from_jax_params
    from epnn_tpu_torch.models import EPNNConfig, tree_leaves
    from epnn_tpu_torch.parallel import make_mesh, make_sharded_train_step
    from epnn_tpu_torch.train import TrainConfig, loop

    cfg = EPNNConfig(**M.SMALL)
    tree = from_jax_params(M.jax_params(M.SMALL, 0, 0.2), cfg)
    arrays = M.train_batch()
    args = [torch.from_numpy(a) for a in arrays]
    k = None if mode == "dense" else M.neighbor_k(arrays[2], arrays[3])
    mesh = make_mesh(1, 1, device_type="cpu")
    tc = TrainConfig(learning_rate=3e-3)
    st = loop.create_state(cfg, tc, device="cpu", params=tree)
    ref = loop.create_state(cfg, tc, device="cpu", params=tree)
    step = make_sharded_train_step(cfg, None, mesh, neighbor_k=k,
                                   shard_mode="ring" if mode == "ring"
                                   else "atom")
    _, loss, _, _ = step(st, *args)
    if k is None:
        _, ref_loss, _, _ = loop.train_step(ref, cfg, "masked_mse", None,
                                            *args)
    else:
        _, ref_loss, _, _ = loop.train_step_fused(
            ref, cfg, "masked_mse", None, 8, k, *args, remat=False)
    assert abs(float(loss) - float(ref_loss)) <= 1e-5 * (abs(float(ref_loss))
                                                        + 1.0)
    for p, r in zip(tree_leaves(st.params), tree_leaves(ref.params)):
        assert M.rel_fro(p.grad.numpy(), r.grad.numpy()) <= 1e-3


def test_pmax_carries_no_gradient():
    """``pmax`` (the ring's round-1 maxima, the fit's radius) has no VJP:
    a tensor autograd records raises; without one it reduces."""
    from epnn_tpu_torch.parallel import _collectives as C
    from epnn_tpu_torch.parallel import make_mesh

    group = make_mesh(1, 1, device_type="cpu").get_group("atoms")
    t = torch.tensor([1.0, 3.0], requires_grad=True)
    with pytest.raises(RuntimeError, match="no gradient"):
        C.pmax(t, group)
    assert torch.equal(C.pmax(t.detach(), group), t.detach())
    with torch.no_grad():
        assert torch.equal(C.pmax(t, group), t.detach())
