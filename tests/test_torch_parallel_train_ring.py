"""Training on the mesh, the ring and the data-parallel step: the
ring-sharded ``make_sharded_train_step`` (exact, clustered with the
distributed fit's gradient, and the round-1 collapse on both shard
modes) and the trainer's ``data_parallel_train_step`` on two gloo ranks,
against the JAX package's sharded steps and ``train_step`` on two
virtual CPU devices and against the port's one-device steps, at the bars
of ``test_torch_parallel_train.py``.  The data-parallel step holds JAX's
``test_dp_step_matches_single_device`` bar too: its loss at rtol 1e-5 of
the one-device step's.
"""

import numpy as np
import pytest
import torch

import torch_mesh as M
from torch_mesh import result, train_case

torch.set_num_threads(2)


def cases():
    batch = M.train_batch()
    k = M.neighbor_k(batch[2], batch[3])
    uq0 = M.with_labels(M.contract_batch(), 7)
    k_uq0 = M.neighbor_k(uq0[2], uq0[3])
    dp = M.train_batch(seed=3, b=4, n=8)
    # the ring's k_blk bounds a row's count in one block: min(k, N/D)
    # always does; the one-device step takes the whole count
    return {
        "ring": train_case("ring", batch, min(k, 24), ref_k=k),
        "ring_cluster": train_case("ring", batch, min(k, 24), ref_k=k,
                                   steps=4, step=dict(
                                       far_cluster=4,
                                       far_cluster_grad=True)),
        "uq0_atom": train_case("atom", uq0, k_uq0,
                               step=dict(uniform_q0=True)),
        "uq0_ring": train_case("ring", uq0, min(k_uq0, 24), ref_k=k_uq0,
                               step=dict(uniform_q0=True)),
        "dp": train_case("dp", dp, mesh=(2, 1)),
        "dp_fused": train_case("dp_fused", dp, 7, mesh=(2, 1), jax=False),
        "indivisible": train_case("dp", M.train_batch(seed=3, b=3, n=8),
                                  mesh=(2, 1), steps=1, jax=False),
    }


CASES = cases()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return M.run(CASES, str(tmp_path_factory.mktemp("mesh_train_ring")))


@pytest.mark.parametrize("name", ["ring", "ring_cluster", "uq0_atom",
                                  "uq0_ring", "dp"])
def test_step_matches_jax(runs, name):
    port, ref, _ = runs
    M.assert_trains_like_jax(port, ref, name)
    want = ref[name]["losses"]
    assert want[-1] < want[0], want


@pytest.mark.parametrize("name", ["ring", "ring_cluster", "uq0_atom",
                                  "uq0_ring", "dp", "dp_fused"])
def test_step_matches_one_device(runs, name):
    port, _, extras = runs
    M.assert_trains_like_one_device(port, extras, name)


@pytest.mark.parametrize("name", ["dp", "dp_fused"])
def test_data_parallel_loss_matches_one_device(runs, name):
    """JAX's ``test_dp_step_matches_single_device``: the (2, 1) step's
    loss at rtol 1e-5 of the one-device step's, dense and blocked."""
    out = result(runs[0], name)
    np.testing.assert_allclose(out["losses"][0], out["ref_loss"], rtol=1e-5)


def test_indivisible_batch_rejected(runs):
    out = runs[0]["indivisible"]
    assert out[0] == "error" and "not divisible" in out[1], out
