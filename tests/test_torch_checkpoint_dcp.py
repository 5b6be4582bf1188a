"""The sharding-aware train-state format (``io.checkpoint.
save_train_state_orbax`` / ``load_train_state_orbax``, the counterpart of
the JAX package's orbax backend, ``tests/test_parity.py:273``), written
with ``torch.distributed.checkpoint`` on the CPU with no process group:
every leaf of a ``TrainState`` after one ``train_step_fused`` round-trips
bit for bit into a fresh template — parameters, Adam's moments and update
count, the step, the injected rate, an open gradient-accumulation window
— beside the single-host ``train_state.msgpack`` in the same directory.
The two-rank save (every rank calls the pair) runs on
``tests/test_torch_parallel_train.py``'s gloo ranks."""

import os

import numpy as np
import pytest
import torch

from epnn_tpu_torch.io import checkpoint as ckpt
from epnn_tpu_torch.models import EPNNConfig, tree_leaves
from epnn_tpu_torch.train import TrainConfig, loop

torch.set_num_threads(1)

CFG = EPNNConfig(h_dim=16, e_dim=16, msg_dim=8, mlp_hidden=(8, 8), T=2)


def _batch(seed=0, b=2, n=20):
    g = np.random.default_rng(seed)
    x = np.zeros((b, n, CFG.n_elems), np.float32)
    x[:, :, 0] = 1.0
    x[np.arange(b)[:, None], np.arange(n)[None], 1 + g.integers(
        0, CFG.n_elems - 1, (b, n))] = 1.0
    xyz = g.uniform(0, 6.0, (b, n, 3)).astype(np.float32)
    mask = np.ones((b, n), np.float32)
    mask[:, -3:] = 0.0
    y = (g.normal(size=(b, n)) * 0.1 * mask).astype(np.float32)
    return [torch.from_numpy(a) for a in (
        x, np.zeros((b, n), np.float32), xyz, mask, y,
        np.ones(b, np.float32))]


def _stepped(tc, seed=0):
    state = loop.create_state(CFG, tc, seed=seed, device="cpu")
    loop.train_step_fused(state, CFG, "masked_mse", None, 8, 19, *_batch(),
                          remat=False)
    return state


def _leaves(state):
    moments = loop._adam_moments(state)
    out = [t.detach() for t in tree_leaves(state.params)]
    out += [t for m in moments for t in tree_leaves(m)]
    out += [torch.tensor(state.step), torch.tensor(state.opt.count),
            state.opt.lr, torch.tensor(state.opt.mini_step)]
    return out + list(state.opt.acc or [])


@pytest.mark.parametrize("tc", [TrainConfig(learning_rate=3e-3),
                                TrainConfig(learning_rate=3e-3,
                                            grad_accum=2)],
                         ids=["adam", "accumulating"])
def test_round_trip_bit_for_bit(tmp_path, tc):
    state = _stepped(tc)
    assert state.step == 1
    if tc.grad_accum > 1:
        assert state.opt.acc is not None and state.opt.mini_step == 1
    else:
        assert state.opt.count == 1
    ckpt.save_train_state_orbax(str(tmp_path), state)
    assert os.path.exists(tmp_path / ckpt.DCP_DIR / ".metadata")
    template = loop.create_state(CFG, tc, seed=7, device="cpu")
    got = ckpt.load_train_state_orbax(str(tmp_path), template)
    assert got is template
    want, have = _leaves(state), _leaves(template)
    assert len(want) == len(have)
    for a, b in zip(want, have):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert all(p.requires_grad and p.is_leaf
               for p in tree_leaves(template.params))


def test_resumed_state_steps_as_the_original(tmp_path):
    """The loaded template's next step equals the original's, bit for bit
    (the moments, the count and the rate all carried over)."""
    tc = TrainConfig(learning_rate=3e-3)
    state = _stepped(tc)
    ckpt.save_train_state_orbax(str(tmp_path), state)
    template = ckpt.load_train_state_orbax(
        str(tmp_path), loop.create_state(CFG, tc, seed=9, device="cpu"))
    for s in (state, template):
        loop.train_step_fused(s, CFG, "masked_mse", None, 8, 19,
                              *_batch(seed=1), remat=False)
    for a, b in zip(_leaves(state), _leaves(template)):
        assert torch.equal(a, b)


def test_coexists_with_the_msgpack_state(tmp_path):
    """Both formats in one directory, each read back to the same
    parameters."""
    tc = TrainConfig(learning_rate=3e-3)
    state = _stepped(tc)
    ckpt.save_train_state(str(tmp_path), state.params,
                          *loop._adam_moments(state), state.step)
    ckpt.save_train_state_orbax(str(tmp_path), state)
    params = ckpt.load_train_state(str(tmp_path))[0]
    template = ckpt.load_train_state_orbax(
        str(tmp_path), loop.create_state(CFG, tc, seed=4, device="cpu"))
    for a, b, c in zip(tree_leaves(state.params), tree_leaves(params),
                       tree_leaves(template.params)):
        assert torch.equal(a.detach(), b) and torch.equal(b, c.detach())
