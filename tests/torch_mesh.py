"""Two-rank runs of the port's mesh code on the CPU, beside the JAX
package's sharded functions on two virtual CPU devices.

A test file lists its cases (:class:`Case`: a function name, numpy
inputs, keywords, a mesh shape, the weights' seed) and calls :func:`run`
once, in a module-scoped fixture.  That writes the cases to a pickle and
starts, all at once,

* the port: ``WORLD`` processes of this script (``rank`` mode), joined in
  one gloo world (``torch.distributed``; rank 0's store binds a free
  port itself and writes it for the others), each on one thread, every
  case run on every rank; rank 0 writes the results, and every rank its
  own ``extras``;
* the reference: one process of this script (``jax`` mode) that runs the
  JAX package's functions on a fresh two-device CPU backend (its
  collectives stay out of the pytest process).

:func:`run` waits for all of them under one timeout (:data:`TIMEOUT`): a
hung rendezvous kills every process and fails the file instead of the
suite.  Both sides build the weights from the same JAX ``init_params``
seed (the port through ``from_jax_params``) and the batches from the
same numpy arrays.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
import subprocess
import sys
import time
from typing import Any, Dict, Tuple

import numpy as np

WORLD = 2
#: seconds for the two ranks and the reference together
TIMEOUT = 240
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SMALL = dict(h_dim=16, e_dim=16, msg_dim=8, mlp_hidden=(8, 8), T=2)


@dataclasses.dataclass
class Case:
    """One call on both sides.  ``fn``: a key of the dispatch tables
    below; ``args``: positional numpy inputs (x, q0, xyz, mask or the
    function's own); ``kw``: keywords (numpy arrays allowed); ``mesh``:
    (n_data, n_atoms); ``cfg``: EPNNConfig fields; ``seed`` and ``bias``:
    ``init_params``' key and the shift added to every bias (0: none);
    ``jax``: whether the reference runs it."""

    fn: str
    args: tuple = ()
    kw: dict = dataclasses.field(default_factory=dict)
    mesh: Tuple[int, int] = (1, 2)
    cfg: dict = dataclasses.field(default_factory=lambda: dict(SMALL))
    seed: int = 0
    bias: float = 0.2
    jax: bool = True


def jax_params(cfg: dict, seed: int, bias: float):
    """The numpy weight tree both sides start from."""
    import jax

    from epnn_tpu.models import EPNNConfig, init_params

    params = init_params(EPNNConfig(**cfg), jax.random.key(seed))
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a + bias if a.ndim == 1 else a), params)


def run(cases: Dict[str, Case], tmp_dir: str, timeout: float = TIMEOUT):
    """Run ``cases`` on the two ranks and the reference; returns
    ``(port, ref, extras)``: {name: result} from rank 0 and the
    reference, and per rank {name: extra}.  Raises with every process's
    output when one fails or the timeout passes."""
    params = {}
    for c in cases.values():
        key = (tuple(sorted((k, tuple(v) if isinstance(v, list) else v)
                            for k, v in c.cfg.items())), c.seed, c.bias)
        if key not in params:
            params[key] = jax_params(c.cfg, c.seed, c.bias)
    spec = os.path.join(tmp_dir, "cases.pkl")
    with open(spec, "wb") as f:
        pickle.dump({"cases": cases, "params": params}, f)
    env = dict(os.environ, EPNN_PLATFORM="cpu", OMP_NUM_THREADS="1",
               WORLD_SIZE=str(WORLD), PYTHONPATH=ROOT + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    procs = []
    for r in range(WORLD):
        procs.append(subprocess.Popen(
            [sys.executable, __file__, "rank", spec, tmp_dir], cwd=ROOT,
            env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    jax_env = dict(env, XLA_FLAGS="--xla_force_host_platform_device_count=2"
                   " --xla_backend_optimization_level=2")
    jax_env.pop("JAX_COMPILATION_CACHE_DIR", None)
    if any(c.jax for c in cases.values()):
        procs.append(subprocess.Popen(
            [sys.executable, __file__, "jax", spec, tmp_dir], cwd=ROOT,
            env=jax_env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    deadline = time.monotonic() + timeout
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=max(1.0,
                                               deadline - time.monotonic()))
            outs.append(out)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        texts = [p.communicate()[0] for p in procs]
        raise AssertionError(f"mesh run timed out after {timeout} s:\n"
                             + "\n----\n".join(t[-3000:] for t in texts))
    bad = [(i, p.returncode, o) for i, (p, o) in enumerate(zip(procs, outs))
           if p.returncode != 0]
    if bad:
        raise AssertionError("mesh run failed:\n" + "\n----\n".join(
            f"process {i} rc={rc}:\n{o[-4000:]}" for i, rc, o in bad))

    def load(name):
        path = os.path.join(tmp_dir, name)
        if not os.path.exists(path):
            return {}
        with open(path, "rb") as f:
            return pickle.load(f)

    return (load("port.pkl"), load("jax.pkl"),
            [load(f"extras{r}.pkl") for r in range(WORLD)])


# ---------------------------------------------------------------------------
# the port's side (rank mode)
# ---------------------------------------------------------------------------

def _port_cfg(fields):
    from epnn_tpu_torch.models import EPNNConfig

    return EPNNConfig(**fields)


def _molecules(mod, spec):
    """The case's molecules as ``mod``'s Molecule (port or JAX)."""
    return [mod.Molecule(name=m["name"], symbols=list(m["symbols"]),
                         xyz=np.asarray(m["xyz"], np.float32),
                         total_charge=float(m["charge"]))
            for m in spec]


def _predictor_run(pred, batch, case_kw):
    """``predict_batch`` on ``batch``, then once more after each drift in
    ``drifts`` (added to the coordinates in place); the charges of every
    call, the skin rebuilds and the near-window widths chosen."""
    outs = [np.asarray(pred.predict_batch(batch))]
    for drift in case_kw.get("drifts", ()):
        batch.xyz += np.asarray(drift, np.float32)
        outs.append(np.asarray(pred.predict_batch(batch)))
    widths = sorted(w for d in pred._winw_cache.values() for w in d.values())
    return dict(q=outs, skin_rebuilds=pred.skin_rebuilds, widths=widths)


def _port_case(case: Case, params, mesh_of):
    import torch

    from epnn_tpu_torch.io.checkpoint import from_jax_params
    from epnn_tpu_torch.ops import fuse_params
    from epnn_tpu_torch.parallel import atom_shard, ring_shard

    cfg = _port_cfg(case.cfg)
    tree = from_jax_params(params, cfg)
    kw = {k: (tuple(torch.from_numpy(np.asarray(a)) for a in v)
              if k == "neighbors" and v is not None else v)
          for k, v in case.kw.items()}
    if case.fn == "predictor":
        return _port_predictor(case, tree, cfg, mesh_of)
    if case.fn in PORT_PROBES:
        return PORT_PROBES[case.fn](case, tree, cfg, mesh_of(case.mesh))
    fused = fuse_params(tree, cfg)
    args = tuple(torch.from_numpy(np.asarray(a)) for a in case.args)
    if case.fn == "blocked":
        from epnn_tpu_torch.ops import forward_blocked

        return forward_blocked(fused, *args, cfg, **kw).numpy()
    fn = {"atom_nbr": atom_shard.forward_atom_sharded_nbr_batch,
          "atom_dense": atom_shard.forward_atom_sharded_batch,
          "atom_single": atom_shard.forward_atom_sharded,
          "ring_nbr": ring_shard.forward_ring_sharded_nbr_batch,
          "ring_dense": ring_shard.forward_ring_sharded}[case.fn]
    return fn(fused, *args, cfg, mesh_of(case.mesh), **kw).numpy()


def _port_predictor(case: Case, tree, cfg, mesh_of):
    from epnn_tpu_torch import infer
    from epnn_tpu_torch.data import pad_molecules
    from epnn_tpu_torch.data import xyz as xyz_mod
    from epnn_tpu_torch.elements import table_for_n_elems

    kw = dict(case.kw)
    saved = {name: getattr(infer, name) for name in kw.get("consts", {})}
    for name, v in kw.get("consts", {}).items():
        setattr(infer, name, v)
    try:
        batch = pad_molecules(_molecules(xyz_mod, kw["mols"]),
                              table_for_n_elems(cfg.n_elems),
                              pad_to=kw.get("pad_to"))
        mesh = None if kw.get("mesh_off") else mesh_of(case.mesh)
        pred = infer.Predictor(tree, cfg, mesh=mesh, device="cpu",
                               **kw.get("pred", {}))
        import warnings

        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            out = _predictor_run(pred, batch, kw)
        out["warnings"] = [str(w.message) for w in rec]
        return out
    finally:
        for name, v in saved.items():
            setattr(infer, name, v)


def _pass_probe(case: Case, tree, cfg, mesh):
    """The pass round's pair terms across ranks: a pass round's [pi | pj]
    of the case's graph (seeded h), one slot per disjoint near pair (the
    ``near_pass_rowsum`` probe weights), each rank's rows through the
    kernel wrapper as the atom-sharded forward calls it (``'atom'``), or
    its block against each circulating block as the ring forward does
    (``'ring'``).  Returns this rank's rows' outputs (its extra) — the
    test holds each cross-rank pair's two rows to exact negation."""
    import torch

    from epnn_tpu_torch.ops import fuse_params, kernels
    from epnn_tpu_torch.ops.fused import _flat, rbf_and_gate
    from epnn_tpu_torch.parallel import _collectives as C
    from epnn_tpu_torch.parallel.sharding import ATOM_AXIS

    x, xyz, mask, h, idx, nbr_mask, d2, gh = (torch.from_numpy(np.asarray(a))
                                              for a in case.args)
    fused = fuse_params(tree, cfg)
    w = fused.passes[0]
    a = torch.cat([x, h, torch.zeros_like(mask)[:, None]], dim=-1)
    rs = torch.cat([a @ w.w1_i + w.b1, a @ w.w1_j], dim=-1).contiguous()
    rbf, _ = rbf_and_gate(d2, nbr_mask, cfg)
    rbf = rbf.reshape(-1, cfg.e_dim)
    group = mesh.get_group(ATOM_AXIS)
    n, k = idx.shape
    d = C.size(group)
    r = n // d
    r0 = C.index(group) * r
    rows = slice(r0, r0 + r)
    mids = _flat(w.mids)
    if case.kw["mode"] == "atom":
        out = kernels.near_pass_rowsum(
            rs[rows].contiguous(), rs[idx[rows].reshape(-1)],
            rbf[r0 * k:(r0 + r) * k].contiguous(), gh[rows].contiguous(),
            w.w1_e, *mids)
        return out.numpy()
    # ring: this block against each block passing by, the slots of the
    # passing block only (block-local indices)
    out = torch.zeros((r, rs.shape[1] // 2))
    blk = (rs[rows].contiguous(),)
    for step in range(d):
        start_j = (C.index(group) - step) % d * r
        local = (idx[rows] >= start_j) & (idx[rows] < start_j + r)
        gh_s = torch.where(local, gh[rows], 0.0).contiguous()
        idx_s = torch.where(local, idx[rows] - start_j, 0)
        out = out + kernels.near_pass_rowsum(
            rs[rows].contiguous(), blk[0][idx_s.reshape(-1)],
            rbf[r0 * k:(r0 + r) * k].contiguous(), gh_s, w.w1_e, *mids)
        blk = C.ppermute(blk, group)
    return out.numpy()


def _kmeans(case: Case, tree, cfg, mesh):
    """``weighted_kmeans_sharded`` on this rank's block of the case's rows
    (its result the same on every rank)."""
    import torch

    from epnn_tpu_torch.ops.cluster import weighted_kmeans_sharded
    from epnn_tpu_torch.parallel import _collectives as C
    from epnn_tpu_torch.parallel.sharding import ATOM_AXIS

    rows, w = (torch.from_numpy(np.asarray(a)) for a in case.args)
    group = mesh.get_group(ATOM_AXIS)
    nd = rows.shape[0] // C.size(group)
    blk = slice(C.index(group) * nd, (C.index(group) + 1) * nd)
    axis = mesh[ATOM_AXIS] if case.kw.get("submesh") else group
    out = [weighted_kmeans_sharded(rows[blk], w[blk], case.kw["c"], axis,
                                   iters=case.kw.get("iters", 8))
           for _ in range(2)]
    same = all(torch.equal(a, b) for a, b in zip(*out))
    return tuple(t.numpy() for t in out[0]) + (same,)


def _batch_args(case: Case, tree, cfg, mesh):
    """``shard_batch_args`` on a (2, 1) mesh: this data coordinate's rows,
    and the error for a batch the axis does not divide."""
    from epnn_tpu_torch.parallel import shard_batch_args

    (got,) = shard_batch_args((np.arange(12.0).reshape(4, 3),), mesh)
    try:
        shard_batch_args((np.zeros((3, 4)),), mesh)
        err = None
    except ValueError as e:
        err = str(e)
    return got.numpy(), err


def _tree_np(tree):
    """A parameter tree's leaves as numpy, in its nesting."""
    return {k: _tree_np(v) if isinstance(v, dict)
            else v.detach().cpu().numpy().copy() for k, v in tree.items()}


def _train(case: Case, tree, cfg, mesh):
    """``steps`` train steps on the case's batch (``args``: x, q0, xyz,
    mask, y, weight) from the case's weights, Adam at ``lr`` (the
    trainer's optimizer): ``mode`` 'atom' / 'ring' / 'dense' through
    ``make_sharded_train_step`` (``k``: neighbor_k; ``step``: its
    keywords; ``neighbors``: the batch's tables), 'dp' / 'dp_fused'
    through ``data_parallel_train_step`` (the trainer's data-parallel
    step, dense or blocked).  Returns the losses, the first step's
    gradients and parameters, the last parameters flat, the eval twin's
    loss and metric sums at the start (``make_sharded_eval_step`` or
    ``data_parallel_eval_step``), and the one-device step's loss and
    gradients on the same batch
    (``train_step`` or ``train_step_fused``, the same keywords; its
    neighbor_k ``ref_k`` where the ring's block bound ``k`` is smaller)."""
    import torch

    from epnn_tpu_torch.models import tree_leaves
    from epnn_tpu_torch.parallel import (make_sharded_eval_step,
                                         make_sharded_train_step)
    from epnn_tpu_torch.train import TrainConfig, loop

    kw = case.kw
    args = tuple(torch.from_numpy(np.asarray(a)) for a in case.args)
    nbrs = kw.get("neighbors")
    nbrs = None if nbrs is None else tuple(torch.from_numpy(np.asarray(a))
                                           for a in nbrs)
    mode, k, step_kw = kw["mode"], kw.get("k"), dict(kw.get("step", {}))
    tc = TrainConfig(learning_rate=kw.get("lr", 3e-3))
    eval_kw = {kk: v for kk, v in step_kw.items()
               if kk in ("uniform_q0", "near_row_chunk", "near_window")}

    def fresh():
        return loop.create_state(cfg, tc, device="cpu", params=tree)

    if mode in ("dp", "dp_fused"):
        def step(st):
            return loop.data_parallel_train_step(
                st, cfg, "masked_mse", None, mesh, *args, neighbor_k=k,
                block=8, neighbors=nbrs, **step_kw)

        def evaluate(params):
            return loop.data_parallel_eval_step(
                params, cfg, "masked_mse", mesh, *args, neighbor_k=k,
                block=8, neighbors=nbrs, **eval_kw)
    else:
        shard_mode = "ring" if mode == "ring" else "atom"
        sharded = make_sharded_train_step(
            cfg, None, mesh, neighbor_k=k, shard_mode=shard_mode, **step_kw)
        sharded_eval = make_sharded_eval_step(
            cfg, mesh, neighbor_k=k, shard_mode=shard_mode, **eval_kw)

        def step(st):
            return sharded(st, *args, neighbors=nbrs)

        def evaluate(params):
            return sharded_eval(params, *args, neighbors=nbrs)

    state = fresh()
    eval_loss, _, eval_mets = evaluate(state.params)
    losses, grads1, params1 = [], None, None
    for i in range(kw.get("steps", 5)):
        _, loss, _, _ = step(state)
        losses.append(float(loss))
        if i == 0:
            grads1 = [p.grad.detach().clone().numpy()
                      for p in tree_leaves(state.params)]
            params1 = _tree_np(state.params)
    final = np.concatenate([p.detach().numpy().reshape(-1)
                            for p in tree_leaves(state.params)])
    ref = fresh()
    one_kw = {kk: v for kk, v in step_kw.items() if kk != "remat"}
    if k is None:
        _, ref_loss, _, _ = loop.train_step(ref, cfg, "masked_mse", None,
                                            *args)
    else:
        _, ref_loss, _, _ = loop.train_step_fused(
            ref, cfg, "masked_mse", None, 8, kw.get("ref_k", k), *args,
            remat=False,
            neighbors=nbrs, **one_kw)
    return dict(losses=losses, grads1=grads1, params1=params1, final=final,
                eval_loss=float(eval_loss), eval_mets=eval_mets.numpy(),
                clustered=bool(step_kw.get("far_cluster")),
                ref_loss=float(ref_loss),
                ref_grads=[p.grad.detach().clone().numpy()
                           for p in tree_leaves(ref.params)])


def _mesh_molecules(spec):
    """The case's labelled molecules (the port's Molecule)."""
    from epnn_tpu_torch.data import xyz as xyz_mod

    mols = _molecules(xyz_mod, spec)
    for m, s in zip(mols, spec):
        m.labels = np.asarray(s["labels"], np.float32)
    return mols


def _trainer(case: Case, tree, cfg, mesh):
    """``train(mesh=...)`` on the case's molecules (``tc``: TrainConfig
    fields), the atom-sharded step builder spied: its steps' calls, the
    history and the last parameters (flat)."""
    from epnn_tpu_torch.models import tree_leaves
    from epnn_tpu_torch.parallel import atom_shard
    from epnn_tpu_torch.train import TrainConfig, train

    calls = {"sharded": 0, "built": 0}
    orig = atom_shard.make_sharded_train_step

    def spy(*a, **kw):
        calls["built"] += 1
        step = orig(*a, **kw)

        def wrapped(*sa, **skw):
            calls["sharded"] += 1
            return step(*sa, **skw)

        return wrapped

    atom_shard.make_sharded_train_step = spy
    try:
        res = train(_mesh_molecules(case.kw["mols"]), cfg,
                    TrainConfig(**case.kw["tc"]), mesh=mesh, progress=False)
    finally:
        atom_shard.make_sharded_train_step = orig
    return dict(calls=calls, history=res.history,
                final=np.concatenate([p.detach().numpy().reshape(-1)
                                      for p in tree_leaves(res.state.params)]))


def _cli_train(case: Case, tree, cfg, mesh):
    """``python -m epnn_tpu_torch train ... <flag>`` in process on every
    rank of the world (``flag``: --data-parallel or --multihost), every
    rank reading its own copy of the case's molecules and naming the same
    output directory.  Returns what the rank printed."""
    import contextlib
    import io

    import torch.distributed as dist

    from epnn_tpu_torch import cli
    from epnn_tpu_torch.testing import write_xyz

    data = os.path.join(case.kw["dir"], f"data{dist.get_rank()}")
    for m in _mesh_molecules(case.kw["mols"]):
        write_xyz(data, m)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        cli.main(["train", "--data", data, "--out", case.kw["out"],
                  "--epochs", "2", "--batch-size", "4",
                  *case.kw["argv"]])
    dist.barrier()
    return out.getvalue()


def _flops(case: Case, tree, cfg, mesh):
    """The products of one atom-sharded forward on this rank and of the
    one-device forward of the same batch (``utils.timing.count_flops``;
    the kernels count through their operators' formulas)."""
    import torch

    from epnn_tpu_torch.ops import forward_blocked, fuse_params
    from epnn_tpu_torch.parallel import atom_shard
    from epnn_tpu_torch.utils.timing import count_flops

    fused = fuse_params(tree, cfg)
    args = tuple(torch.from_numpy(np.asarray(a)) for a in case.args)
    k = case.kw["k"]
    with torch.no_grad():
        rank = count_flops(atom_shard.forward_atom_sharded_nbr_batch, fused,
                           *args, cfg, mesh, k=k)
        one = count_flops(forward_blocked, fused, *args, cfg, neighbor_k=k)
    return dict(rank=rank, one=one)


def _dcp(case: Case, tree, cfg, mesh):
    """The sharding-aware train-state format on the mesh: one atom-sharded
    step from the case's weights, then every rank saves the state together
    (``io.checkpoint.save_train_state_orbax`` into the case's shared
    ``dir``) and loads it into a fresh template.  Returns whether every
    leaf came back bit for bit, the checkpoint's files and the rank's
    parameters flat."""
    import torch
    import torch.distributed as dist

    from epnn_tpu_torch.io import checkpoint as ckpt
    from epnn_tpu_torch.models import tree_leaves as leaves
    from epnn_tpu_torch.parallel import make_sharded_train_step
    from epnn_tpu_torch.train import TrainConfig, loop

    args = tuple(torch.from_numpy(np.asarray(a)) for a in case.args)
    tc = TrainConfig(learning_rate=3e-3)
    state = loop.create_state(cfg, tc, device="cpu", params=tree)
    make_sharded_train_step(cfg, None, mesh, neighbor_k=case.kw["k"],
                            remat=False)(state, *args)
    ckpt.save_train_state_orbax(case.kw["dir"], state)
    dist.barrier()
    template = ckpt.load_train_state_orbax(
        case.kw["dir"], loop.create_state(cfg, tc, seed=5, device="cpu"))

    def flat(st):
        m = loop._adam_moments(st)
        return [t.detach() for t in leaves(st.params) + leaves(m[0])
                + leaves(m[1])] + [torch.tensor(st.step),
                                   torch.tensor(st.opt.count)]

    same = all(torch.equal(a, b) for a, b in zip(flat(state),
                                                 flat(template)))
    files = sorted(os.listdir(os.path.join(case.kw["dir"], ckpt.DCP_DIR)))
    return dict(same=same, files=files, final=np.concatenate(
        [t.detach().numpy().reshape(-1) for t in leaves(state.params)]))


PORT_PROBES = {"pass_probe": _pass_probe, "kmeans": _kmeans,
               "batch_args": _batch_args, "train": _train,
               "trainer": _trainer, "cli_train": _cli_train,
               "flops": _flops, "dcp": _dcp}


def _join_world(rank: int, tmp_dir: str) -> None:
    """The gloo world of the ranks: rank 0's TCP store binds a free port
    (no window in which another process can take it) and writes it to
    ``tmp_dir``; the other ranks read it and connect."""
    import datetime

    import torch.distributed as dist

    path = os.path.join(tmp_dir, "store_port")
    timeout = datetime.timedelta(seconds=120)
    if rank == 0:
        store = dist.TCPStore("localhost", 0, WORLD, is_master=True,
                              timeout=timeout, wait_for_workers=False)
        with open(path + ".tmp", "w") as f:
            f.write(str(store.port))
        os.replace(path + ".tmp", path)
    else:
        deadline = time.monotonic() + 120
        while not os.path.exists(path):
            if time.monotonic() > deadline:
                raise TimeoutError("rank 0 wrote no store port")
            time.sleep(0.05)
        with open(path) as f:
            store = dist.TCPStore("localhost", int(f.read()), WORLD,
                                  is_master=False, timeout=timeout)
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=WORLD, timeout=timeout)


def rank_main(spec: str, tmp_dir: str) -> None:
    import torch

    torch.set_num_threads(1)
    from epnn_tpu_torch.parallel import make_mesh

    with open(spec, "rb") as f:
        data = pickle.load(f)
    rank = int(os.environ["RANK"])
    _join_world(rank, tmp_dir)
    meshes = {}

    def mesh_of(shape):
        if shape not in meshes:
            meshes[shape] = make_mesh(*shape, device_type="cpu")
        return meshes[shape]

    results, extras = {}, {}
    for name, case in data["cases"].items():
        params = data["params"][(tuple(sorted(
            (k, tuple(v) if isinstance(v, list) else v)
            for k, v in case.cfg.items())), case.seed, case.bias)]
        t0 = time.perf_counter()
        try:
            out = _port_case(case, params, mesh_of)
        except Exception as e:  # recorded per case: the test names it
            import traceback

            out = ("error", f"{type(e).__name__}: {e}",
                   traceback.format_exc())
        if case.fn in PORT_PROBES:
            extras[name] = out
        results[name] = out
        print(f"rank {rank} {name} {time.perf_counter() - t0:.2f} s",
              flush=True)
    with open(os.path.join(tmp_dir, f"extras{rank}.pkl"), "wb") as f:
        pickle.dump(extras, f)
    if rank == 0:
        with open(os.path.join(tmp_dir, "port.pkl"), "wb") as f:
            pickle.dump(results, f)
    import torch.distributed as dist

    dist.barrier()
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the reference's side (jax mode)
# ---------------------------------------------------------------------------

def _jax_case(case: Case, params, mesh_of):
    from epnn_tpu.models import EPNNConfig
    from epnn_tpu.ops import fuse_params
    from epnn_tpu.parallel import atom_shard, ring_shard

    cfg = EPNNConfig(**case.cfg)
    kw = dict(case.kw)
    if case.fn == "predictor":
        return _jax_predictor(case, params, cfg, mesh_of)
    if case.fn == "kmeans":
        return _jax_kmeans(case, mesh_of(case.mesh))
    if case.fn == "train":
        return _jax_train(case, params, cfg, mesh_of(case.mesh))
    fused = fuse_params(params, cfg)
    if case.fn == "blocked":
        from epnn_tpu.ops import forward_blocked

        return np.asarray(forward_blocked(fused, *case.args, cfg, **kw))
    fn = {"atom_nbr": atom_shard.forward_atom_sharded_nbr_batch,
          "atom_dense": atom_shard.forward_atom_sharded_batch,
          "atom_single": atom_shard.forward_atom_sharded,
          "ring_nbr": ring_shard.forward_ring_sharded_nbr_batch,
          "ring_dense": ring_shard.forward_ring_sharded}[case.fn]
    return np.asarray(fn(fused, *case.args, cfg, mesh_of(case.mesh), **kw))


def _jax_predictor(case: Case, params, cfg, mesh_of):
    import epnn_tpu.infer as infer
    from epnn_tpu.data import xyz as xyz_mod
    from epnn_tpu.data.dataset import pad_molecules
    from epnn_tpu.elements import table_for_n_elems

    kw = dict(case.kw)
    saved = {name: getattr(infer, name) for name in kw.get("consts", {})}
    for name, v in kw.get("consts", {}).items():
        setattr(infer, name, v)
    try:
        batch = pad_molecules(_molecules(xyz_mod, kw["mols"]),
                              table_for_n_elems(cfg.n_elems),
                              pad_to=kw.get("pad_to"))
        mesh = None if kw.get("mesh_off") else mesh_of(case.mesh)
        pred = infer.Predictor(params=params, cfg=cfg, mesh=mesh,
                               **kw.get("pred", {}))
        return _predictor_run(pred, batch, kw)
    finally:
        for name, v in saved.items():
            setattr(infer, name, v)


def _jax_kmeans(case: Case, mesh):
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    from epnn_tpu.ops.cluster import weighted_kmeans_sharded

    import jax

    rows, w = case.args
    fit = jax.jit(shard_map(
        lambda r, ww: weighted_kmeans_sharded(r, ww, case.kw["c"], "atoms",
                                              iters=case.kw.get("iters", 8)),
        mesh=mesh, in_specs=(P("atoms"), P("atoms")), out_specs=P(),
        check_vma=False))
    return tuple(np.asarray(t) for t in fit(rows, w))


def _jax_train(case: Case, params, cfg, mesh):
    """The JAX package's side of :func:`_train`: its
    ``make_sharded_train_step`` ('atom' / 'ring' / 'dense'), or its
    ``train_step`` on ``shard_batch_args`` ('dp'), from the same weights
    with its trainer's optimizer.  Returns the losses and the first
    step's parameters."""
    import jax
    import jax.numpy as jnp

    from epnn_tpu.parallel import shard_batch_args, shard_state
    from epnn_tpu.parallel.atom_shard import make_sharded_train_step
    from epnn_tpu.train import TrainConfig, make_optimizer
    from epnn_tpu.train.loop import TrainState, train_step

    kw = case.kw
    tc = TrainConfig(learning_rate=kw.get("lr", 3e-3))
    opt = make_optimizer(tc)
    tree = jax.tree_util.tree_map(jnp.asarray, params)
    state = TrainState(params=tree, opt_state=opt.init(tree),
                       step=jnp.zeros((), jnp.int32))
    mode, k = kw["mode"], kw.get("k")
    if mode == "dp":
        from epnn_tpu.models import EPNN

        state = shard_state(state, mesh)
        args = shard_batch_args(case.args, mesh)
        model = EPNN(cfg)

        def step(st):
            return train_step(st, model, "masked_mse", opt, *args)
    else:
        nbrs = kw.get("neighbors")
        sharded = make_sharded_train_step(
            cfg, opt, mesh, neighbor_k=k,
            shard_mode="ring" if mode == "ring" else "atom",
            **kw.get("step", {}))

        def step(st):
            if nbrs is None:
                return sharded(st, *case.args)
            return sharded(st, *case.args, neighbors=nbrs)

    losses, params1 = [], None
    for i in range(kw.get("steps", 5)):
        state, loss, _, _ = step(state)
        losses.append(float(loss))
        if i == 0:
            params1 = jax.tree_util.tree_map(np.asarray, state.params)
    return dict(losses=losses, params1=params1["params"])


def jax_main(spec: str, tmp_dir: str) -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    from epnn_tpu.parallel import make_mesh

    with open(spec, "rb") as f:
        data = pickle.load(f)
    meshes = {}

    def mesh_of(shape):
        if shape not in meshes:
            meshes[shape] = make_mesh(*shape)
        return meshes[shape]

    results = {}
    for name, case in data["cases"].items():
        if not case.jax:
            continue
        params = data["params"][(tuple(sorted(
            (k, tuple(v) if isinstance(v, list) else v)
            for k, v in case.cfg.items())), case.seed, case.bias)]
        t0 = time.perf_counter()
        results[name] = _jax_case(case, params, mesh_of)
        print(f"jax {name} {time.perf_counter() - t0:.2f} s", flush=True)
    with open(os.path.join(tmp_dir, "jax.pkl"), "wb") as f:
        pickle.dump(results, f)


# ---------------------------------------------------------------------------
# inputs shared by the test files
# ---------------------------------------------------------------------------

def system(seed=0, b=2, n=48, pad=5, span=8.0):
    g = np.random.default_rng(seed)
    x = g.normal(size=(b, n, 10)).astype(np.float32)
    xyz = g.uniform(0, span, size=(b, n, 3)).astype(np.float32)
    mask = np.ones((b, n), np.float32)
    if pad:
        mask[:, -pad:] = 0.0
    q0 = np.full((b, n), 1.0 / n, np.float32)
    return x, q0, xyz, mask


def contract_batch(seed=0, n_mols=2, natoms=40, pad_to=48):
    """``TestShardedUniformQ0Collapse``'s batch: [Z, onehot] features and
    uniform q0, the round-1 collapse contract."""
    from epnn_tpu.data.dataset import pad_molecules, uniform_q0_contract
    from epnn_tpu.data.xyz import Molecule
    from epnn_tpu.elements import table_for_n_elems

    g = np.random.default_rng(seed)
    mols = [Molecule(name=f"m{i}",
                     symbols=list(g.choice(["H", "C", "N", "O", "S"],
                                           natoms)),
                     xyz=g.uniform(0, 8, (natoms, 3)).astype(np.float32),
                     total_charge=float(i - 1)) for i in range(n_mols)]
    b = pad_molecules(mols, table_for_n_elems(10), pad_to=pad_to)
    assert uniform_q0_contract(b.x, b.q0, b.node_mask)
    return (np.asarray(b.x), np.asarray(b.q0), np.asarray(b.xyz),
            np.asarray(b.node_mask))


def train_batch(seed=0, b=2, n=48):
    """:func:`system` with seeded labels (zero on padding) and unit
    sample weights: (x, q0, xyz, mask, y, weight)."""
    x, q0, xyz, mask = system(seed=seed, b=b, n=n)
    g = np.random.default_rng(seed + 100)
    y = (g.normal(0, 0.3, size=(b, n)) * mask).astype(np.float32)
    return (x, q0, xyz, mask, y, np.ones(b, np.float32))


def with_labels(arrays, seed):
    """(x, q0, xyz, mask) with seeded labels and unit weights added."""
    x, q0, xyz, mask = arrays
    g = np.random.default_rng(seed)
    y = (g.normal(0, 0.3, size=mask.shape) * mask).astype(np.float32)
    return (x, q0, xyz, mask, y, np.ones(mask.shape[0], np.float32))


def neighbor_k(xyz, mask, extra=2, cutoff=5.0):
    """The largest within-cutoff count of the batch's rows, plus
    ``extra`` (the JAX tests' ``k``)."""
    from epnn_tpu.ops.fused import max_neighbor_count

    return int(max(max_neighbor_count(xyz[i], mask[i], cutoff)
                   for i in range(xyz.shape[0]))) + extra


def labelled_molecules(seed, count, lo, hi, span):
    """Random C/H/O molecules (the specs :func:`_mesh_molecules` reads)
    with zero-sum labels."""
    g = np.random.default_rng(seed)
    out = []
    for i in range(count):
        n = int(g.integers(lo, hi))
        labels = g.normal(0, 0.2, size=n).astype(np.float32)
        labels -= labels.sum() / n
        out.append(dict(name=f"s{i}",
                        symbols=[str(s) for s in g.choice(["C", "H", "O"],
                                                          size=n)],
                        xyz=g.uniform(-span, span, (n, 3)).astype(np.float32),
                        charge=0.0, labels=labels))
    return out


def train_case(mode, args, k=None, mesh=(1, 2), jax=True, **kw):
    """A :func:`_train` case at Adam rate 3e-3."""
    return Case("train", args, dict(mode=mode, k=k, lr=3e-3, **kw),
                mesh=mesh, jax=jax)


def rel_fro(a, b) -> float:
    """‖a − b‖ / ‖b‖ (Frobenius)."""
    return float(np.linalg.norm(np.asarray(a) - np.asarray(b))
                 / max(float(np.linalg.norm(b)), 1e-30))


def tree_leaves(tree):
    """A nested dict's leaves in sorted key order."""
    return [leaf for k in sorted(tree) for leaf in (
        tree_leaves(tree[k]) if isinstance(tree[k], dict) else [tree[k]])]


def assert_trains_like_jax(port, ref, name):
    """JAX's bars on a :func:`_train` case: the first loss at rtol 1e-4 of
    JAX's sharded step, every leaf after one Adam step within 1e-3
    relative Frobenius of JAX's."""
    out = result(port, name)
    np.testing.assert_allclose(out["losses"][0], ref[name]["losses"][0],
                               rtol=1e-4)
    got, want = tree_leaves(out["params1"]), tree_leaves(ref[name]["params1"])
    assert len(got) == len(want)
    worst = max(rel_fro(a, b) for a, b in zip(got, want))
    assert worst <= 1e-3, (name, worst)


def assert_trains_like_one_device(port, extras, name):
    """A :func:`_train` case against the port's one-device step: the loss
    within 1e-5·(|loss| + 1) and each gradient leaf within 1e-3 relative
    Frobenius ([train a]'s bar), the loss falling, every rank ending
    with the same parameters bit for bit, and the eval twin's loss the
    first step's where that step is exact."""
    out = result(port, name)
    losses, ref_loss = out["losses"], out["ref_loss"]
    assert abs(losses[0] - ref_loss) <= 1e-5 * (abs(ref_loss) + 1.0)
    assert np.all(np.isfinite(losses)) and losses[-1] < losses[0], losses
    assert len(out["grads1"]) == len(out["ref_grads"])
    for g, r in zip(out["grads1"], out["ref_grads"]):
        assert np.all(np.isfinite(g)) and rel_fro(g, r) <= 1e-3, \
            (name, rel_fro(g, r))
    finals = [extras[r][name]["final"] for r in range(WORLD)]
    assert all(np.array_equal(finals[0], f) for f in finals[1:])
    # the eval twin: the first step's forward without a graph (exact: a
    # clustered step's forward is the approximation)
    assert np.all(np.isfinite(out["eval_mets"]))
    if not out["clustered"]:
        np.testing.assert_allclose(out["eval_loss"], losses[0], rtol=1e-6)


def line_system(seed=0, b=2, n=64):
    """Atoms along a line (a window narrower than N exists)."""
    g = np.random.default_rng(seed)
    x = g.normal(size=(b, n, 10)).astype(np.float32)
    xyz = np.zeros((b, n, 3), np.float32)
    xyz[:, :, 0] = np.arange(n) * 1.1
    xyz[:, :, 1] = g.uniform(0, 0.5, size=(b, n))
    mask = np.ones((b, n), np.float32)
    mask[:, -5:] = 0.0
    xyz *= mask[..., None]
    return x, np.full((b, n), 1.0 / n, np.float32), xyz, mask


def tables(xyz, mask, cutoff, k):
    """(idx, mask, d2) of every graph (the JAX package's top-k)."""
    from epnn_tpu.ops.fused import build_neighbors

    tabs = [np.stack(a) for a in zip(*(
        build_neighbors(xyz[i], mask[i], cutoff, k, with_d2=True)
        for i in range(xyz.shape[0])))]
    return tuple(np.asarray(a) for a in tabs)


def window_case():
    from epnn_tpu.ops.fused import max_neighbor_count, neighbor_window_width

    x, q0, xyz, mask = line_system()
    k = int(max(max_neighbor_count(xyz[i], mask[i], 5.0)
                for i in range(2))) + 2
    nbrs = tables(xyz, mask, 5.0, k)
    r = xyz.shape[1] // 2
    win = max(int(neighbor_window_width(nbrs[0][:, d0:d0 + r],
                                        nbrs[1][:, d0:d0 + r], 8, align=8))
              for d0 in range(0, xyz.shape[1], r))
    assert 0 < win < xyz.shape[1]
    return (x, q0, xyz, mask), k, nbrs, win


def probe_case():
    """A 48-atom graph's pass-round inputs and the disjoint-pair probe
    weights (``testing.disjoint_pair_gh``), with at least one pair across
    the two ranks' row blocks."""
    from epnn_tpu.ops.fused import build_neighbors
    from epnn_tpu_torch.testing import disjoint_pair_gh

    x, _, xyz, mask = system(seed=3, b=1, pad=0, span=6.0)
    g = np.random.default_rng(4)
    h = g.normal(size=(48, SMALL["h_dim"])).astype(np.float32)
    idx, nmask, d2 = (np.asarray(a) for a in build_neighbors(
        xyz[0], mask[0], 5.0, 24, with_d2=True))
    gh, pairs = disjoint_pair_gh(idx, nmask)
    cross = pairs[(pairs[:, 0] < 24) != (pairs[:, 1] < 24)]
    assert len(cross) >= 3, len(cross)
    return (x[0], xyz[0], mask[0], h, idx.astype(np.int64), nmask, d2,
            gh), cross


# ---------------------------------------------------------------------------
# checks shared by the test files
# ---------------------------------------------------------------------------

def result(res: Dict[str, Any], name: str):
    """A case's result, failing with the rank's traceback where it raised."""
    out = res[name]
    if isinstance(out, tuple) and len(out) == 3 and out[0] == "error":
        raise AssertionError(f"{name} raised on the port's rank 0:\n{out[2]}")
    return out


def assert_close(out, ref, bar: float = 1e-5, what: str = "") -> float:
    """max|out − ref| within ``bar``·(max|ref| + 1): the JAX suite's bar
    (``tests/test_fused.py:105``)."""
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape, (what, out.shape, ref.shape)
    err = float(np.abs(out - ref).max())
    tol = bar * (float(np.abs(ref).max()) + 1.0)
    assert np.all(np.isfinite(out)) and err <= tol, (what, err, tol)
    return err


def assert_conserves(q, q0, mask, atol: float = 2e-5) -> None:
    """Σq per graph equal to Σq0 (the net charge) to float32 grade: within
    ``atol`` or 2e-6·(Σ|q| + 1), whichever is larger (the JAX suite's
    bars, ``tests/test_sharding.py:66``, ``:180``)."""
    q = np.asarray(q) * mask
    err = np.abs(q.sum(-1) - (np.asarray(q0) * mask).sum(-1))
    tol = np.maximum(atol, 2e-6 * (np.abs(q).sum(-1) + 1.0))
    assert np.all(err <= tol), (err, tol)


if __name__ == "__main__":
    mode, spec_path, out_dir = sys.argv[1:4]
    if mode == "rank":
        rank_main(spec_path, out_dir)
    else:
        jax_main(spec_path, out_dir)
