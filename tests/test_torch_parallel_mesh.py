"""The port's mesh surface on the CPU: ``epnn_tpu_torch.parallel``'s
meshes and process groups, ``Predictor(mesh=..., shard_mode=...)`` on two
gloo ranks against the JAX package's ``Predictor(mesh=...)`` on two
virtual CPU devices (the serving cases of ``tests/test_sharding.py``'s
``TestPredictorMesh``, ``TestRingNbrSharding``, ``TestShardedFarCluster``
and ``TestShardedNeighborReuse``), ``infer --atom-shard`` /
``--ring-shard`` under torchrun against the single-device CLI, the
signatures against JAX's, and the layout and idempotence cases of
``tests/test_multihost.py``.

Bars: charges within 1e-5·(max|q| + 1) of JAX's on the same mesh shape
(``tests/test_fused.py:105``), Σq the net charge to float32 grade; the
CLI's charges within the same bar of the single-device CLI's.  The
API-only cases run a world of one gloo process in the pytest process.
"""

import inspect
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

import torch_mesh as M
from torch_mesh import Case, assert_close, result

SMALL = M.SMALL
CFG10 = dict(SMALL, n_elems=10)


def mol(name, n, seed, span, charge=1.0, symbols=None, xyz=None):
    g = np.random.default_rng(seed)
    if symbols is None:
        symbols = list(g.choice(["H", "C", "N", "O"], n))
    if xyz is None:
        xyz = g.uniform(0, span, (n, 3)).astype(np.float32)
    return dict(name=name, symbols=list(symbols), xyz=xyz, charge=charge)


def line_mol():
    g = np.random.default_rng(13)
    xyz = np.zeros((64, 3), np.float32)
    xyz[:, 0] = g.permutation(64) * 1.1
    xyz[:, 1] = g.uniform(0, 0.5, 64)
    return mol("line", 64, 13, 0, charge=0.0,
               symbols=g.choice(["H", "C", "N", "O"], 64), xyz=xyz)


def drift(seed, shape, mask_n):
    g = np.random.default_rng(seed)
    d = (g.uniform(-1, 1, shape) * 0.05).astype(np.float32)
    d[:, mask_n:] = 0.0
    return d


def predictor(mols, pred=None, consts=None, mesh=(1, 2), pad_to=None,
              drifts=(), mesh_off=False, jax=True, cfg=None, bias=0.2,
              seed=0):
    return Case("predictor", kw=dict(
        mols=mols, pred=pred or {}, consts=consts or {}, pad_to=pad_to,
        drifts=drifts, mesh_off=mesh_off), mesh=mesh,
        cfg=dict(cfg or SMALL), bias=bias, seed=seed, jax=jax)


def cases():
    m21 = [mol("m", 21, 4, 8.0, symbols=["C"] * 21)]
    m40 = [mol("m", 40, 5, 8.0, symbols=["C"] * 40)]
    m40b = [mol("m", 40, 5, 7.0)]
    two30 = [mol(f"m{i}", 30, 11 + i, 7.0, charge=float(i - 1),
                 symbols=["C"] * 30) for i in range(2)]
    big = {"DENSE_MAX_ATOMS": 16}
    skin = [drift(5, (1, 40, 3), 40)]
    return {
        "plain21": predictor(m21, mesh_off=True, cfg=CFG10, bias=0.0),
        "atom21": predictor(m21, cfg=CFG10, bias=0.0),
        "ring21": predictor(m21, dict(shard_mode="ring"), cfg=CFG10,
                            bias=0.0),
        "plain40": predictor(m40, mesh_off=True, bias=0.0),
        "big_atom40": predictor(m40, consts=big, bias=0.0),
        "plain_two30": predictor(two30, dict(force_mode="blocked"),
                                 mesh_off=True, pad_to=32, seed=4,
                                 bias=0.0),
        "ring_two30": predictor(two30, dict(shard_mode="ring"), pad_to=32,
                                seed=4, bias=0.0),
        "ring_two30_data": predictor(two30, dict(shard_mode="ring"),
                                     mesh=(2, 1), pad_to=32, seed=4,
                                     bias=0.0),
        "atom_two30_data": predictor(two30, consts=big, mesh=(2, 1),
                                     pad_to=32, seed=4, bias=0.0),
        "atom_base": predictor(m40b, consts=big, pad_to=40, cfg=CFG10,
                               bias=0.3),
        "atom_reuse": predictor(m40b, dict(reuse_neighbors=True),
                                consts=big, pad_to=40, cfg=CFG10, bias=0.3),
        "atom_skin": predictor(m40b, dict(reuse_neighbors=True,
                                          neighbor_skin=0.5), consts=big,
                               pad_to=40, cfg=CFG10, bias=0.3, drifts=skin),
        "ring_base": predictor(m40b, dict(shard_mode="ring"), pad_to=40,
                               seed=2, bias=0.0),
        "ring_reuse": predictor(m40b, dict(shard_mode="ring",
                                           reuse_neighbors=True), pad_to=40,
                                seed=2, bias=0.0),
        "ring_skin": predictor(m40b, dict(shard_mode="ring",
                                          reuse_neighbors=True,
                                          neighbor_skin=0.5), pad_to=40,
                               seed=2, bias=0.0, drifts=skin),
        "window_off_base": predictor(m40b, dict(reuse_neighbors=True),
                                     consts=big, pad_to=40, seed=3),
        "window_off": predictor(m40b, dict(reuse_neighbors=True,
                                           near_row_chunk=8,
                                           spatial_sort="off"), consts=big,
                                pad_to=40, seed=3),
        "cold_window_base": predictor([line_mol()], dict(spatial_sort="off"),
                                      consts=dict(big,
                                                  HUGE_GRAPH_MIN_ATOMS=32),
                                      pad_to=64, seed=4, bias=0.0),
        "cold_window": predictor([line_mol()], dict(near_row_chunk=8),
                                 consts=dict(big, HUGE_GRAPH_MIN_ATOMS=32),
                                 pad_to=64, seed=4, bias=0.0),
        "cluster_atom": predictor(m40, dict(far_cluster=4), consts=big),
        "cluster_ring": predictor(m40, dict(far_cluster=4,
                                            shard_mode="ring")),
        "one_big40": predictor(m40, consts=big, mesh_off=True, bias=0.0,
                               jax=False),
        "one_cluster40": predictor(m40, dict(far_cluster=4), consts=big,
                                   mesh_off=True, jax=False),
        "cluster_dense": predictor(m40, dict(far_cluster=8),
                                   consts={"DENSE_MAX_ATOMS": 4096},
                                   jax=False),
        "batch_args": Case("batch_args", mesh=(2, 1), jax=False),
    }


CASES = cases()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return M.run(CASES, str(tmp_path_factory.mktemp("mesh")))


def q_of(res, name, call=0):
    return result(res, name)["q"][call]


#: the cases on ``TestPredictorMesh``'s and ``TestShardedFarCluster``'s
#: 40-atom all-carbon box, held to JAX at those tests' own bar between
#: paths, 1e-4: on this box the two packages' ONE-device forwards already
#: differ by 1.8e-5 to 4.0e-5 (max|q| 0.17; float32 summation order), so
#: the 1e-5 bar cannot tell the mesh apart there.  What the mesh adds is
#: held by ``test_mesh_adds_nothing_on_the_carbon_box``.
CARBON_BOX = {"big_atom40": 1e-4, "cluster_atom": 1e-4, "cluster_ring": 1e-4}


@pytest.mark.parametrize("name", [
    "atom21", "ring21", "big_atom40", "ring_two30", "ring_two30_data",
    "atom_two30_data", "atom_base", "atom_reuse", "atom_skin", "ring_base",
    "ring_reuse", "ring_skin", "window_off", "cold_window", "cluster_atom",
    "cluster_ring"])
def test_predictor_matches_jax_mesh(runs, name):
    port, ref, _ = runs
    out, want = result(port, name), ref[name]
    assert len(out["q"]) == len(want["q"])
    for call, (q, qj) in enumerate(zip(out["q"], want["q"])):
        assert_close(q, qj, bar=CARBON_BOX.get(name, 1e-5), what=(name, call))
    assert out["skin_rebuilds"] == want["skin_rebuilds"]


def test_mesh_adds_nothing_on_the_carbon_box(runs):
    """On the all-carbon box the atom-sharded neighbor split gives the
    port's one-device blocked charges bit for bit (the same kernels, top-k
    and, clustered, the same replicated fit); the ring sums its far field
    block by block and its fit's partial sums across ranks, so it is held
    at ``TestShardedFarCluster``'s ring-against-one-device bar, 1e-4."""
    port = runs[0]
    np.testing.assert_array_equal(q_of(port, "big_atom40"),
                                  q_of(port, "one_big40"))
    np.testing.assert_array_equal(q_of(port, "cluster_atom"),
                                  q_of(port, "one_cluster40"))
    assert_close(q_of(port, "cluster_ring"), q_of(port, "one_cluster40"),
                 bar=1e-4)


@pytest.mark.parametrize("sharded,plain,bar", [
    ("atom21", "plain21", 1e-5), ("ring21", "plain21", 1e-5),
    ("big_atom40", "plain40", 1e-4), ("ring_two30", "plain_two30", 1e-4),
    ("ring_two30_data", "plain_two30", 1e-4),
    ("atom_two30_data", "plain_two30", 1e-4)])
def test_predictor_matches_unsharded(runs, sharded, plain, bar):
    """``TestPredictorMesh``'s bars: the mesh against the one-device
    Predictor (dense against the neighbor split at 1e-4)."""
    port = runs[0]
    assert_close(q_of(port, sharded), q_of(port, plain), bar=bar)


def test_reuse_and_skin_match_cold(runs):
    """reuse_neighbors and the Verlet skin on both layouts: the cold
    call's charges at 1e-5, one selection through a sub-skin/2 drift."""
    port = runs[0]
    for mode in ("atom", "ring"):
        base = q_of(port, f"{mode}_base")
        assert_close(q_of(port, f"{mode}_reuse"), base)
        assert_close(q_of(port, f"{mode}_skin"), base)
        assert result(port, f"{mode}_skin")["skin_rebuilds"] == 1


def test_auto_window_unsorted_goes_off(runs):
    """The mesh's auto window is measured on every rank's row slice of the
    global-index tables and capped at the global height: off for an
    unsorted 3-D geometry, the charges bit for bit the unchunked reuse."""
    port = runs[0]
    np.testing.assert_array_equal(q_of(port, "window_off"),
                                  q_of(port, "window_off_base"))
    assert result(port, "window_off")["widths"] == [0]


def test_cold_sorted_window(runs):
    """A cold call on the sorted line takes a compact window from the
    sorted cell keys; the charges match the unsorted forward at 1e-5."""
    port = runs[0]
    assert_close(q_of(port, "cold_window"), q_of(port, "cold_window_base"))
    widths = result(port, "cold_window")["widths"]
    assert widths and all(0 < w < 64 for w in widths), widths


def test_far_cluster_dispatch_and_warnings(runs):
    """Big graphs on an atom mesh and the ring run the clustered tier
    without a warning and conserve; the dense small-graph path warns and
    runs exact."""
    port = runs[0]
    for name in ("cluster_atom", "cluster_ring"):
        out = result(port, name)
        assert out["warnings"] == [], out["warnings"]
        np.testing.assert_allclose(out["q"][0].sum(), 1.0, atol=1e-4)
    dense = result(port, "cluster_dense")
    assert any("exact far field" in w for w in dense["warnings"])


def test_shard_batch_args(runs):
    rows0, err0 = runs[2][0]["batch_args"]
    rows1, _ = runs[2][1]["batch_args"]
    np.testing.assert_array_equal(np.concatenate([rows0, rows1]),
                                  np.arange(12.0).reshape(4, 3))
    assert err0 is not None and "not divisible by data axis 2" in err0


# ---------------------------------------------------------------------------
# the CLI under torchrun
# ---------------------------------------------------------------------------

def _write_xyz(path, m):
    lines = [str(len(m["symbols"])), f"{m['charge']:g} 1"]
    lines += [f"{s} {x} {y} {z}" for s, (x, y, z) in zip(m["symbols"],
                                                          m["xyz"])]
    path.write_text("\n".join(lines) + "\n")


def test_cli_atom_and_ring_shard(tmp_path):
    """``infer --atom-shard 2`` and ``--ring-shard 2`` under torchrun
    (``--standalone``: its rendezvous binds a free port itself; two gloo
    processes, ``EPNN_PLATFORM=cpu``) write the single-device
    CLI's charges within 1e-5·(max|q| + 1); rank 0 alone writes and
    prints; a world of another size exits naming it."""
    from epnn_tpu_torch import cli
    from epnn_tpu_torch.io.checkpoint import from_jax_params, save_params
    from epnn_tpu_torch.models import EPNNConfig

    cfg = EPNNConfig(**CFG10)
    save_params(str(tmp_path / "ck"),
                from_jax_params(M.jax_params(CFG10, 0, 0.2), cfg), cfg)
    data = tmp_path / "mols"
    data.mkdir()
    for m in (mol("a", 21, 1, 6.0), mol("b", 40, 2, 7.0, charge=-1.0)):
        _write_xyz(data / f"{m['name']}.xyz", m)
    env = dict(os.environ, EPNN_PLATFORM="cpu", OMP_NUM_THREADS="1",
               PYTHONPATH=M.ROOT)
    runs = {}
    for flag, n in (("--atom-shard", 2), ("--ring-shard", 2),
                    ("--atom-shard", 3)):
        out = tmp_path / f"{flag[2:]}{n}"
        runs[(flag, n)] = (out, subprocess.Popen(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc-per-node", str(2 if n == 3 else n), "-m",
             "epnn_tpu_torch", "infer",
             "--checkpoint", str(tmp_path / "ck"), str(data), "--out",
             str(out), flag, str(n)],
            cwd=M.ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    cli.main(["infer", "--checkpoint", str(tmp_path / "ck"), str(data),
              "--out", str(tmp_path / "one")])
    texts = {}
    for key, (out, proc) in runs.items():
        try:
            texts[key] = proc.communicate(timeout=M.TIMEOUT)[0]
        except subprocess.TimeoutExpired:
            for _, p in runs.values():
                p.kill()
            raise
    for flag in ("--atom-shard", "--ring-shard"):
        text = texts[(flag, 2)]
        assert runs[(flag, 2)][1].returncode == 0, text
        assert text.count("wrote 2 prediction files") == 1, text
        for name in ("a", "b"):
            q = np.load(runs[(flag, 2)][0] / f"{name}_pred.npy")
            assert_close(q, np.load(tmp_path / "one" / f"{name}_pred.npy"),
                         what=(flag, name))
    assert runs[("--atom-shard", 3)][1].returncode != 0
    assert "world size is 2" in texts[("--atom-shard", 3)]


# ---------------------------------------------------------------------------
# the API in this process (a world of one)
# ---------------------------------------------------------------------------

@pytest.fixture
def world_of_one():
    from epnn_tpu_torch.parallel import initialize_distributed

    initialize_distributed(device_type="cpu")
    yield
    dist.destroy_process_group()


def test_make_mesh_axes_and_errors(world_of_one):
    from epnn_tpu_torch.parallel import (
        ATOM_AXIS,
        DATA_AXIS,
        initialize_distributed,
        is_coordinator,
        make_mesh,
    )

    group = dist.group.WORLD
    initialize_distributed(device_type="cpu")  # idempotent
    assert dist.group.WORLD is group and is_coordinator()
    mesh = make_mesh(1, 1, device_type="cpu")
    assert mesh.mesh_dim_names == (DATA_AXIS, ATOM_AXIS)
    assert tuple(mesh.shape) == (1, 1) and mesh.device_type == "cpu"
    with pytest.raises(ValueError, match="world has 1.*torchrun "
                       "--nproc-per-node 2"):
        make_mesh(1, 2, device_type="cpu")
    with pytest.raises(ValueError, match="device_type"):
        make_mesh(1, 1, device_type="tpu")


def test_make_mesh_needs_a_card_unless_asked(monkeypatch):
    from epnn_tpu_torch.parallel import make_mesh

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device_type='cpu'"):
        make_mesh()
    assert not dist.is_initialized()


def test_shard_state_checks_the_replicas(world_of_one):
    from epnn_tpu_torch.parallel import make_mesh, shard_state

    state = {"w": torch.arange(4.0), "b": [torch.ones(2)]}
    assert shard_state(state, make_mesh(1, 1, device_type="cpu")) is state


def test_one_rank_mesh_predictor_is_the_one_device_one(world_of_one,
                                                      monkeypatch):
    """A (1, 1) mesh: the same kernels at the same shapes as the one-device
    Predictor, the same charges bit for bit (top-k selection on both)."""
    from epnn_tpu_torch import infer
    from epnn_tpu_torch.data import pad_molecules
    from epnn_tpu_torch.data.xyz import Molecule
    from epnn_tpu_torch.elements import table_for_n_elems
    from epnn_tpu_torch.io.checkpoint import from_jax_params
    from epnn_tpu_torch.models import EPNNConfig
    from epnn_tpu_torch.parallel import make_mesh

    monkeypatch.setattr(infer, "DENSE_MAX_ATOMS", 16)
    cfg = EPNNConfig(**CFG10)
    tree = from_jax_params(M.jax_params(CFG10, 0, 0.3), cfg)
    m = mol("m", 40, 5, 7.0)
    batch = pad_molecules([Molecule(m["name"], m["symbols"], m["xyz"],
                                    m["charge"])],
                          table_for_n_elems(10), pad_to=40)
    mesh = make_mesh(1, 1, device_type="cpu")
    one = infer.Predictor(tree, cfg, device="cpu", neighbor_method="topk")
    for mode in ("atom", "ring"):
        q = infer.Predictor(tree, cfg, 256, None, mesh,
                            mode).predict_batch(batch)
        if mode == "atom":
            np.testing.assert_array_equal(q, one.predict_batch(batch))
        assert_close(q, one.predict_batch(batch))
    with pytest.raises(ValueError, match="shard_mode"):
        infer.Predictor(tree, cfg, mesh=mesh, shard_mode="rows")


def test_import_starts_no_process_group():
    """Importing the package and every module of ``parallel`` starts no
    process group and imports nothing of JAX."""
    code = (
        "import sys, torch.distributed as d\n"
        "import epnn_tpu_torch, epnn_tpu_torch.infer, epnn_tpu_torch.cli\n"
        "import epnn_tpu_torch.parallel\n"
        "from epnn_tpu_torch.parallel import atom_shard, ring_shard, "
        "multihost, sharding, _collectives\n"
        "assert not d.is_initialized()\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'epnn_tpu.')) "
        "or m == 'epnn_tpu' for m in sys.modules), 'jax imported'\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=M.ROOT,
                         capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=M.ROOT))
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


# ---------------------------------------------------------------------------
# signatures against JAX's
# ---------------------------------------------------------------------------

def _params(fn):
    return [(p.name, p.default) for p in
            inspect.signature(fn).parameters.values()]


@pytest.mark.parametrize("name", [
    "parallel.atom_shard.forward_atom_sharded_nbr_batch",
    "parallel.atom_shard.forward_atom_sharded_batch",
    "parallel.atom_shard.forward_atom_sharded",
    "parallel.atom_shard.make_sharded_train_step",
    "parallel.atom_shard.make_sharded_eval_step",
    "parallel.ring_shard.forward_ring_sharded_nbr_batch",
    "parallel.ring_shard.forward_ring_sharded",
    "ops.cluster.weighted_kmeans_sharded",
    "parallel.multihost.initialize_distributed",
    "parallel.multihost.make_multihost_mesh",
    "parallel.sharding.make_mesh",
])
def test_signature_matches_jax(name):
    """JAX's parameter names, order and defaults (the port's keyword-only
    extras after them)."""
    import importlib

    mod, fn = name.rsplit(".", 1)
    jax_fn = getattr(importlib.import_module("epnn_tpu." + mod), fn)
    port_fn = getattr(importlib.import_module("epnn_tpu_torch." + mod), fn)
    jax_params = _params(jax_fn)
    assert _params(port_fn)[:len(jax_params)] == jax_params


def test_predictor_fields_match_jax():
    import dataclasses

    from epnn_tpu.infer import Predictor as JaxPredictor
    from epnn_tpu_torch.infer import Predictor

    def head(cls):
        fields = [f for f in dataclasses.fields(cls)
                  if f.kw_only is False and f.name != "_"][:6]
        return [(f.name, f.default) for f in fields]

    assert head(Predictor) == head(JaxPredictor)
    assert [n for n, _ in head(Predictor)] == [
        "params", "cfg", "block", "force_mode", "mesh", "shard_mode"]
    assert dict(head(Predictor))["shard_mode"] == "atom"


# ---------------------------------------------------------------------------
# multihost: layout on fake rank lists, the environment's fallbacks
# ---------------------------------------------------------------------------

def _pod(hosts, per_host):
    from epnn_tpu_torch.parallel.multihost import RankDevice

    return [RankDevice(h * per_host + i, f"host{h}")
            for h in range(hosts) for i in range(per_host)]


class TestHybridLayout:
    def test_num_hosts(self):
        from epnn_tpu_torch.parallel.multihost import _num_hosts

        assert _num_hosts(_pod(3, 4)) == 3

    def test_atoms_axis_never_crosses_a_host(self):
        from epnn_tpu_torch.parallel.multihost import multihost_layout

        devs = _pod(2, 4)
        arr = multihost_layout(None, 2, devs)
        assert arr.shape == (4, 2)
        host = {d.rank: d.host for d in devs}
        for row in arr:
            assert len({host[int(r)] for r in row}) == 1, arr

    def test_default_n_data_uses_everything(self):
        from epnn_tpu_torch.parallel.multihost import multihost_layout

        arr = multihost_layout(None, 4, _pod(2, 4))
        assert arr.shape == (2, 4)
        assert sorted(arr.reshape(-1).tolist()) == list(range(8))

    def test_oversized_atoms_axis_rejected(self):
        from epnn_tpu_torch.parallel.multihost import multihost_layout

        with pytest.raises(ValueError, match="must not cross"):
            multihost_layout(None, 8, _pod(2, 4))
        with pytest.raises(ValueError, match="evenly divide"):
            multihost_layout(None, 3, _pod(2, 4))

    def test_bad_n_data_rejected(self):
        from epnn_tpu_torch.parallel.multihost import multihost_layout

        with pytest.raises(ValueError, match="n_data=3"):
            multihost_layout(3, 2, _pod(2, 4))

    def test_uneven_hosts_rejected(self):
        from epnn_tpu_torch.parallel.multihost import multihost_layout

        with pytest.raises(ValueError, match="uneven"):
            multihost_layout(None, 1, _pod(2, 4)[:7])

    def test_single_host_is_the_plain_mesh(self, world_of_one):
        from epnn_tpu_torch.parallel import make_multihost_mesh
        from epnn_tpu_torch.parallel.multihost import world_devices

        devs = world_devices()
        assert [d.rank for d in devs] == [0]
        mesh = make_multihost_mesh(devices=devs, device_type="cpu")
        assert tuple(mesh.shape) == (1, 1)


class TestInitialize:
    def _recorded(self, monkeypatch):
        calls = {}
        monkeypatch.setattr(dist, "is_initialized", lambda: False)
        monkeypatch.setattr(dist, "init_process_group",
                            lambda backend, **kw: calls.update(
                                kw, backend=backend))
        for var in ("EPNN_COORDINATOR", "EPNN_NUM_PROCESSES",
                    "EPNN_PROCESS_ID", "MASTER_ADDR", "MASTER_PORT",
                    "WORLD_SIZE", "RANK"):
            monkeypatch.delenv(var, raising=False)
        return calls

    def test_env_var_fallback(self, monkeypatch):
        from epnn_tpu_torch.parallel import initialize_distributed

        calls = self._recorded(monkeypatch)
        monkeypatch.setenv("EPNN_COORDINATOR", "h0:9999")
        monkeypatch.setenv("EPNN_NUM_PROCESSES", "4")
        monkeypatch.setenv("EPNN_PROCESS_ID", "2")
        initialize_distributed(device_type="cpu")
        assert calls == {"init_method": "tcp://h0:9999", "world_size": 4,
                         "rank": 2, "backend": "gloo"}

    def test_torchrun_env_fallback(self, monkeypatch):
        from epnn_tpu_torch.parallel import initialize_distributed

        calls = self._recorded(monkeypatch)
        monkeypatch.setenv("MASTER_ADDR", "h1")
        monkeypatch.setenv("MASTER_PORT", "1234")
        monkeypatch.setenv("WORLD_SIZE", "2")
        monkeypatch.setenv("RANK", "1")
        initialize_distributed(device_type="cpu", initialization_timeout=5)
        assert calls["init_method"] == "tcp://h1:1234"
        assert (calls["world_size"], calls["rank"]) == (2, 1)
        assert calls["timeout"].total_seconds() == 5

    def test_explicit_args_win(self, monkeypatch):
        from epnn_tpu_torch.parallel import initialize_distributed

        calls = self._recorded(monkeypatch)
        monkeypatch.setenv("EPNN_COORDINATOR", "h0:9999")
        initialize_distributed(coordinator_address="h1:1", num_processes=1,
                               process_id=0, device_type="cpu")
        assert calls["init_method"] == "tcp://h1:1"

    def test_many_processes_need_an_address(self, monkeypatch):
        from epnn_tpu_torch.parallel import initialize_distributed

        self._recorded(monkeypatch)
        with pytest.raises(ValueError, match="coordinator address"):
            initialize_distributed(num_processes=2, process_id=0,
                                   device_type="cpu")
