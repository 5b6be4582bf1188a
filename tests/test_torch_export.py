"""The serving export (``epnn_tpu_torch.io.export_serving``) on the CPU,
case by case after the JAX package's ``tests/test_export.py``, each
artifact against the live port ``Predictor``:

* dense, blocked (top-k and the cell builder) and md (the skin tables,
  then atoms moved within the skin): bit for bit — the exported program
  runs the live call's operators in the same order;
* the shape, table and format errors (a JAX artifact included), the
  clustered far field baked in, the int8 tier through its operator, a
  multi-platform artifact (the operators, traced on the CPU), and the
  CLI;
* the port's artifact against JAX's on the same random parameters
  (``from_jax_params``) and batch, at 1e-5·(max|q| + 1) (the suite's bar
  between two paths of the same math), Σq at the net charge;
* the kernels as registered operators: ``torch.library.opcheck`` of each,
  an artifact's graph holding ``epnn_torch::`` nodes and reloading in a
  fresh process, and, on the emulated card (``test_torch_widths.
  arm_card``), a loaded artifact reaching the launch path with the live
  call's launch counts.
"""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from epnn_tpu.data.dataset import pad_molecules as jax_pad_molecules
from epnn_tpu.elements import table_for_n_elems as jax_table
from epnn_tpu.infer import Predictor as JaxPredictor
from epnn_tpu.io.export_serving import export_predictor as jax_export
from epnn_tpu.io.export_serving import load_serving as jax_load
from epnn_tpu.models import EPNNConfig as JaxConfig
from epnn_tpu.models import init_params as jax_init_params
from epnn_tpu_torch import cli
from epnn_tpu_torch.data.dataset import pad_molecules
from epnn_tpu_torch.data.xyz import Molecule
from epnn_tpu_torch.elements import table_for_n_elems
from epnn_tpu_torch.infer import Predictor
from epnn_tpu_torch.io import (ServingArtifact, export_predictor,
                               from_jax_params, load_serving, save_params)
from epnn_tpu_torch.io.export_serving import ARTIFACT_FILE, MANIFEST_FILE
from epnn_tpu_torch.models import EPNNConfig
from epnn_tpu_torch.ops import kernels
from epnn_tpu_torch.testing import write_xyz

from test_torch_widths import arm_card

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def params():
    """JAX's test model (T = 2, biases shifted by 0.3 so the charges
    move), as both packages' parameters."""
    jp = jax_init_params(JaxConfig(T=2), jax.random.key(0))
    jp = jax.tree_util.tree_map(lambda a: a + 0.3 if a.ndim == 1 else a, jp)
    return jp, from_jax_params(jax.tree_util.tree_map(np.asarray, jp))


def _pred(params, **kw):
    return Predictor(params=params[1], cfg=EPNNConfig(T=2), device="cpu",
                     **kw)


def _port_mols(toy_molecules):
    return [Molecule(name=m.name, symbols=list(m.symbols), xyz=m.xyz.copy(),
                     total_charge=m.total_charge, labels=m.labels)
            for m in toy_molecules]


def _batch(toy_molecules, pad_to=16):
    return pad_molecules(_port_mols(toy_molecules), table_for_n_elems(10),
                         pad_to=pad_to)


def _args(batch):
    return (batch.x, batch.q0, batch.xyz, batch.node_mask)


def _op_nodes(art):
    return sorted({str(n.target) for n in art._program.graph.nodes
                   if str(n.target).startswith("epnn_torch.")})


#: the operators of a blocked float32 artifact
BLOCKED_OPS = ["epnn_torch.dense_message_rowsum.default",
               "epnn_torch.near_message_corr.default",
               "epnn_torch.near_pass_rowsum.default"]


def test_export_dense_roundtrip(tmp_path, toy_molecules, params):
    pred = _pred(params)
    batch = _batch(toy_molecules)
    manifest = export_predictor(pred, batch, str(tmp_path))
    assert manifest["mode"] == "dense"
    assert os.path.exists(tmp_path / ARTIFACT_FILE)
    art = load_serving(str(tmp_path))
    assert isinstance(art, ServingArtifact) and art.device.type == "cpu"
    np.testing.assert_array_equal(art(*_args(batch)),
                                  pred.predict_batch(batch))
    with open(tmp_path / MANIFEST_FILE) as f:
        m = json.load(f)
    assert m["format"] == "epnn_tpu_torch.serving/1"
    assert m["torch_version"] == torch.__version__ and "jax_version" not in m
    assert m["platforms"] == ["cpu"] and m["config"]["T"] == 2
    assert m["padded_atoms"] == batch.padded_atoms
    assert m["inputs"][0]["shape"] == [batch.batch_size, batch.padded_atoms,
                                       10]


@pytest.mark.parametrize("method", ["topk", "cell"])
def test_export_blocked_roundtrip(tmp_path, toy_molecules, params, method):
    """In-program selection by top-k, or by the cell builder on the baked
    grid: the live charges bit for bit, Σq at the net charge."""
    pred = _pred(params, force_mode="blocked", neighbor_method=method)
    batch = _batch(toy_molecules)
    manifest = export_predictor(pred, batch, str(tmp_path), mode="blocked")
    assert manifest["neighbor_k"] >= 1
    assert (manifest["neighbor_grid"] is None) == (method == "topk")
    art = load_serving(str(tmp_path))
    q = art(*_args(batch))
    np.testing.assert_array_equal(q, pred.predict_batch(batch))
    np.testing.assert_allclose((q * batch.node_mask).sum(1), batch.total_q,
                               atol=5e-5)
    assert _op_nodes(art) == BLOCKED_OPS


def test_export_md_mode(tmp_path, toy_molecules, params):
    """md artifacts take (idx, nbr_mask) and gather pair distances from
    the current coordinates in the program: moving atoms within the skin
    changes the charges without a re-export or a rebuild."""
    pred = _pred(params, force_mode="blocked", reuse_neighbors=True,
                 neighbor_skin=0.4)
    batch = _batch(toy_molecules)
    manifest = export_predictor(pred, batch, str(tmp_path), mode="md")
    assert manifest["neighbor_skin"] == pytest.approx(0.4)
    assert manifest["inputs"][4]["dtype"] == "int32"
    art = load_serving(str(tmp_path))
    idx, nbr_mask = (t.numpy() for t in pred._neighbors_skin(batch))
    assert idx.shape[-1] == manifest["neighbor_k"]
    q = art(*_args(batch), idx, nbr_mask)
    np.testing.assert_array_equal(q, pred.predict_batch(batch))
    batch.xyz[:, :3] += 0.05
    q2 = art(*_args(batch), idx, nbr_mask)
    np.testing.assert_array_equal(q2, pred.predict_batch(batch))
    assert pred.skin_rebuilds == 1 and np.abs(q2 - q).max() > 0
    with pytest.raises(ValueError, match="neighbor tables"):
        art(*_args(batch))


def test_export_shape_and_format_errors(tmp_path, toy_molecules, params):
    pred = _pred(params)
    batch = _batch(toy_molecules)
    export_predictor(pred, batch, str(tmp_path / "port"))
    art = load_serving(str(tmp_path / "port"))
    with pytest.raises(ValueError, match="static serving shape"):
        art(*(a[:, :8] for a in _args(batch)))
    with pytest.raises(ValueError, match="takes no neighbor tables"):
        art(*_args(batch), np.zeros((4, 16, 4), np.int32),
            np.zeros((4, 16, 4), np.float32))
    with pytest.raises(ValueError, match="mode must be one of"):
        export_predictor(pred, batch, str(tmp_path / "x"), mode="sharded")
    with pytest.raises(ValueError, match="'tpu'"):
        export_predictor(pred, batch, str(tmp_path / "x"), platforms=["tpu"])
    # a JAX artifact, and a bad format, are refused loudly
    jbatch = jax_pad_molecules(toy_molecules, jax_table(10), pad_to=16)
    jax_export(JaxPredictor(params=params[0], cfg=JaxConfig(T=2)), jbatch,
               str(tmp_path / "jax"))
    with pytest.raises(ValueError, match="not an epnn_tpu_torch serving"):
        load_serving(str(tmp_path / "jax"))
    path = tmp_path / "port" / MANIFEST_FILE
    m = json.loads(path.read_text())
    if not torch.cuda.is_available():  # a card artifact needs a card
        path.write_text(json.dumps(dict(m, platforms=["cuda"])))
        with pytest.raises(RuntimeError, match="no CUDA card"):
            load_serving(str(tmp_path / "port"))
    path.write_text(json.dumps(dict(m, format="something/else")))
    with pytest.raises(ValueError, match="not an epnn_tpu_torch serving"):
        load_serving(str(tmp_path / "port"))


def test_export_bakes_far_cluster(tmp_path, toy_molecules, params):
    """A far_cluster Predictor exports the clustered tier: the artifact
    gives the clustered live charges, not the exact ones."""
    pred = _pred(params, force_mode="blocked", far_cluster=4)
    batch = _batch(toy_molecules)
    manifest = export_predictor(pred, batch, str(tmp_path), mode="blocked")
    assert manifest["far_cluster"] == 4
    q = load_serving(str(tmp_path))(*_args(batch))
    np.testing.assert_array_equal(q, pred.predict_batch(batch))
    exact = _pred(params, force_mode="blocked")
    assert np.abs(q - exact.predict_batch(batch)).max() > 1e-5


def test_export_int8_tier(tmp_path, toy_molecules, params):
    """``use_pallas=True`` under ``dense_matmul_precision='int8'`` bakes
    the int8 far field (its operator in the graph), the live blocked
    forward's charges at that setting bit for bit."""
    from epnn_tpu_torch.ops.fused import forward_blocked

    cfg = EPNNConfig(T=2).replace(dense_matmul_precision="int8")
    pred = Predictor(params=params[1], cfg=cfg, device="cpu",
                     force_mode="blocked")
    batch = _batch(toy_molecules)
    manifest = export_predictor(pred, batch, str(tmp_path), mode="blocked",
                                use_pallas=True)
    assert manifest["use_pallas"] is True
    art = load_serving(str(tmp_path))
    assert "epnn_torch.dense_message_rowsum_int8.default" in _op_nodes(art)
    with torch.no_grad():
        live = forward_blocked(
            pred._fused, *pred._inputs(batch), cfg, use_pallas=True,
            neighbor_k=manifest["neighbor_k"],
            uniform_q0=manifest["uniform_q0"]).numpy()
    np.testing.assert_array_equal(art(*_args(batch)), live)
    assert np.abs(live - pred.predict_batch(batch)).max() > 0


def test_export_multi_platform_plain_route(tmp_path, toy_molecules, params):
    """Several platforms are traced on the CPU through the same operators
    as one (they pick the plain versions or the kernels by the tensors'
    device when called), ``use_pallas`` kept: the operators in the graph,
    the same charges here."""
    pred = _pred(params, force_mode="blocked")
    batch = _batch(toy_molecules)
    manifest = export_predictor(pred, batch, str(tmp_path), mode="blocked",
                                platforms=("cuda", "cpu"), use_pallas=True)
    assert manifest["platforms"] == ["cuda", "cpu"]
    assert manifest["use_pallas"] is True
    art = load_serving(str(tmp_path))
    assert art.device.type == "cpu"
    assert _op_nodes(art) == BLOCKED_OPS
    np.testing.assert_array_equal(art(*_args(batch)),
                                  pred.predict_batch(batch))


@pytest.mark.parametrize("mode", ["dense", "blocked", "md"])
def test_artifact_matches_the_jax_artifact(tmp_path, toy_molecules, params,
                                           mode):
    """The port's artifact against JAX's, exported from Predictors of the
    same parameters on the same batch: within 1e-5·(max|q| + 1), Σq at
    the net charge."""
    kw = {} if mode == "dense" else dict(force_mode="blocked")
    if mode == "md":
        kw.update(reuse_neighbors=True, neighbor_skin=0.4)
    jpred = JaxPredictor(params=params[0], cfg=JaxConfig(T=2), **kw)
    jbatch = jax_pad_molecules(toy_molecules, jax_table(10), pad_to=16)
    jm = jax_export(jpred, jbatch, str(tmp_path / "jax"), mode=mode)
    pred = _pred(params, **kw)
    batch = _batch(toy_molecules)
    m = export_predictor(pred, batch, str(tmp_path / "port"), mode=mode)
    assert ({k for k in m} - {"torch_version"}
            == {k for k in jm} - {"jax_version"})
    for key in ("mode", "signature", "inputs", "output", "neighbor_k",
                "block", "uniform_q0", "far_cluster"):
        assert m[key] == jm[key], key
    args = _args(batch)
    if mode == "md":
        args += tuple(t.numpy() for t in pred._neighbors_skin(batch))
    q = load_serving(str(tmp_path / "port"))(*args)
    qj = jax_load(str(tmp_path / "jax"))(*args)
    assert float(np.abs(q - qj).max()) <= 1e-5 * (float(np.abs(qj).max())
                                                  + 1.0)
    np.testing.assert_allclose((q * batch.node_mask).sum(1), batch.total_q,
                               atol=5e-5)


def test_artifact_reloads_in_a_fresh_process(tmp_path, toy_molecules,
                                             params):
    """A blocked artifact holds the ``epnn_torch::`` operators and loads,
    and serves the live charges, in a fresh process."""
    pred = _pred(params, force_mode="blocked")
    batch = _batch(toy_molecules)
    export_predictor(pred, batch, str(tmp_path / "art"), mode="blocked")
    np.savez(tmp_path / "in.npz", *_args(batch))
    code = ("import sys, numpy as np; "
            "from epnn_tpu_torch.io import load_serving; "
            "art = load_serving(sys.argv[1]); "
            "a = np.load(sys.argv[2]); "
            "np.save(sys.argv[3], art(*[a[f'arr_{i}'] for i in range(4)]))")
    proc = subprocess.run(
        [sys.executable, "-c", code, str(tmp_path / "art"),
         str(tmp_path / "in.npz"), str(tmp_path / "q.npy")],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT), capture_output=True,
        text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    np.testing.assert_array_equal(np.load(tmp_path / "q.npy"),
                                  pred.predict_batch(batch))
    assert "epnn_torch.near_pass_rowsum.default" in _op_nodes(
        load_serving(str(tmp_path / "art")))


def test_loaded_artifact_reaches_the_launch_path(tmp_path, toy_molecules,
                                                 params, monkeypatch):
    """On the emulated card a loaded artifact's operators take the launch
    path — each kernel's count equal to the live call's, the charges the
    live call's bit for bit."""
    pred = _pred(params, force_mode="blocked")
    batch = _batch(toy_molecules)
    export_predictor(pred, batch, str(tmp_path), mode="blocked")
    art = load_serving(str(tmp_path))
    arm_card(monkeypatch)
    q_live = pred.predict_batch(batch)
    live = dict(kernels.LAUNCHES)
    kernels.reset_launch_counts()
    q = art(*_args(batch))
    assert kernels.LAUNCHES == live
    assert live["dense_message_rowsum"] == 4 * 1  # round 2 of 4 graphs
    assert live["near_message_corr"] == live["near_pass_rowsum"] == 4 * 2
    np.testing.assert_array_equal(q, q_live)


def test_multi_platform_artifact_reaches_the_launch_path(
        tmp_path, toy_molecules, params, monkeypatch):
    """A multi-platform artifact's operators take the launch path on the
    emulated card as a single-platform one's do: the live call's launch
    counts and charges."""
    pred = _pred(params, force_mode="blocked")
    batch = _batch(toy_molecules)
    export_predictor(pred, batch, str(tmp_path), mode="blocked",
                     platforms=("cuda", "cpu"))
    art = load_serving(str(tmp_path))
    arm_card(monkeypatch)
    q_live = pred.predict_batch(batch)
    live = dict(kernels.LAUNCHES)
    kernels.reset_launch_counts()
    q = art(*_args(batch))
    assert kernels.LAUNCHES == live and live["near_pass_rowsum"] == 4 * 2
    np.testing.assert_array_equal(q, q_live)


@pytest.mark.parametrize("name", sorted(kernels._EAGER))
def test_eager_route_matches_the_operator(name, monkeypatch):
    """An eager call runs the operator's body and VJP without the
    dispatcher (the operator is not called), with the operator's output
    and gradients bit for bit."""
    def run(call):
        args = _op_args(name, np.random.default_rng(1))
        out = call(*args)
        leaves = [a for a in args if isinstance(a, torch.Tensor)
                  and a.requires_grad]
        grads = torch.autograd.grad(out.square().sum(), leaves,
                                    allow_unused=True)
        return [out.detach()] + [g for g in grads if g is not None]

    want = run(kernels._OPS[name])
    seen = []
    monkeypatch.setitem(kernels._OPS, name,
                        lambda *a: seen.append(a) or 1 / 0)
    got = run(lambda *a: kernels._call(name, *a))
    assert not seen and len(got) == len(want) > 1
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def _op_args(name, g):
    f = lambda *s: torch.tensor(  # noqa: E731
        g.normal(size=s).astype(np.float32) * 0.5, requires_grad=True)
    n, h, k, e = 12, 8, 3, 6
    mask = torch.tensor((g.uniform(size=(n, k)) > 0.3).astype(np.float32))
    cv = torch.ones(n + 2)
    xyz = torch.tensor(g.uniform(0.0, 4.0, size=(n, 3)).astype(np.float32))
    node_mask = torch.tensor((np.arange(n) < n - 2).astype(np.float32))
    base = {
        "dense_message_rowsum": (f(n, h), f(n + 2, h), cv, f(h, h), f(h),
                                 None, None, "default"),
        "dense_message_rowsum_bwd": (f(n, h), f(n + 2, h), cv, f(h, h),
                                     f(h), f(n, h), None, None, "highest"),
        "dense_message_rowsum_int8": (f(n, h), f(n + 2, h), cv, f(h, h),
                                      f(h), torch.tensor(0.2), None, None,
                                      None, None, None, "default"),
        "near_message_corr": (f(n, h), f(n * k, h), f(n * k, e).abs(), mask,
                              f(e, h), f(h, h), f(h), None, None, None,
                              "default"),
        "near_pass_rowsum": (f(n, 2 * h), f(n * k, 2 * h),
                             f(n * k, e).abs(), 0.5 * mask, f(e, h),
                             f(h, h), f(h), None, None, None, "highest"),
        "fused_message_rowsum": (f(n, h), f(n, h), xyz, node_mask, cv[:n],
                                 f(e, h), f(h, h), f(h), 3.0, 2.0, 1e-5,
                                 True, None, None, None, "default",
                                 "direct"),
        "fused_epn_rowsum": (f(n, h), f(n, h), xyz, node_mask, f(e, h),
                             f(h, h), f(h), 3.0, 2.0, 1e-5, False, None,
                             None, None, "highest", "doubling"),
    }
    return base[name]


@pytest.mark.parametrize("name", sorted(kernels._OPS))
def test_registered_operator(name):
    """Each ``epnn_torch::`` operator passes ``torch.library.opcheck``
    (schema, shape function, autograd registration) on the CPU, where it
    runs the plain version."""
    args = _op_args(name, np.random.default_rng(0))
    torch.library.opcheck(getattr(torch.ops.epnn_torch, name).default, args,
                          test_utils=("test_schema", "test_faketensor",
                                      "test_autograd_registration"))


def test_export_cli(tmp_path, toy_molecules, params, capsys):
    """``python -m epnn_tpu_torch export`` writes a loadable artifact from
    a checkpoint and prints the JAX CLI's line."""
    ckpt = tmp_path / "ckpt"
    save_params(str(ckpt), params[1], EPNNConfig(T=2))
    mol = _port_mols(toy_molecules)[3]
    path = write_xyz(str(tmp_path), mol)
    out = tmp_path / "artifact"
    cli.main(["export", "--checkpoint", str(ckpt), path, "--out", str(out),
              "--pad-to", "16", "--mode", "blocked"])
    line = capsys.readouterr().out.strip()
    assert line == (f"exported blocked-mode serving artifact (B=1, N=16, "
                    f"platforms=['cpu']) -> {out}")
    art = load_serving(str(out))
    batch = pad_molecules([mol], table_for_n_elems(10), pad_to=16)
    q = art(*_args(batch))
    assert abs(float((q * batch.node_mask).sum()) - mol.total_charge) < 5e-5
    # the CLI's parity policy, as the CLI's own infer serves it
    cfg = EPNNConfig(T=2).replace(matmul_precision="highest",
                                  dense_matmul_precision="default")
    live = Predictor(params=params[1], cfg=cfg, device="cpu",
                     force_mode="blocked").predict_batch(batch)
    np.testing.assert_array_equal(q, live)
