"""Where the port's and JAX's dense charges part on the 40-atom all-carbon
box of ``tests/test_sharding.py`` (SMALL weights from ``init_params(key
0)``, ``default_rng(5)`` coordinates in U(0, 8) Å, net charge +1): both
packages' float32 forwards round by round against an independent float64
evaluation of the same model in NumPy, on the same float32 RBF edges.

The finding (``python tests/test_torch_carbon_box.py`` prints the
table): the message rounds of the port are no further from float64 than
JAX's; the pass rounds are, because the pass MLP's first layer (K = 70
inputs a pair) is one float32 product of the CPU's BLAS, whose summation
order carries about twice the error of XLA's on the same inputs, and the
antisymmetric difference f_ij − f_ji then keeps it.  JAX's own charges
are further from float64 than 1e-5·(max|q| + 1) on this box, so no
float32 summation order of the port can bring the two packages under
that bar there; the mesh tests hold this box at 1e-4.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

CFG = dict(n_elems=10, h_dim=16, e_dim=16, msg_dim=8, mlp_hidden=(8, 8),
           T=2)


def _box():
    import jax
    import jax.numpy as jnp

    from epnn_tpu.data.dataset import pad_molecules
    from epnn_tpu.data.xyz import Molecule
    from epnn_tpu.elements import table_for_n_elems
    from epnn_tpu.featurize import rbf_edges
    from epnn_tpu.models import EPNNConfig, init_params

    cfg = EPNNConfig(**CFG)
    params = jax.tree_util.tree_map(np.asarray,
                                    init_params(cfg, jax.random.key(0)))
    g = np.random.default_rng(5)
    mol = Molecule(name="m", symbols=["C"] * 40,
                   xyz=g.uniform(0, 8, (40, 3)).astype(np.float32),
                   total_charge=1.0)
    b = pad_molecules([mol], table_for_n_elems(10))
    x, q0, xyz, mask = (np.array(a) for a in (b.x, b.q0, b.xyz,
                                              b.node_mask))
    e = np.array(rbf_edges(jnp.asarray(xyz), jnp.asarray(mask), e_dim=16,
                             cutoff=cfg.cutoff, eta=cfg.eta))
    return cfg, params, (x, q0, e, mask)


def _mlp(layers, z, mm, relu):
    for i in range(len(layers)):
        leaf = layers[f"dense_{i}"]
        z = mm(z, leaf["kernel"]) + leaf["bias"].astype(z.dtype)
        if i < len(layers) - 1:
            z = relu(z)
    return z


def _rounds(xp, dt, mm, relu, params, inputs, cfg):
    """The dense model round by round in ``xp`` at type ``dt``: the
    message sums, h after each message round and q after each pass
    round."""
    p = params["params"]
    x, q, e, m = (xp.asarray(a).astype(dt) for a in inputs)
    b, n = x.shape[:2]
    h = xp.zeros((b, n, cfg.h_dim), dt)
    pm = m[:, :, None] * m[:, None, :]
    out = {}

    def pairs(h, q):
        a = xp.concatenate([x, h, q[..., None]], -1)
        return (xp.broadcast_to(a[:, :, None, :], (b, n, n, a.shape[-1])),
                xp.broadcast_to(a[:, None, :, :], (b, n, n, a.shape[-1])))

    for t in range(cfg.T):
        ai, aj = pairs(h, q)
        msgs = _mlp(p[f"message_{t}"], xp.concatenate([ai, aj, e], -1), mm,
                    relu) * pm[..., None]
        out[f"agg{t}"] = msgs.sum(2)
        h = _mlp(p["update"], xp.concatenate([h, out[f"agg{t}"]], -1)
                 * m[..., None], mm, relu) * m[..., None]
        out[f"h{t}"] = h
    gate = (xp.clip(e, cfg.is_near_tol, 1e5).max(-1)
            != cfg.is_near_tol).astype(dt)
    w = gate * pm
    for t in range(cfg.T):
        ai, aj = pairs(h, q)
        fij = _mlp(p[f"pass_{t}"], xp.concatenate([ai, aj, e], -1), mm,
                   relu)[..., 0]
        fji = _mlp(p[f"pass_{t}"], xp.concatenate([aj, ai, e], -1), mm,
                   relu)[..., 0]
        q = q + (0.5 * (fij - fji) * w).sum(2)
        out[f"q{t}"] = q
    return out


def _port_rounds(model, inputs, cfg):
    """The port's dense model round by round, through its own modules."""
    from epnn_tpu_torch.models.epnn import pair_gate

    x, q, e, m = (torch.from_numpy(a) for a in inputs)
    out = {}
    with torch.no_grad():
        h = x.new_zeros((x.shape[0], x.shape[1], cfg.h_dim))
        pm = m[:, :, None] * m[:, None, :]
        for t in range(cfg.T):
            ai, aj = model._atom_pairs(x, h, q)
            msgs = model.message_mlps[t](torch.cat([ai, aj, e], -1)) \
                * pm[..., None]
            out[f"agg{t}"] = msgs.sum(2)
            h = model.update_mlp(torch.cat([h, out[f"agg{t}"]], -1)
                                 * m[..., None]) * m[..., None]
            out[f"h{t}"] = h
        w = pair_gate(e, cfg.is_near_tol) * pm
        for t in range(cfg.T):
            ai, aj = model._atom_pairs(x, h, q)
            fij = model.pass_mlps[t](torch.cat([ai, aj, e], -1))[..., 0]
            fji = model.pass_mlps[t](torch.cat([aj, ai, e], -1))[..., 0]
            q = q + (0.5 * (fij - fji) * w).sum(2)
            out[f"q{t}"] = q
    return {k: v.numpy() for k, v in out.items()}


def _compute():
    """Each side's rounds and charges: (float64, JAX, port, JAX's
    ``EPNN.apply`` charges, the port's ``EPNN`` charges, the weights,
    the inputs)."""
    import jax
    import jax.numpy as jnp

    from epnn_tpu.models import EPNN as JaxEPNN
    from epnn_tpu_torch.io.checkpoint import from_jax_params
    from epnn_tpu_torch.models import EPNN, EPNNConfig

    cfg, params, inputs = _box()
    q_jax = np.asarray(JaxEPNN(cfg).apply(params, *inputs))
    pcfg = EPNNConfig(**CFG)
    model = EPNN.from_params(pcfg, from_jax_params(params, pcfg))
    with torch.no_grad():
        q_port = model(*(torch.from_numpy(a) for a in inputs)).numpy()
    hi = jax.lax.Precision.HIGHEST
    r64 = _rounds(np, np.float64, lambda a, k: a @ k.astype(np.float64),
                  lambda z: np.maximum(z, 0.0), params, inputs, cfg)
    rj = _rounds(jnp, jnp.float32,
                 lambda a, k: jnp.dot(a, jnp.asarray(k), precision=hi),
                 jax.nn.relu, params, inputs, cfg)
    rj = {k: np.asarray(v) for k, v in rj.items()}
    return r64, rj, _port_rounds(model, inputs, cfg), q_jax, q_port, \
        params, inputs, model


@pytest.fixture(scope="module")
def box():
    return _compute()


def _err(a, ref):
    return float(np.abs(np.asarray(a, np.float64) - ref).max())


def test_the_round_replicas_are_the_packages(box):
    """The round-by-round evaluations reproduce each package's forward
    bit for bit, so what they show is the packages'."""
    _, rj, rp, q_jax, q_port, *_ = box
    np.testing.assert_array_equal(rj["q1"], q_jax)
    np.testing.assert_array_equal(rp["q1"], q_port)


def test_message_rounds_are_no_further_from_float64(box):
    """h after each message round: the port within JAX's own distance to
    the float64 evaluation (times 1.5, float32 noise)."""
    r64, rj, rp, *_ = box
    for key in ("h0", "h1"):
        assert _err(rp[key], r64[key]) <= 1.5 * _err(rj[key], r64[key]), key


def test_pass_mlp_error_is_the_blas_product(box):
    """On the same float32 pass-round inputs (h of the float64
    evaluation), the port's pass MLP's first layer is the BLAS product
    ``Z @ W + b`` bit for bit, and its charges move by float32 error only
    (2e-5 of 0.07)."""
    r64, _, _, _, _, params, inputs, model = box
    x, q0, e, mask = inputs
    a = np.concatenate([x, r64["h1"].astype(np.float32), q0[..., None]], -1)
    b, n = a.shape[:2]
    ai = np.broadcast_to(a[:, :, None, :], (b, n, n, a.shape[-1]))
    aj = np.broadcast_to(a[:, None, :, :], (b, n, n, a.shape[-1]))
    z = torch.from_numpy(np.ascontiguousarray(np.concatenate([ai, aj, e],
                                                             -1)))
    layer = model.pass_mlps[0].dense_0
    leaf = params["params"]["pass_0"]["dense_0"]
    with torch.no_grad():
        port = torch.nn.functional.linear(z, layer.weight, layer.bias)
        blas = z @ torch.from_numpy(leaf["kernel"]) + torch.from_numpy(
            leaf["bias"])
    np.testing.assert_array_equal(port.numpy(), blas.numpy())
    p = params["params"]["pass_0"]
    f64 = [_mlp(p, zz.astype(np.float64), lambda u, k: u @ k.astype(
        np.float64), lambda u: np.maximum(u, 0.0))[..., 0] for zz in (
        z.numpy(), np.concatenate([aj, ai, e], -1))]
    with torch.no_grad():
        f32 = [model.pass_mlps[0](zz)[..., 0].numpy() for zz in (
            z, torch.from_numpy(np.ascontiguousarray(
                np.concatenate([aj, ai, e], -1))))]
    tol = model.cfg.is_near_tol
    gate = np.clip(e, tol, 1e5).max(-1) != tol
    w = gate * mask[:, :, None] * mask[:, None, :]
    dq64 = (0.5 * (f64[0] - f64[1]) * w).sum(2)
    dq32 = (0.5 * (f32[0].astype(np.float64) - f32[1]) * w).sum(2)
    assert _err(dq32, dq64) <= 2e-5


def test_charges_within_float32_error_of_float64(box):
    """Both packages' charges within 5e-5 of the float64 evaluation
    (max|q| 0.17): float32 error of an ill-conditioned box, no missing
    or wrong term (which would move them by 1e-2)."""
    r64, rj, rp, *_ = box
    assert _err(rp["q1"], r64["q1"]) <= 5e-5
    assert _err(rj["q1"], r64["q1"]) <= 5e-5


def _first_layer_errors(box):
    """max|error| against float64 of the pass MLP's first layer of round 1
    on the same float32 inputs (h of the float64 evaluation): the port's
    BLAS product and XLA's ``HIGHEST`` dot."""
    import jax.numpy as jnp
    from jax import lax

    r64, _, _, _, _, params, inputs, model = box
    x, q0, e, _ = inputs
    a = np.concatenate([x, r64["h1"].astype(np.float32), q0[..., None]], -1)
    b, n = a.shape[:2]
    shape = (b, n, n, a.shape[-1])
    z = np.concatenate([np.broadcast_to(a[:, :, None, :], shape),
                        np.broadcast_to(a[:, None, :, :], shape), e], -1)
    leaf = params["params"]["pass_0"]["dense_0"]
    ref = z.astype(np.float64) @ leaf["kernel"].astype(np.float64) \
        + leaf["bias"]
    layer = model.pass_mlps[0].dense_0
    with torch.no_grad():
        port = torch.nn.functional.linear(torch.from_numpy(z), layer.weight,
                                          layer.bias).numpy()
    xla = np.asarray(jnp.dot(jnp.asarray(z), jnp.asarray(leaf["kernel"]),
                             precision=lax.Precision.HIGHEST) + leaf["bias"])
    return _err(port, ref), _err(xla, ref)


if __name__ == "__main__":
    import jax

    jax.config.update("jax_platforms", "cpu")
    box = _compute()
    r64, rj, rp, q_jax, q_port, *_ = box
    bar = 1e-5 * (float(np.abs(q_jax).max()) + 1.0)
    print(f"port vs JAX charges {float(np.abs(q_port - q_jax).max()):.3e} "
          f"(bar 1e-5·(max|q| + 1) = {bar:.3e})")
    for key in r64:
        print(f"{key}: max|f64| {float(np.abs(r64[key]).max()):.4e}  "
              f"JAX - f64 {_err(rj[key], r64[key]):.3e}  "
              f"port - f64 {_err(rp[key], r64[key]):.3e}")
    port_l0, xla_l0 = _first_layer_errors(box)
    print(f"pass MLP first layer on the same float32 inputs, max|error| vs "
          f"float64: port (BLAS) {port_l0:.3e}, JAX (XLA) {xla_l0:.3e}")
