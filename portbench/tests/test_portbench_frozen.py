"""The frozen copies under ``portbench/frozen`` against the port's
originals as they stand."""

import numpy as np
import pytest
import torch

from epnn_tpu_torch import testing
from epnn_tpu_torch.elements import table_for_n_elems
from epnn_tpu_torch.ops import kernels
from portbench import run, weights
from portbench.frozen import elements, groups, peaks, work
from portbench.frozen.water_box import (LATTICE, OH_BOND, lattice_sites,
                                        water_box, water_boxes)
from portbench.tests import small


@pytest.mark.parametrize("n,seed", [(1, 0), (27, 5), (740, 1), (100, 2**40)])
def test_water_box_is_the_ports(n, seed):
    xyz, symbols = water_box(n, seed=seed)
    mol = testing.water_box(n, seed=seed)
    assert symbols == list(mol.symbols)
    np.testing.assert_array_equal(xyz, mol.xyz)
    assert xyz.dtype == np.float32


def test_device_boxes_have_the_ports_construction():
    """Without jitter: each O on its lattice site, each O–H 0.957 Å, the
    H–O–H angle 104.5°; the port's O atoms lie on the same sites within
    its jitter; the same generator state gives the same boxes."""
    n = 300
    gen = torch.Generator().manual_seed(3)
    xyz = water_boxes(n, 2, gen, jitter=0.0).reshape(2, n, 3, 3)
    sites = lattice_sites(n)
    np.testing.assert_allclose(xyz[:, :, 0], np.broadcast_to(sites, (2, n, 3)),
                               atol=1e-4)
    oh = np.linalg.norm(xyz[:, :, 1:] - xyz[:, :, :1], axis=-1)
    np.testing.assert_allclose(oh, OH_BOND, rtol=1e-5)
    v1, v2 = xyz[:, :, 1] - xyz[:, :, 0], xyz[:, :, 2] - xyz[:, :, 0]
    cos = (v1 * v2).sum(-1) / (OH_BOND ** 2)
    np.testing.assert_allclose(np.degrees(np.arccos(cos)), 104.5, atol=1e-3)
    port = testing.water_box(n, seed=0).xyz.reshape(n, 3, 3)[:, 0]
    assert np.abs(port - sites).max() < 0.1 * 8
    assert LATTICE == testing.LATTICE
    a = water_boxes(n, 2, torch.Generator().manual_seed(9))
    b = water_boxes(n, 2, torch.Generator().manual_seed(9))
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a[0], a[1])


@pytest.mark.parametrize("n_elems", [9, 10])
def test_features_are_the_ports(n_elems):
    symbols = ["O", "H", "H", "C", "N", "S", "Br", "Cl", "F"]
    np.testing.assert_array_equal(
        elements.features(symbols, n_elems),
        table_for_n_elems(n_elems).featurize_symbols(symbols))


@pytest.mark.parametrize("sizes", [
    dict(rows=2224, cols=2224, h=32), dict(rows=35520, cols=35520, h=32),
    dict(rows=300, cols=128, h=48, live=100)])
def test_far_field_work_is_the_ports(sizes):
    mine = work.far_field(**sizes)
    theirs = kernels.work("dense_message_rowsum", **sizes)
    assert (mine.flops, mine.products, mine.bytes) == (
        theirs.flops, theirs.products, theirs.bytes)


@pytest.mark.parametrize("name,width", [("near_message_corr", 1),
                                        ("near_pass_rowsum", 2)])
@pytest.mark.parametrize("live", [None, 5000])
def test_near_work_is_the_ports(name, width, live):
    sizes = dict(n=35520, k=32, h=32, e=48)
    extra = {} if live is None else dict(live=live, live_rows=2000)
    mine = work.near(**sizes, row_width=width * 32, **extra)
    theirs = kernels.work(name, **sizes, **extra)
    assert (mine.flops, mine.products, mine.bytes) == (
        theirs.flops, theirs.products, theirs.bytes)


@pytest.mark.parametrize("workload", small.CELLS)
@pytest.mark.parametrize("tier", ["highest", "parity", "default"])
@pytest.mark.parametrize("masked", [False, True])
def test_call_flops_is_the_ports_count(workload, tier, masked):
    """The frozen count of a whole call, from the call's shapes alone,
    equals ``Predictor.benchmark_batch(cost_analysis=True)["flops"]`` on
    the CPU, and ``count_flops`` of ``predict_batch`` (k from the
    benchmark's own count of the frame); for the configurations' unmasked
    message sums and for pairwise-masked ones."""
    from epnn_tpu_torch.data.dataset import pad_molecules
    from epnn_tpu_torch.data.xyz import Molecule
    from epnn_tpu_torch.infer import Predictor
    from epnn_tpu_torch.utils.timing import count_flops
    from portbench import generator, shapes

    s = small.spec(workload, molecules=100)
    s["config"] = dict(s["config"], model=dict(s["config"]["model"],
                                                mask_messages=masked))
    model = s["config"]["model"]
    cfg = run.model_config(s["config"], tier)
    tree = weights.load(s["config"], "cpu")
    pred = Predictor(tree, cfg, device="cpu", **s["traffic"]["predictor"])
    traffic = generator.Traffic(s["traffic"], model["n_elems"], 3, "cpu",
                                pad_molecules, Molecule,
                                table_for_n_elems(model["n_elems"]))
    batch = traffic.batch(0)
    cut = model["cutoff"] + s["traffic"]["predictor"].get("neighbor_skin", 0)
    top = shapes.count(batch.xyz[0], traffic.n, cut, "cpu")[0]
    k = work.safe_k(top, traffic.n_pad)
    want = work.call_flops(model, [traffic.n_pad], [k])
    assert want["far"] > 0 and want["rest"] > 0
    got = pred.benchmark_batch(batch, iters=1, warmup_loops=1,
                               cost_analysis=True)["flops"]
    assert got == want["far"] + want["rest"]
    assert count_flops(pred.predict_batch, batch) == got


def test_tier_peaks():
    assert peaks.tier_flops("highest") == peaks.TF32_FLOPS / 3
    assert peaks.tier_flops("default") == peaks.TF32_FLOPS
    assert run.precisions("parity") == ("highest", "default")
    assert run.precisions("highest") == ("highest", "highest")
    cfg = run.model_config(small.spec(small.MD)["config"])
    from epnn_tpu_torch.models.config import dense_precision, near_precision
    assert (near_precision(cfg), dense_precision(cfg)) == ("highest",
                                                           "default")


def test_groups_name_every_kernel_of_the_ports_libraries():
    import glob
    import os
    import re

    from epnn_tpu_torch.ops import kernels as k

    names = set()
    for path in glob.glob(os.path.join(str(k.CSRC), "*.cu*")):
        src = re.sub(r"__launch_bounds__\([^)]*\)", "", open(path).read())
        names |= set(re.findall(r"__global__\s+void\s+(\w+)\s*\(", src))
    assert names and names <= set(groups.PORT)
    table = {"(anonymous namespace)::dmr_partial<3>(float const*)": 3.0,
             "sum_parts": 1.0, "nmc_kernel": 0.5, "npr_kernel": 0.25,
             "void at::native::radixSortKVInPlace<...>": 0.125,
             "sm80_xmma_gemm_f32f32": 2.0, "Memcpy DtoH": 1.5,
             "void at::native::vectorized_gather_kernel": 4.0}
    assert groups.matching(table, groups.FAR_FIELD) == 4.0
    assert groups.matching(table, groups.NEAR) == 0.75
    assert groups.torch_kernels(table) == 6.125


def test_seeded_weights_repeat():
    """A configuration serves the same weights in every run, drawn from
    its ``weights.seed``; another ``weights.seed`` draws others."""
    cfg = small.spec("decay_model.frames-35520")["config"]
    assert "seed" in cfg["weights"]
    a = weights.load(cfg, "cpu")
    b = weights.load(cfg, "cpu")
    other = dict(cfg, weights=dict(cfg["weights"],
                                   seed=cfg["weights"]["seed"] + 1))
    c = weights.load(other, "cpu")
    ka = a["message_2"]["dense_1"]["kernel"]
    assert torch.equal(ka, b["message_2"]["dense_1"]["kernel"])
    assert not torch.equal(ka, c["message_2"]["dense_1"]["kernel"])
    assert ka.dtype == torch.float32