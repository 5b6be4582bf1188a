"""epnn_tpu_torch — the PyTorch/CUDA port of :mod:`epnn_tpu`.

Electron-passing neural networks (charge-conserving graph networks that
predict per-atom partial charges), served on an NVIDIA H100.  The module
names follow the JAX package so each file has an obvious counterpart:

* :mod:`epnn_tpu_torch.models` — ``EPNNConfig``, the dense ``EPNN`` module;
* :mod:`epnn_tpu_torch.ops.fused` — the neighbor-split blocked forward;
* :mod:`epnn_tpu_torch.ops.kernels` — the hand-written CUDA kernels of that
  forward (``csrc/*.cu``) with a plain PyTorch version beside each;
* :mod:`epnn_tpu_torch.ops.cluster` — the weighted k-means of the clustered
  far-field tier;
* :mod:`epnn_tpu_torch.infer` — ``Predictor``, the serving front end;
* :mod:`epnn_tpu_torch.train` — ``train()`` and its steps;
* :mod:`epnn_tpu_torch.cli` — ``python -m epnn_tpu_torch <command>``, and
  the tools under it: :mod:`~epnn_tpu_torch.io.tf_import` (reference TF
  checkpoints), :mod:`~epnn_tpu_torch.analysis` (polarization response),
  :mod:`~epnn_tpu_torch.data.horton`, :mod:`~epnn_tpu_torch.data.qm9`,
  :mod:`~epnn_tpu_torch.compat` and :mod:`~epnn_tpu_torch.utils.timing`.

Importing the package compiles nothing: kernels are built with ``nvcc`` on
first use (see :func:`epnn_tpu_torch.ops.kernels.build`).
"""

__version__ = "0.1.0"

from epnn_tpu_torch import compat, data, models
from epnn_tpu_torch.elements import (
    INFER_TABLE,
    TRAIN_TABLE,
    ElementTable,
    table_for_n_elems,
)
from epnn_tpu_torch.featurize import rbf_edges, rbf_edges_np

__all__ = [
    "ElementTable",
    "INFER_TABLE",
    "TRAIN_TABLE",
    "compat",
    "data",
    "models",
    "rbf_edges",
    "rbf_edges_np",
    "table_for_n_elems",
]
