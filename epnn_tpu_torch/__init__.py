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
* :mod:`epnn_tpu_torch.infer` — ``Predictor``, the serving front end.

Importing the package compiles nothing: kernels are built with ``nvcc`` on
first use (see :func:`epnn_tpu_torch.ops.kernels.build`).
"""

__version__ = "0.1.0"
