"""The benchmark of ``epnn_tpu_torch`` on one NVIDIA H100.

``python -m portbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json``; see ``README.md``.
Nothing here imports JAX or the JAX package; ``portbench.reference``
imports nothing of the port either."""
