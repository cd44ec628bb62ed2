"""The benchmark of the PyTorch and CUDA port (``rslmtoasa_tpu_torch``).

``python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` on the card and prints
one JSON line; see :mod:`benchmark.harness`.  Nothing here imports JAX or
the JAX package, and :mod:`benchmark.reference` imports nothing of the port.
"""
