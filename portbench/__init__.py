"""portbench: the benchmark of the PyTorch/CUDA port (``nbodyhpc_tpu_torch``).

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once; see README.md.
"""
