"""The benchmark of picaso_tpu_torch on one NVIDIA H100.

``python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once.  The harness
(:mod:`benchmark.harness`) reads every configuration, traffic mix, limit,
layer and per-layer metric from the data files under this folder by name;
:mod:`benchmark.reference` is the frozen plain reference that decides
``correct`` and the operation and byte counts that the rooflines divide.
"""
