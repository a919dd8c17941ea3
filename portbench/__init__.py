"""The benchmark of the PyTorch and CUDA port (``shadowkv_tpu_torch``).

``python -m portbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` on one card and prints
one JSON result line. Everything a cell needs is found by name: its
configuration in ``configs/``, its traffic mix in ``traffic/`` (a data
file read by the driver its ``kind`` names), its per-layer metrics in
``metrics/`` and its correctness limits in ``limits/``. The plain
reference that decides ``correct`` is in ``reference/`` and imports
nothing of the port.
"""
