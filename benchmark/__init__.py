"""The benchmark of the PyTorch and CUDA port (``e4s_tpu_torch``).

``python benchmark/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` on the GPUs of this
machine and prints one JSON line. ``harness/`` is the general code;
``configs/``, ``traffic/``, ``systems/``, ``entries/``, ``layers/`` and
``metrics/`` hold one file per configuration, traffic mix, system under
test, entry point, layer and metric family, found by name; ``reference/``
is the plain PyTorch reference that decides ``correct``.
"""
