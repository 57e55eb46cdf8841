"""portbench: the benchmark of ``delora_tpu_torch``, the PyTorch/CUDA port.

One run measures one cell (a configuration under a traffic mix) once:

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

Everything that belongs to one configuration, traffic mix, scene or metric is a
file of its own, found by the name ``BENCHMARK.json`` gives it (see
``README.md``). The plain reference that decides ``correct`` lives in
``reference/`` and imports nothing of the program.
"""
