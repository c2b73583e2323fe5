"""portbench: the benchmark of the PyTorch and CUDA serving system
(``src/repro_torch``) on one NVIDIA H100.

Everything that decides a number lives here and nowhere in the program:
the traffic generator, the arithmetic of rates and tails, the work and
peak tables behind the utilization shares, the seeded weights that both
sides are given, the plain reference and the comparison that decides
``correct``. From the program the benchmark takes only the serving engine
it drives, the engine's counters, and the names of its kernels.

Entry point: ``python portbench/run.py --workload <cell> --seed <n>
--seconds <s> --trace <0|1>``. Cells, configurations, traffic mixes and
metrics are found by name (``BENCHMARK.json`` and the files beside this
one), so adding one adds files and edits none.
"""
