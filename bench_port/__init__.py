"""The benchmark of ``multithreadedgameengine_tpu_torch`` on one NVIDIA GPU:
``python3 bench_port/run.py --workload <name> --seed <n> --seconds <s>
--trace <0|1>`` from the root of a checkout runs one cell of
``BENCHMARK.json`` once and prints one JSON line."""
