"""The benchmark of ``animal_vision_tpu_torch`` on NVIDIA H100 cards.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

``BENCHMARK.json`` at the repository root names the cells; each cell's
configuration (``configs/``), traffic mix (``traffic/``), plain reference
(``reference/``), work counts (``work/``) and per-layer metric readers
(``metrics/``) sit in files of their own, found by name.
"""
