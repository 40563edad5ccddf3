"""The benchmark of sisr_tpu_torch; ``python3 benchmark/run.py --help``."""
