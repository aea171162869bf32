"""Benchmark of ``mast3r_slam_tpu_torch`` on NVIDIA GPUs: ``python -m
gpubench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>``."""
