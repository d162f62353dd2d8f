"""The benchmark of dmi_tpu_torch on an NVIDIA H100: one command runs one
cell of BENCHMARK.json and prints one JSON line (portbench/run.py)."""
