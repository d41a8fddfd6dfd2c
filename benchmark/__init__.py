"""The benchmark of monodepth2_torch on an NVIDIA H100: one run of one cell
is `python3 -m benchmark.run --workload <name> --seed <n> --seconds <s>
--trace <0|1>` from the root of a checkout (see run.py)."""
