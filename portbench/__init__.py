"""The benchmark of the PyTorch and CUDA port (cadre_tpu_torch) on one
NVIDIA H100: `python3 portbench/run.py --workload <cell> --seed <n>
--seconds <s> --trace <0|1>`, cells as BENCHMARK.json lists them."""
