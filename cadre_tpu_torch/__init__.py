"""cadre_tpu_torch: the PyTorch/CUDA port of cadre_tpu for one NVIDIA H100.

This package runs the acting half of the device-resident iteration: the
batched driving env (rendered through a hand-written CUDA paint kernel), the
frozen CoPM encoder (whose dual attention is a hand-written CUDA kernel) and
the per-command policy banks. It imports torch and numpy only; `cadre_tpu`
(the JAX package) is its reference and is never imported here.
"""
