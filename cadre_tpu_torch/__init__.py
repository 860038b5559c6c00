"""cadre_tpu_torch: the PyTorch/CUDA port of cadre_tpu for one NVIDIA H100.

This package runs the device-resident training iteration: the batched
driving env (rendered through a hand-written CUDA paint kernel), the frozen
CoPM encoder (whose dual attention is a hand-written CUDA kernel) and the
per-command policy banks act for T steps, then GAE and the PPO epochs train
the banks (`rl.device_rollout.train_device`, `python -m
cadre_tpu_torch.main`). It also runs perception pretraining, the host
simulator with its scenario runtime, the host-env PPO loops (in process
or in env worker processes) and the ensemble evals (`python -m
cadre_tpu_torch.eval`), reads and writes the JAX package's flax
checkpoints and experiment configs, and trains data-parallel over
torch.distributed (`--mesh`). It imports torch and numpy only;
`cadre_tpu` (the JAX package) is its reference and is never imported
here.
"""
