#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (cadre_tpu_torch) on one NVIDIA GPU and check it.

Usage, from the root of the checkout, on a machine with a CUDA GPU and nvcc:

    python3 chip_smoke.py

Phases, each of which must pass:
  1. the card, its power limit, and the torch / CUDA / nvcc versions;
  2. build of every hand-written kernel from cadre_tpu_torch/csrc/;
  3. each kernel against its plain PyTorch version on the card: paint
     bit-equal on random, tile-edge and main-path tables and on those of
     an eval-tier env and a hazard env, dual attention at every shape the
     port calls it with (the eval's B=25, the trainer's B=48 f32 and the
     host-env trainer's f32 B=8 and B=64 among them; the resnet50 head,
     C=512 and Cqk=64, at B=32, 256 and 48; a 288x512 camera's P=144 and
     an 800x600 camera's P=475) and at every position tile, key tile and
     template it picks (P = 1 to 1537; the bf16 PAM either side of the P
     past which it no longer keeps its energies), the wide kernel's CAM
     and PAM sides each alone (bf16: its gram, softmax and apply launches
     too), timed and equal to the whole kernel's outputs, with each
     launch's registers and blocks an SM;
     its backward kernel at B=48 (C=128 and 512, P=40, 144 and 475), at
     phase 5's small head and at every cluster size of its two kernels
     (C = 32 to 512, one or two 32-row groups a rank), P = 1 to 1024 and
     Cqk up to 64, with non-zero gammas, two calls bit-equal, and a bf16
     call that needs a gradient refused; timings against each kernel's
     bound and, for dual attention and its backward, a PyTorch yardstick;
     the fused convolution (`ops/conv_epilogue.py`) against its plain
     version at every folded convolution of a resnet18 and a resnet50
     latent at 144x256, in f32 and bf16, with its count a latent;
  4. the main path: a bf16 CoPM agent at production width drives 32 device
     envs for a 20-step rollout, then trains one whole iteration at
     production size (T=200, 4 PPO epochs of 2 minibatches) after a T=2
     warm-up iteration, with every kernel's launch count and the folded
     encoder's fused convolutions read around each of those two runs and
     one latent; a profile of one update;
  5. the CUDA path against the CPU path of the same port on a small input:
     rollout pieces and one fused PPO update;
  6. the training CLI, `python -m cadre_tpu_torch.main --env jax`, for two
     iterations of 32 envs x 20 steps, and its snapshot read back;
  7. the eval path: (a) a bank of 25 Town01 routes traced from a route XML
     the script writes, three of them 12 m long; (b) the ensemble eval of
     8 member snapshots with the bf16 production encoder, 25 envs pinned
     to the routes, 200 steps, with every kernel's launch count read
     around it and a scored row for each short route, and a profile of a
     few eval steps; (c) one training iteration with the NoCrash options
     (priority routes, hazards, stop signs) on a bank of Town01 traces,
     four envs started halfway along past their route timeout so that
     their episodes end and their routes' priorities move; (d) the eval
     on the card against the eval on the CPU from the same draws; (e) the
     scripted expert over the eval bank;
  8. perception pretraining and the cascade handoff: (a) 4 shards of 48
     frames in the loader's format, from a seed, under
     build/smoke_perception/; (b) the full-width DANet (output mode 12,
     f32) trained at B=48 through PerceptionTrainer.solve for one epoch of
     4 steps, then 20 steps on one repeated batch, with launch counts (one
     forward and one backward kernel per step), a falling loss, the
     backbone, conv5a and both gammas moved, peak memory, frames/s and a
     profile of a few steps; (c) one train step of a small model on the
     card against the CPU; (d) `python -m cadre_tpu_torch.train_perception`
     on the shards; (e) `python -m cadre_tpu_torch.main --danet-checkpoint`
     on (b)'s checkpoint, and an agent built from it giving the latent of
     the trainer's net folded as the agent folds it bit for bit;
  9. the host-env path (`--env sim`): the f32 production encoder trains one
     train_vec iteration on 8 kinematic sim envs with traffic, T=200 fused
     ticks, 4 PPO epochs of 2 minibatches, after a T=2 warm-up, with every
     kernel's launch count read around it (one dual-attention launch per
     tick and one for the bootstrap), the act / env / update split, peak
     memory and a profile of a whole T=20 train_vec iteration; one episode
     of `train` (`--num-envs 1`) on one sim env, T=20, its launches counted
     (one per act, each encoding the 8-frame window, and one for the
     bootstrap unless the episode ends on its last step); then `python -m
     cadre_tpu_torch.main --env sim` with 8 envs for two iterations of 20
     steps and with one env for one episode, and both snapshots read
     back;
 10. the host-env eval and the process envs at production width (f32
     encoder): (a) `rl.evaluate.evaluate` of 4 member snapshots over 2
     sim episodes of at most 200 ticks on two routes the script writes
     with town_maps.write_lane_routes, each armed with Scenario1, 3, 7 and
     10 triggers, its launches counted (one dual-attention launch per
     tick), ticks/s, mean completion, driving score and the criteria
     CSV's rows; (b) that eval on the card against the CPU from the same
     draws (small agent); (c) `python -m cadre_tpu_torch.eval --env sim`
     on a 12 m route with the scenarios; (d) the native route rasterizer
     bit-equal to numpy; (e) one train_vec iteration of 8 sim envs in
     worker processes (`--proc-envs`), T=200, launches counted, its
     env-steps/s and act / env / update split beside phase 9's in-process
     iteration, with the card's name and power limit, and the 8 envs
     stepped alone, in process and in workers.
 11. the perception zoo at full width (f32): (a) 1,024 expert frames in two
     shards collected with `collect_dataset` from the port's sim with the
     perception CLI's collection settings (8 vehicles, 8 walkers, random
     weather, 3/3/3 s lights), frames/s, at least 4 seg classes and 2
     light states; (b) auto_da_beta_vae (DANet trunk, K2 and K3) through
     `PerceptionTrainer(model=...)`: one epoch of solve at B=48 on shard 0
     with shard 1 as eval_loader, its recon PNGs read back, launches
     counted, then 20 timed steps on one batch (one K2 and one K3 each, a
     falling loss, the backbone and both gammas moved), peak memory, a
     profile; 20 timed CILTrainer steps of a CilrsNet; (c) one train step
     of a small DABetaVAE and of a CilrsNet on the card against the CPU;
     (d) `train_perception --experiment auto_danet_exp50 --holdout` in
     process with its launches counted, `train_perception --collect 96
     --model oldv2_vae` and `python -m cadre_tpu_torch.train_cil`, every
     checkpoint read back.
 12. the checkpoint and config utilities and data-parallel training: (a)
     phase 8b's DANet written as a JAX-format .msgpack (import_danet_torch,
     save_pytree) and read back, the writer's and reader's MB/s, an agent
     built from it giving the folded trainer's f32 latent bit for bit; 4 member
     snapshots saved as .msgpack with their optax .opt, `python -m
     cadre_tpu_torch.eval --env sim` on them in process for one episode,
     its K2 launches counted; a reference-format ppo_model_0.pt
     ('{steer,throttle}_{ppo,lstm}_{k}' state_dicts) of member 0 acting
     as member 0; `main --config config_files/agent_config.py --env sim
     --num-envs 2 --iterations 1` as a process; (b) world size 1 over
     NCCL, each under `torchrun --standalone --nproc-per-node 1`:
     `train_perception --mesh` for one epoch on 8a's shards with the
     holdout report, 20 timed data-parallel perception steps at B=48 f32
     after a warm-up (ms, frames/s, peak memory, one K2 and one K3 per
     step, a profile) beside 8b's step, then 20 more with the
     cross-replica BatchNorm forced on (world 1 keeps the plain one),
     `main --mesh data` on --env jax (N=32,
     T=20) and on --env sim (8 envs); (c) two gloo ranks sharing the card:
     3 full-width steps at 24 frames per rank (parameters and BatchNorm
     statistics bit-equal across the ranks after each, a falling loss,
     one K2 and one K3 per step per rank), phase 8c's small head on two
     ranks on the card against two ranks on the CPU within 8c's bounds,
     the sharded fused update at F=530 (32 envs split 16/16, one
     minibatch, E=1) against the world-1 update of all 32 envs (rtol
     2e-4, atol 2e-5), and the summed distributed update on the card
     against the CPU. Every process has a deadline: a process-group
     timeout, and a parent that kills what outlives its limit.
 13. the policy-bank options and the scenario harness: (a) a bf16 CoPM
     agent with memory 'transformer' and the ordinal head trains one T=2
     train_device iteration, then one whole counted iteration at
     production size (N=32, T=200, 4 PPO epochs of 2 minibatches: two
     paints and one dual attention per step and the bootstrap's), finite,
     every parameter but the attention key biases (zero gradient) moved,
     the act / update split and peak memory; (b) one train_device
     iteration with use_lstm=False at T=20, launches counted; (c) 8
     transformer + ordinal members written as .msgpack by save_snapshot,
     read back bit for bit, and their ensemble eval of 25 pinned envs for
     20 steps, launches counted; (d) act_batch and one fused update of
     small transformer + ordinal banks on the card against the CPU; (e)
     an .xosc storyboard written for a sim env's route, read by
     load_openscenario and run by build_manager on that SimDrivingEnv
     driven by an NpcAgent for 300 ticks, then ResultOutputProvider's
     text and JUnit report (CPU work, no JAX, no tabulate).
 14. the CARLA env and the last three CLIs, on tests/torch_carla_stub.py
     (an in-process fake of the `carla` client API installed as `carla`:
     there is no CARLA server here; every figure is the stub world's):
     (a) `main --env carla --num-envs 4` in process, one stub world at
     each EnvConfig port (a red light on the first; Scenario1, 3 and 2
     triggers), one train_vec iteration at T=200 with its launches (one
     dual attention per tick and the bootstrap's), env-steps/s, the act /
     env / update split, the scenario actors spawned and the CARLA-side
     host time per tick (sensor fan-in, planner, control + criteria, the
     stub's tick); (b) `--num-envs 1 --episodes 1` through `train`; (c)
     `python -m cadre_tpu_torch.eval --env carla` of (a)'s and (b)'s
     snapshots over one episode of a 12 m route, its rows printed; (d)
     `simple_test`, its PNG read back equal to the last tick's frames;
     (e) `run_scenario` for a registry scenario and 13e's `.xosc`; (f)
     `run_nocrash_eval` at N=32, T=200, two iterations, the eval of the
     two snapshots over 25 Town01 routes for 200 steps, its paint and
     dual-attention launches counted, its rows printed.
 15. the deep-backbone CoPM at full width (144x256, resnet50: the head's
     K2 and K3 at C=512, Cqk=64): (a) experiment_params('auto_danet',
     backbone='resnet50') through PerceptionTrainer, 20 timed steps on
     one batch at B=48, f32, TF32 off, after a warm-up, one K2 and one K3
     each, a falling loss, frames/s, peak memory and a profile; (b) one
     DABetaVAE step on a resnet50 trunk; (c) the bf16 encoder latent at
     B=32 and 256, frames/s; (d) one whole device iteration (N=32, T=200,
     E=4, M=2) with that encoder: 400 paints and 201 K2; (e) one f32
     pretraining step of a resnet18 DANet on a 288x512 camera (the head's
     P=144); (f) one at B=16 on CARLA's default 800x600 camera (feat
     19x25, the head's P=475) on 8a's frames resized, one K2 and one K3;
     (g) the bf16 latent (DANet.latent as the agent runs it) of a
     resnet18 and of a resnet50 DANet on that camera at B=32, frames/s,
     one K2 each (the head's bf16 P=475 at C=128 and 512) and K2's device
     time beside the latent's (torch.profiler), then K2 and K3
     timed at (f)'s B=16 shape. Peak memory and the device's idle share
     for each.

It prints one JSON line of kernel figures (launch counts of every phase's
main path, `launches_msgpack_eval` of 12a, `launches_parallel` of 12b
and of each 12c rank, `launches_options` of 13a, `launches_carla` of 14a,
`launches_nocrash` of 14f and `launches_deep` of 15a, 15d and 15g among
them;
under `shapes` each kernel's figures at every timed shape), the card's
name and power limit, and,
last, {"ok": true, "device": {...}}. It exits non-zero, printing no
result, without a CUDA GPU or without the package beside it.

    python3 chip_smoke.py --mesh-step SHARDS

is phase 12b's worker, which the script starts under torchrun.

    python3 chip_smoke.py --kernel-times ROOT [ROOT ...]

times the paint, dual-attention and (where a checkout has it) the
dual-attention backward wrappers of each checkout ROOT (a
directory holding `cadre_tpu_torch/`, built there at first use) on the same
inputs, one process per ROOT in the order given, two ways: a CUDA graph of
200 calls, and 200 calls issued one by one; a shape a checkout refuses
(ValueError) reads n/a. Give the checkouts to compare as A B B A to see
the spread between runs.

    python3 chip_smoke.py --conv-times

times each folded convolution of the resnet18 and resnet50 latents at the
benchmark's shapes (B=2048, 144x256, f32 channels_last, TF32 as torch
defaults it) three ways: bare, as the unfolded net runs it (convolution,
BatchNorm, [residual add,] ReLU) and fused (`ops/conv_epilogue.py`); then
the whole latent unfolded and folded. These figures chose cuDNN's fused
convolution over a hand-written epilogue.

    python3 chip_smoke.py --phase-times ROOT [ROOT ...]

runs phases 1, 2, 4, 8, 9 and 15 of each checkout ROOT with that
checkout's own chip_smoke.py, one process per ROOT in the order given,
and prints phase 4's iteration line, phase 8b's pretraining line, phase
9's train_vec and `train` lines and phase 15a's resnet50 pretraining
line of each: the same-card comparison of the device iteration,
pretraining, the host-env iterations and deep-backbone pretraining of
two commits.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time

# H100 SXM peaks (NVIDIA data sheet, dense): bytes/s of HBM3, FLOP/s of
# fp32 outside the tensor cores and of bf16 and tf32 in the tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
BF16_TC_FLOPS = 989e12
TF32_TC_FLOPS = 495e12

N_ENVS = 32
T_STEPS = 20
# the eval: one env per route of the NoCrash eval XMLs' 25 routes, K
# member snapshots (scripts/run_nocrash_eval.py --eval-members), cut to
# EVAL_STEPS of the script's 8,000 steps
EVAL_ENVS = 25
EVAL_MEMBERS = 8
EVAL_STEPS = 200
# of the eval's routes, the last EVAL_SHORT run 12 m along one lane: their
# episodes end (by the route timeout at 154 steps, if nothing sooner)
# within EVAL_STEPS whatever the random members do, so rows are scored
EVAL_SHORT = 3
# envs of the NoCrash training iteration that start past their route
# timeout halfway along their routes, so that episodes end and priorities
# move within its T_STEPS
NOCRASH_PINNED = 4
# the training iteration's steps: RolloutConfig's default and the shape of
# the JAX package's scripts/bench_device_env.py::bench_train
T_TRAIN = 200
# bf16 kernel vs plain: both round the same f32 sums, in another order, so
# an attention weight or the residual may land one bf16 step apart; bound
# the difference in bf16 units in the last place of max(|plain|, |x|).
BF16_ULP_BOUND = 4.0


class PhaseError(RuntimeError):
    pass


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseError(msg)


def _counted(fn):
    """fn()'s result and each kernel's launches while it ran."""
    from cadre_tpu_torch.ops import dual_attention, paint

    paint.launches = 0
    dual_attention.launches = 0
    dual_attention.backward_launches = 0
    out = fn()
    return out, {"paint": paint.launches,
                 "dual_attention": dual_attention.launches,
                 "dual_attention_bwd": dual_attention.backward_launches}


def device_ms(fn, iters: int = 200) -> float:
    """Mean device milliseconds of `fn()` over `iters` calls captured in
    one CUDA graph and replayed (CUDA events around the replay), so that
    the host's cost of issuing each call does not count."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def time_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean milliseconds of `fn()` over `iters` calls issued one by one
    (CUDA events): the device's time, or the host's where issuing the
    calls takes longer."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ---------------------------------------------------------------- phase 1

def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else \
        "nvidia-smi gave nothing"


# the agent's encoder on the card is folded (BatchNorm in the convolutions,
# the epilogue fused), so its f32 latent is the unfolded net's to float32
# rounding, not bit for bit (the CPU tests read 1e-5 at most)
FOLD_TOL = 1e-4
# the fused convolution against its plain version (relative RMS): f32 with
# TF32 off, and bf16 within BF16_ULP_BOUND steps of the output's scale (the
# plain version rounds the convolution, the bias and the add each to bf16)
CONV_TOL = {"float32": 1e-5, "bfloat16": BF16_ULP_BOUND * 2.0 ** -8}


def folded_latent_gap(got, want) -> float:
    """Relative RMS gap of a folded encoder's latent to the unfolded
    net's."""
    return float((got.double() - want.double()).norm()
                 / want.double().norm())


def fused_convs_per_latent(arch: str) -> int:
    """Fused convolutions (`ops/conv_epilogue.py`) of one folded latent:
    the stem, each block's two or three (a downsample runs bare) and
    DANetHead's four."""
    from cadre_tpu_torch.models.resnet import RESNET_SPECS

    block, depths = RESNET_SPECS[arch]
    return 1 + sum(depths) * (3 if block.expansion == 4 else 2) + 4


def _fused_counted(fn):
    """fn()'s result and the fused convolutions it ran."""
    from cadre_tpu_torch.ops import conv_epilogue

    conv_epilogue.launches = 0
    out = fn()
    return out, conv_epilogue.launches


def folded_like_the_agent(model):
    """An eval-mode copy of `model` folded as `CadreAgent.create` folds a
    CUDA agent's encoder: on the CPU, in f32, then moved to the card
    channels_last."""
    import copy

    import torch

    from cadre_tpu_torch.models.danet import fold_batch_norms

    net = fold_batch_norms(copy.deepcopy(model).cpu().eval())
    return net.to("cuda", memory_format=torch.channels_last)


def _randomised_batch_norms(net, gen):
    """`net` with every BatchNorm's statistics and affine drawn away from
    (0, 1), so that each folded bias is non-zero."""
    import torch

    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, torch.nn.modules.batchnorm._BatchNorm):
                n = m.num_features
                m.running_mean.copy_(0.5 * torch.randn(n, generator=gen))
                m.running_var.copy_(0.2 + 3.0 * torch.rand(n, generator=gen))
                m.weight.copy_(1.0 + 0.2 * torch.randn(n, generator=gen))
                m.bias.copy_(0.2 * torch.randn(n, generator=gen))
    return net


def no_tf32() -> None:
    """Every f32 convolution and matmul in f32, not TF32: the setting of
    every phase, and of each process the script starts itself."""
    import torch

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def phase_card() -> str:
    import torch

    from cadre_tpu_torch.ops import _build

    card = card_line()
    nvcc_v = subprocess.run([_build.nvcc(), "--version"], capture_output=True,
                            text=True, timeout=60).stdout.strip().splitlines()
    no_tf32()
    print(f"[1] card: {card}")
    print(f"[1] torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}, nvcc: {nvcc_v[-1]}")
    print(f"[1] cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
          f"cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")
    return card


# ---------------------------------------------------------------- phase 2

def phase_build() -> None:
    from cadre_tpu_torch.ops import _build

    seconds = _build.build()
    print(f"[2] built {sorted(seconds)} in {max(seconds.values()):.2f} s "
          f"(one nvcc per source, in parallel)")
    for name, log in sorted(_build.build_log.items()):
        for line in log.splitlines():
            if "Compiling entry function" in line:
                # the kernel's mangled name, cut to its name and template
                entry = line.split("'")[1] if "'" in line else line
                entry = entry[entry.rfind("dual_attention"):][:48]
                print(f"[2] {name}: entry {entry}")
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"[2] {name}: {line.strip()}")


# ---------------------------------------------------------------- phase 3

def _paint_tables(n, h, w, n_rect, n_disk, disk_r2, gen, device):
    """Random [n, n_rect + n_disk, 8] tables over an h x w canvas, kinds
    interleaved so that the row order matters, a third of rows masked."""
    import torch

    from cadre_tpu_torch.ops import paint

    def u(*shape, lo=0.0, hi=1.0):
        return lo + (hi - lo) * torch.rand(*shape, generator=gen,
                                           device=device)

    rows = []
    if n_rect:
        u0 = u(n, n_rect, lo=-10.0, hi=w)
        v0 = u(n, n_rect, lo=-10.0, hi=h)
        rows.append(paint.rect_rows(u0, u0 + u(n, n_rect, hi=40.0), v0,
                                    v0 + u(n, n_rect, hi=40.0),
                                    u(n, n_rect, 3, hi=255.0),
                                    u(n, n_rect) > 0.3))
    if n_disk:
        r2 = torch.full((n, n_disk), disk_r2, device=device) if disk_r2 \
            else u(n, n_disk, lo=1.0, hi=300.0)
        rows.append(paint.disk_rows(u(n, n_disk, hi=w), u(n, n_disk, hi=h),
                                    r2, u(n, n_disk, 3, hi=255.0),
                                    u(n, n_disk) > 0.3))
    table = torch.cat(rows, dim=1)
    perm = torch.randperm(table.shape[1], generator=gen, device=device)
    return table[:, perm].contiguous()


def paint_edge_tables(h, w, seed=0):
    """Tables that test the paint kernel's per-tile cull at its edges, for
    an h x w canvas and the kernel's tile (`paint.kernel_tile()`, read from
    its source): numpy [S, 8] f32 rows by case name.

      disk_borders  disks whose r2 is 0, an exact square or a quarter,
                    centred on tile borders, beside them and on half pixels;
      rect_borders  rects whose edges fall on tile borders, on integers and
                    on fractions;
      masked        rows off the canvas, empty and inverted rects, negative,
                    -0.0 and NaN r2, -1e6 and infinite centres, between
                    rows that paint;
      long          640 overlapping rows around three spots, so that one
                    tile keeps rows of several cull chunks and their order
                    decides each pixel.
    """
    import numpy as np

    from cadre_tpu_torch.ops import paint

    rng = np.random.RandomState(seed)
    tw, th = paint.kernel_tile()
    xb = np.unique(np.r_[np.arange(0, w + 1, tw), w]).astype(np.float32)
    yb = np.unique(np.r_[np.arange(0, h + 1, th), h]).astype(np.float32)
    near = np.float32([-1.0, -0.5, 0.0, 0.5, 1.0])
    frac = np.float32([-1.0, -0.5, -0.25, 0.0, 0.25, 0.5, 1.0])

    def rows(kind, a, b, c, d):
        n = len(a)
        return np.concatenate([
            np.stack([np.full(n, kind), a, b, c, d], -1),
            rng.uniform(0, 255, (n, 3))], -1).astype(np.float32)

    def pick(values, n):
        return rng.choice(values, n).astype(np.float32)

    n = 400
    squares = np.float32([0, 0.25, 1, 2.25, 4, 9, 16, 25, 56.25, 64, 100,
                          289])
    disks = rows(1.0, pick(xb, n) + pick(near, n),
                 pick(yb, n) + pick(near, n), pick(squares, n),
                 np.zeros(n))
    a = pick(xb, n) + pick(frac, n)
    c = pick(yb, n) + pick(frac, n)
    widths = np.float32([0.25, 0.5, 1, 1.5, 2, 8, 31, 32, 33])
    on_border = rng.rand(n, 2) < 0.5
    b = np.where(on_border[:, 0], pick(xb, n) + pick(frac, n),
                 a + pick(widths, n))
    d = np.where(on_border[:, 1], pick(yb, n) + pick(frac, n),
                 c + pick(widths, n))
    rects = rows(0.0, a, b, c, d)

    big, nan, inf = 1e6, np.nan, np.inf
    masked = np.concatenate([
        # rects off each side of the canvas, empty, inverted, far away
        rows(0.0, [w, -10, 0, 0, 10, 20, 5, -big],
             [w + 10, 0, w, w, 10, 10, 9, -big + 5],
             [0, 0, h, -5, 0, 0, 4, 0], [h, h, h + 5, 0, h, h, 4, h]),
        # disks: masked r2, far masked centres, off-canvas centres (one
        # reaching in), r2 = 0 and -0.0 on an integer centre, NaN and inf
        rows(1.0, [10, 10, 10, -big, -big, 10, w + 20, w + 5, 40, 5, nan,
                   10, inf, 30],
             [8, 8, 8, -big, 8, -big, 8, 8, 16, 5, 8, 8, 8, 3],
             [-1, -1e-3, -1e30, 56.25, 56.25, 56.25, 100, 100, 0, -0.0,
              100, nan, 100, 4], np.zeros(14)),
    ])
    lo = rng.uniform(-5, [w, h], (24, 2))
    hi = lo + rng.uniform(1, 40, (24, 2))
    painting = rows(0.0, lo[:, 0], hi[:, 0], lo[:, 1], hi[:, 1])
    masked = np.concatenate([masked, painting])
    masked = masked[rng.permutation(len(masked))]

    spots = np.float32([[w * 0.3, h * 0.4], [w * 0.7, h * 0.6],
                        [tw * 2.0, th * 3.0]])
    n = 640
    at = spots[rng.randint(0, 3, n)] + rng.uniform(-20, 20, (n, 2))
    size = rng.uniform(1, 20, (n, 2)).astype(np.float32)
    is_disk = rng.rand(n) < 0.5
    long = np.where(
        is_disk[:, None],
        rows(1.0, at[:, 0], at[:, 1], size[:, 0] * size[:, 1] / 2.0,
             np.zeros(n)),
        rows(0.0, at[:, 0], at[:, 0] + size[:, 0], at[:, 1],
             at[:, 1] + size[:, 1]))
    return {"disk_borders": disks, "rect_borders": rects, "masked": masked,
            "long": long}


def _main_path_paint_tables(device, steps=4, bank=None, cfg=None,
                            n=N_ENVS):
    """The (base, table) pairs the main path paints: the route figure and
    the camera of `n` envs over the rollout's route bank (or `bank`, with
    env config `cfg`), after each of a few steps under random controls."""
    import torch

    from cadre_tpu_torch.envs import torch_env as te

    bank = bank if bank is not None else te.make_route_bank(16, seed=0,
                                                            device=device)
    env = te.DrivingEnv(bank, num_envs=n, seed=5, device=device,
                        config=cfg or te.EnvConfig())
    gen = torch.Generator(device=device)
    gen.manual_seed(5)
    state, _ = env.reset()
    tables = []
    for _ in range(steps):
        u = torch.rand(n, 2, generator=gen, device=device)
        controls = torch.stack([0.6 * u[:, 0] - 0.3, u[:, 1],
                                torch.zeros_like(u[:, 0])], -1)
        state, _ = env.step(state, controls)
        scal = te._scalars(env.cfg, bank, state)
        tables.append({"fig": te._fig_table(env.cfg, bank, state, scal),
                       "rgb": te._rgb_table(env.cfg, bank, state)})
    return tables


def _every_row_tests(table, h, w):
    """fp32 operations of the first paint design in one call, which
    tested every row at every pixel (about 6 for a disk, 4 for a rect).
    A count of that design's work, not a bound."""
    disks = float((table[..., 0] > 0.5).sum())
    rects = float(table.shape[0] * table.shape[1]) - disks
    return h * w * (6.0 * disks + 4.0 * rects)


def _paint_case(what, base, table, timed):
    """Hold the kernel bit-equal to the plain version on one (base, table);
    with `timed`, time both. Returns its figures."""
    import torch

    from cadre_tpu_torch.ops import paint

    out = paint.paint_shapes(base, table)
    ref = paint.paint_shapes_ref(base, table)
    torch.cuda.synchronize()
    diff = int((out != ref).sum())
    require(diff == 0, f"paint {what}: {diff} values differ from plain")
    changed = int((ref != base).any(-1).sum())
    require(changed > 0, f"paint {what}: the table painted nothing")
    fig = dict(err=float((out - ref).abs().max()), changed=changed,
               bytes=2 * base.numel() * 4 + table.numel() * 4,
               every_row_tests=_every_row_tests(table, base.shape[1],
                                                base.shape[2]))
    if timed:
        fig["ms"] = device_ms(lambda: paint.paint_shapes(base, table))
        fig["call_ms"] = time_ms(lambda: paint.paint_shapes(base, table), 200)
        fig["plain_ms"] = time_ms(lambda: paint.paint_shapes_ref(base, table),
                                  3, 1)
    return fig


def check_paint(gen, device):
    import torch

    from cadre_tpu_torch.ops import paint

    canvases = {"fig": (256, 144, 1), "rgb": (144, 256, 3)}
    # random tables at the main path's row counts: the route figure's 103
    # disks of the ribbon width, the camera's 108 rects and 32 disks
    random_rows = {"fig": (0, 103, 56.25), "rgb": (108, 32, None)}
    figs = {}
    for name, (h, w, c) in canvases.items():
        base = 255.0 * torch.rand(N_ENVS, h, w, c, generator=gen,
                                  device=device)
        table = _paint_tables(N_ENVS, h, w, *random_rows[name], gen, device)
        figs["random", name] = _paint_case(f"random {name}", base, table,
                                           True)
        for case, rows in paint_edge_tables(h, w).items():
            t = torch.as_tensor(rows, device=device)
            t = torch.stack([t, t.flip(0)]).contiguous()  # env 1: reversed
            b = base[:2].contiguous()
            figs[case, name] = _paint_case(f"{case} {name}", b, t, False)
            print(f"[3] paint {case} {name}: {h}x{w}x{c}, {t.shape[1]} "
                  f"rows, 2 envs: bit-equal to plain "
                  f"({figs[case, name]['changed']} px painted)")
        # the longest table the wrapper takes, whose shared memory is
        # within a row of the 48 KB limit; one row more is refused
        n_rect = paint.MAX_ROWS // 2
        t = _paint_tables(2, h, w, n_rect, paint.MAX_ROWS - n_rect, None,
                          gen, device)
        figs["max_rows", name] = _paint_case(f"max_rows {name}", base[:2],
                                             t, False)
        try:
            paint.paint_shapes(base[:2], torch.cat([t, t[:, :1]], 1))
            refused = False
        except ValueError:
            refused = True
        require(refused, f"paint took {paint.MAX_ROWS + 1} rows")
        print(f"[3] paint max_rows {name}: {paint.MAX_ROWS} rows, 2 envs: "
              f"bit-equal to plain; {paint.MAX_ROWS + 1} rows refused")
    steps = _main_path_paint_tables(device)
    for i, step in enumerate(steps):
        for name, (base, table) in step.items():
            figs[f"main{i}", name] = _paint_case(
                f"main path step {i} {name}", base, table, i == len(steps) - 1)
    print(f"[3] paint main path: fig and rgb tables of {len(steps)} env "
          f"steps at N={N_ENVS}: bit-equal to plain")
    from cadre_tpu_torch.envs import torch_env as te

    options = {
        "eval tier": (eval_bank(device), eval_env_config(), EVAL_ENVS),
        "hazards": (None, te.EnvConfig(n_hazards=2, n_junction_hazards=1),
                    N_ENVS)}
    for what, (bank, cfg, n) in options.items():
        for i, step in enumerate(_main_path_paint_tables(device, 2, bank,
                                                         cfg, n)):
            for name, (base, table) in step.items():
                _paint_case(f"{what} step {i} {name}", base, table, False)
        print(f"[3] paint {what}: fig and rgb tables ({table.shape[1]} "
              f"camera rows) of 2 env steps at N={n}: bit-equal to plain")
    last = f"main{len(steps) - 1}"
    for kind in ("random", last):
        for name, (h, w, c) in canvases.items():
            f = figs[kind, name]
            print(f"[3] paint {kind} {name}: N={N_ENVS} {h}x{w}x{c}: "
                  f"kernel {f['ms']:.4f} ms (graph of 200; issued one by "
                  f"one {f['call_ms']:.4f} ms), plain {f['plain_ms']:.3f} "
                  f"ms, {f['bytes'] / 1e6:.2f} MB, bound "
                  f"{f['bytes'] / HBM_BYTES_PER_S * 1e3:.5f} ms (bytes); "
                  f"{f['every_row_tests'] / 1e9:.3f} G fp32 ops if every "
                  f"pixel tested every row")
    main = [figs[last, n] for n in canvases]
    rand = [figs["random", n] for n in canvases]
    nbytes = sum(f["bytes"] for f in main)
    return dict(
        name="paint", route="cuda", source="cadre_tpu_torch/csrc/paint.cu",
        replaces="cadre_tpu/ops/paint.py:112 (_paint_pallas)",
        max_abs_err=max(f["err"] for f in figs.values()),
        ms=sum(f["ms"] for f in main),
        plain_ms=sum(f["plain_ms"] for f in main),
        bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
        library_ms=None, call_ms=sum(f["call_ms"] for f in main),
        ms_random=sum(f["ms"] for f in rand),
        call_ms_random=sum(f["call_ms"] for f in rand),
        plain_ms_random=sum(f["plain_ms"] for f in rand),
        shapes=f"one env step at N={N_ENVS}: fig 256x144x1 + rgb "
               f"144x256x3, main-path tables ({main[0]['bytes'] / 1e6:.2f} "
               f"+ {main[1]['bytes'] / 1e6:.2f} MB)")


def _attention_inputs(b, c, d, dtype, gen, device, h=5, w=8):
    import torch

    def r(*shape):
        return torch.randn(*shape, generator=gen, device=device).to(dtype)

    return (r(b, h, w, c), r(b, h, w, d), r(b, h, w, d), r(b, h, w, c),
            torch.tensor([0.5], device=device, dtype=dtype), r(b, h, w, c),
            torch.tensor([0.3], device=device, dtype=dtype))


def _bf16_ulp(x):
    import torch

    mag = x.abs().float().clamp_min(2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7.0)


def _attention_library(x, q, k, v, gp, xc, gc):
    """PyTorch yardstick for the same function: SDPA for PAM, bmm and
    softmax for CAM. Timed here only; the port never calls it."""
    import torch
    import torch.nn.functional as F

    b, h, w, c = x.shape
    p = h * w
    out_p = F.scaled_dot_product_attention(
        q.reshape(b, 1, p, -1), k.reshape(b, 1, p, -1),
        v.reshape(b, 1, p, c), scale=1.0).reshape(b, h, w, c)
    xf = xc.reshape(b, p, c)
    energy = torch.bmm(xf.transpose(1, 2), xf)
    att = torch.softmax(energy.amax(-1, keepdim=True) - energy, dim=-1)
    out_c = torch.bmm(xf, att.transpose(1, 2)).reshape(b, h, w, c)
    return gp * out_p + x, gc * out_c + xc


# (B, C, Cqk, H, W) of every call the port makes, timed: the production
# head (resnet18/34 at 144x256: C=128, Cqk=16, P=40) at the main path's
# batch (N_ENVS), at B=256, at the eval's B=EVAL_ENVS and at the
# perception trainer's B=PERCEPTION_BATCH, and phase 5's small head; the
# deep backbones' head (resnet50-152: C=512, Cqk=64) on phase 15's device
# iteration (B=32), at B=256 and in its pretraining (B=48); a 288x512
# camera's head (P=144) and both heads on CARLA's 800x600 camera (P=475)
# at the trainer's batch
PERCEPTION_BATCH = 48
ATTENTION_SHAPES = ((32, 128, 16, 5, 8), (256, 128, 16, 5, 8),
                    (25, 128, 16, 5, 8), (PERCEPTION_BATCH, 128, 16, 5, 8),
                    (2, 32, 4, 5, 8), (32, 512, 64, 5, 8),
                    (256, 512, 64, 5, 8), (PERCEPTION_BATCH, 512, 64, 5, 8),
                    (PERCEPTION_BATCH, 128, 16, 9, 16),
                    (PERCEPTION_BATCH, 128, 16, 19, 25),
                    (PERCEPTION_BATCH, 512, 64, 19, 25))
# held to the plain version only, both types: every CAM position tile the
# wide kernel picks (all of P in one tile up to 64; past that 64 rows at
# C <= 128, and in bf16 at C <= 256, else 32) past one tile, each wide
# template (C <= 128 or up to 512) with a narrow C or P, P = 1, odd P,
# P = 257, 475 (800x600), 576 and 1024 at C = 128 and 512, each PAM
# block width (C <= 128, <= 256, past 256: C = 288, 320) with a partial
# or a single query tile, partial key tiles of both types, the narrow
# kernel at Cqk = 33 (past the 32 it used to take) and Cqk = 1, the bf16
# gram's tiles (32 up to C = 128, one at C = 32; 64 past it, the last half
# at C = 160, 288 and 320) and the bf16 PAM either side of its
# kept-energies limit at C = 128, 256 and 512 (PAM_KEPT_EDGES)
ATTENTION_EDGE_SHAPES = ((3, 160, 20, 7, 11), (3, 256, 32, 9, 16),
                         (3, 512, 64, 16, 16), (3, 128, 16, 16, 16),
                         (3, 512, 64, 1, 1), (3, 96, 33, 5, 8),
                         (3, 32, 1, 1, 1), (3, 320, 40, 7, 7),
                         (3, 128, 16, 1, 257), (3, 512, 64, 1, 257),
                         (3, 128, 16, 19, 25), (3, 512, 64, 19, 25),
                         (3, 256, 32, 19, 25), (3, 128, 16, 18, 32),
                         (3, 512, 64, 18, 32), (3, 128, 16, 32, 32),
                         (3, 512, 64, 32, 32), (70, 128, 16, 19, 25),
                         (70, 288, 36, 10, 10), (30, 320, 40, 7, 7),
                         (3, 96, 1, 10, 10), (3, 32, 4, 9, 9),
                         (3, 128, 16, 1, 1536), (3, 128, 16, 1, 1537),
                         (3, 256, 32, 8, 79), (3, 256, 32, 8, 80),
                         (3, 512, 64, 1, 640), (3, 512, 64, 1, 641))
# the bf16 PAM launch either side of the P past which a block's energies
# no longer fit the card's shared memory (csrc/dual_attention.cu:
# kept_bytes), by (C, P): kept energies up to it, the walks past it
PAM_KEPT_EDGES = {(128, 1536): "pam_kept", (128, 1537): "pam_walks",
                  (256, 632): "pam_kept", (256, 640): "pam_walks",
                  (512, 640): "pam_kept", (512, 641): "pam_walks"}
# the host-env trainer's calls (phase 9, f32 encoder): the newest frame of
# each of N_HOST envs on an incremental tick, their 8-frame windows on a
# refresh tick; and the CARLA env trainer's newest frames (phase 14a,
# CARLA_ENVS envs; its refresh ticks are B=32)
N_HOST = 8
CARLA_ENVS = 4          # 14a's envs: one stub server at each EnvConfig port
HOST_ATTENTION_SHAPES = ((N_HOST, 128, 16, 5, 8), (8 * N_HOST, 128, 16, 5, 8),
                         (CARLA_ENVS, 128, 16, 5, 8))
# the backward kernel's shapes (f32 only), (B, C, Cqk, H, W): the
# trainer's, the small head's, and the deep backbones' and the 288x512 and
# 800x600 cameras' at the trainer's batch, timed; and held to the plain
# version only: every cluster size of the first kernel (C = 32-128), P = 49
# (K not a multiple of 8) and P = 64 (the most it takes), odd Cqk and
# Cqk = 32; of the wide kernel every cluster size (S = 1-16 ranks: C =
# 32-512, P > 64 or Cqk > 32), past C = 256 also in portable clusters of
# 8, ranks of two groups (C = 288: 2,1,...,1; C = 512: 2 each), the
# layout of a card that cannot hold 16, both CAM chunk widths (32 at
# 128 < C <= 256, else 64),
# P = 144 and 256 with Cqk = 64, odd P, P = 3 (at P = 1 the softmax over
# one key is constant, so dq and dk are zero), and P = 257, 475, 576 and
# 1024 at C = 128 and 512 (more query and key tiles than ranks)
BACKWARD_SHAPES = ((PERCEPTION_BATCH, 128, 16, 5, 8), (2, 32, 4, 5, 8),
                   (PERCEPTION_BATCH, 512, 64, 5, 8),
                   (PERCEPTION_BATCH, 128, 16, 9, 16),
                   (PERCEPTION_BATCH, 128, 16, 19, 25),
                   (PERCEPTION_BATCH, 512, 64, 19, 25))
BACKWARD_EDGE_SHAPES = ((3, 64, 8, 5, 8), (3, 96, 12, 5, 8),
                        (3, 32, 5, 7, 7), (3, 128, 32, 7, 7),
                        (3, 128, 32, 8, 8), (3, 64, 17, 8, 8),
                        (3, 32, 4, 9, 9), (3, 64, 8, 9, 9),
                        (3, 96, 33, 5, 8), (3, 128, 16, 16, 16),
                        (3, 160, 20, 7, 11), (3, 192, 24, 5, 8),
                        (3, 224, 28, 5, 8), (3, 256, 32, 9, 16),
                        (3, 288, 36, 5, 8), (3, 512, 64, 9, 16),
                        (3, 512, 64, 16, 16), (3, 512, 64, 1, 3),
                        (3, 128, 16, 1, 257), (3, 512, 64, 1, 257),
                        (3, 128, 16, 19, 25), (3, 512, 64, 19, 25),
                        (3, 256, 32, 19, 25), (3, 32, 4, 19, 25),
                        (3, 288, 36, 19, 25), (3, 128, 16, 18, 32),
                        (3, 512, 64, 18, 32), (3, 128, 16, 32, 32),
                        (3, 512, 64, 32, 32))


def _tag(b, c, d, h, w, dtype=None):
    kind = "" if dtype is None else " " + str(dtype).split(".")[-1]
    return f"B={b} P={h * w} C={c} Cqk={d}{kind}"


def _attention_check(args, bf16):
    """The kernel's outputs against the plain versions' on `args`: (PAM
    error, CAM error, the bound's text); raises past PERF.md's bounds."""
    import torch

    from cadre_tpu_torch.ops import dual_attention as da

    op, oc = da.fused_dual_attention(*args)
    rp = da.pam_apply(*args[:5])
    rc = da.cam_apply(args[5], args[6])
    torch.cuda.synchronize()
    err_p = float((op.float() - rp.float()).abs().max())
    err_c = float((oc.float() - rc.float()).abs().max())
    if not bf16:
        require(err_p <= 2e-4, f"PAM err {err_p:.3g} > 2e-4")
        require(err_c <= 2e-3, f"CAM err {err_c:.3g} > 2e-3")
        return err_p, err_c, "f32 atol 2e-4 PAM / 2e-3 CAM"
    ulps = []
    for out, ref, x in ((op, rp, args[0]), (oc, rc, args[5])):
        scale = torch.maximum(ref.float().abs(), x.float().abs())
        ulps.append(float(((out.float() - ref.float()).abs()
                           / _bf16_ulp(scale)).max()))
    require(max(ulps) <= BF16_ULP_BOUND,
            f"{max(ulps)} bf16 ulps > {BF16_ULP_BOUND}")
    return err_p, err_c, (f"bf16 {ulps[0]:.1f}/{ulps[1]:.1f} ulps "
                          f"<= {BF16_ULP_BOUND}")


# the forward kernel's launches by kind (csrc/dual_attention.cu: Kind)
LAUNCH_KINDS = ("narrow", "cam_f32", "pam_walks", "pam_kept", "cam_gram",
                "cam_softmax", "cam_apply")


def _attention_launches(b, p, c, d, dtype):
    """What each launch of a forward call on B rows is, in issue order
    (the kernel's dual_attention_launch_info): kind, threads and blocks,
    dynamic shared memory a block, registers a thread, blocks an SM."""
    import ctypes

    import torch

    from cadre_tpu_torch.ops import _build

    fn = _build.load("dual_attention").dual_attention_launch_info
    fn.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p, ctypes.c_int]
    fn.restype = ctypes.c_int
    out = (ctypes.c_longlong * 24)()
    n = fn(b, p, c, d, int(dtype == torch.bfloat16), ctypes.addressof(out), 4)
    require(n > 0, f"dual_attention_launch_info: CUDA error {-n}")
    keys = ("kind", "threads", "blocks", "smem_bytes", "registers",
            "blocks_per_sm")
    launches = [dict(zip(keys, out[6 * i:6 * i + 6])) for i in range(n)]
    for launch in launches:
        launch["kind"] = LAUNCH_KINDS[launch["kind"]]
    return launches


def _launches_text(launches):
    return "; ".join(f"{x['kind']} {x['blocks']} x {x['threads']} threads, "
                     f"{x['registers']} registers, {x['smem_bytes']} B, "
                     f"{x['blocks_per_sm']} an SM" for x in launches)


def _attention_sides(args):
    """Device ms of the wide forward kernel's sides alone on `args` (graphs
    of 200 calls of the kernel's side entry, outside the launch counts):
    the CAM side and the PAM launch, and in bf16 the CAM's gram, softmax
    and apply launches each alone, which shows the side and the launch
    that set a shape's pace; {} for a shape of the narrow kernel. Each
    side alone writes what the whole kernel writes for it."""
    import ctypes

    import torch

    from cadre_tpu_torch.ops import _build
    from cadre_tpu_torch.ops import dual_attention as da

    x, q, k, v, gp, xc, gc = args
    b, h, w, c = x.shape
    p, d = h * w, q.shape[-1]
    if da.forward_narrow(p, c):
        return {}
    fn = _build.load("dual_attention").dual_attention_side
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6 + \
        [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    bf16 = int(x.dtype == torch.bfloat16)
    n = da.gram_scratch_floats(p, c, x.dtype)
    scratch = torch.empty(b, max(n, 1), dtype=torch.float32, device=x.device)

    def side(s, out_p, out_c):
        _build.check(fn(x.data_ptr(), q.data_ptr(), k.data_ptr(),
                        v.data_ptr(), gp.data_ptr(), xc.data_ptr(),
                        gc.data_ptr(), out_p.data_ptr(), out_c.data_ptr(),
                        scratch.data_ptr(), b, p, c, d, s, bf16,
                        _build.cuda_stream(x)), "dual_attention_side")

    out_p, out_c = torch.empty_like(x), torch.empty_like(xc)
    names = [("cam_ms", 1), ("pam_ms", 2)]
    if bf16:
        names += [("cam_gram_ms", 4), ("cam_softmax_ms", 8),
                  ("cam_apply_ms", 16)]
    times = {}
    for name, s in names:
        # the softmax and the apply alone read what the runs before left
        times[name] = device_ms(lambda s=s: side(s, out_p, out_c))
    want = da.fused_dual_attention(*args)
    both = [torch.empty_like(x), torch.empty_like(xc)]
    side(1, *both)
    side(2, *both)
    split = torch.empty_like(xc)
    if bf16:
        scratch.fill_(float("nan"))
        for s in (4, 8, 16):
            side(s, both[0], split)
    torch.cuda.synchronize()
    require(torch.equal(both[0], want[0]) and torch.equal(both[1], want[1])
            and (not bf16 or torch.equal(split, want[1])),
            f"dual_attention: a side alone differs from the whole kernel "
            f"at B={b} P={p} C={c}")
    return times


def check_dual_attention(gen, device):
    """The forward kernel against the plain versions at every shape of
    ATTENTION_SHAPES (both types), HOST_ATTENTION_SHAPES (f32) and
    ATTENTION_EDGE_SHAPES (both types), with timings at the first two;
    returns the kernels line's entry: the main path's figures (B=32,
    bf16, P=40, C=128) and, under `shapes`, every timed shape's."""
    import torch

    from cadre_tpu_torch.ops import dual_attention as da

    shapes = {}
    timed = [(s, t) for s in ATTENTION_SHAPES
             for t in (torch.float32, torch.bfloat16)]
    timed += [(s, torch.float32) for s in HOST_ATTENTION_SHAPES]
    edges = [(s, t) for s in ATTENTION_EDGE_SHAPES
             for t in (torch.float32, torch.bfloat16)]
    for (b, c, d, h, w), dtype in timed + edges:
        bf16 = dtype == torch.bfloat16
        p = h * w
        tag = _tag(b, c, d, h, w, dtype)
        smem = da.smem_bytes(b, p, c, d, dtype)
        launches = _attention_launches(b, p, c, d, dtype)
        args = _attention_inputs(b, c, d, dtype, gen, device, h, w)
        try:
            err_p, err_c, tol = _attention_check(args, bf16)
        except PhaseError as exc:
            raise PhaseError(f"dual_attention {tag}: {exc}") from None
        want_pam = PAM_KEPT_EDGES.get((c, p)) if bf16 else None
        require(want_pam in (None, launches[0]["kind"]),
                f"dual_attention {tag}: the PAM launch is "
                f"{launches[0]['kind']}, not {want_pam}")
        if ((b, c, d, h, w), dtype) in edges:
            print(f"[3] dual_attention {tag}: max|err| PAM {err_p:.3g} CAM "
                  f"{err_c:.3g} ({tol}); launches: "
                  + ", ".join(x["kind"] for x in launches))
            continue
        ms = device_ms(lambda: da.fused_dual_attention(*args))
        sides = _attention_sides(args)
        lib_ms = device_ms(lambda: _attention_library(*args))
        call_ms = time_ms(lambda: da.fused_dual_attention(*args), 200)
        lib_call_ms = time_ms(lambda: _attention_library(*args), 200)
        plain_ms = time_ms(lambda: (da.pam_apply(*args[:5]),
                                    da.cam_apply(args[5], args[6])), 20)
        elem = 2 if bf16 else 4
        nbytes = b * (5 * p * c + 2 * p * d) * elem + 8
        # E = q k^T, A v, the symmetric gram x^T x (one product per
        # pair) and x B^T, each 2 FLOP a multiply-add
        flops = b * 2.0 * (p * p * d + p * p * c + p * c * (c + 1) // 2
                           + p * c * c)
        peak = BF16_TC_FLOPS if bf16 else FP32_FLOPS
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / peak * 1e3
        bound_by = "bytes" if t_bytes >= t_ops else "operations"
        floor = ""
        if bf16 and not da.forward_narrow(p, c):
            # the exact-rounding contract keeps the gram (one chain a
            # symmetric pair) and the energies (once) on f32 FMA at half
            # the f32 FLOP rate, beside the applies on the tensor cores
            fma = b * (p * c * (c + 1) // 2 + p * p * d)
            contract_ms = max(t_bytes, fma / (FP32_FLOPS / 2) * 1e3,
                              b * 2.0 * (p * p * c + p * c * c)
                              / BF16_TC_FLOPS * 1e3)
            floor = f", contract floor {contract_ms:.5f} ms (f32 FMA chains)"
        print(f"[3] dual_attention {tag}: max|err| PAM {err_p:.3g} CAM "
              f"{err_c:.3g} ({tol}); kernel {ms:.4f} ms, library "
              f"{lib_ms:.4f} ms (graphs of 200 calls); issued one by "
              f"one: kernel {call_ms:.4f} ms, library {lib_call_ms:.4f} "
              f"ms (200 calls), plain {plain_ms:.4f} ms (20 calls); "
              f"bound {max(t_bytes, t_ops):.5f} ms ({bound_by}){floor}; "
              f"{smem} B shared memory per block")
        if sides:
            split = ("" if "cam_gram_ms" not in sides else
                     f" (its gram launch {sides['cam_gram_ms']:.4f} ms, "
                     f"softmax {sides['cam_softmax_ms']:.4f} ms, apply "
                     f"{sides['cam_apply_ms']:.4f} ms)")
            print(f"[3] dual_attention {tag}: one side of the wide kernel "
                  f"alone, CAM {sides['cam_ms']:.4f} ms{split}, PAM "
                  f"{sides['pam_ms']:.4f} ms (graphs of 200 calls)")
        print(f"[3] dual_attention {tag}: launches {_launches_text(launches)}")
        shapes[tag] = dict(
            max_abs_err=max(err_p, err_c), ms=ms, call_ms=call_ms,
            plain_ms=plain_ms, bound_ms=max(t_bytes, t_ops),
            bound_by=bound_by, library_ms=lib_ms,
            library_call_ms=lib_call_ms, smem_bytes=smem,
            launches_of_call=launches, **sides)
    main = _tag(*ATTENTION_SHAPES[0], torch.bfloat16)
    return dict(
        name="dual_attention", route="cuda",
        source="cadre_tpu_torch/csrc/dual_attention.cu",
        replaces="cadre_tpu/ops/pallas_dual_attention.py:63 "
                 "(dual_attention_pallas)",
        **{k: shapes[main][k] for k in (
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "call_ms", "library_call_ms")},
        shape=main, shapes=shapes)


def _backward_inputs(b, c, d, gen, device, h=5, w=8):
    """Backward kernel inputs (q, k, v, gamma_pam, x_cam, gamma_cam,
    dy_pam, dy_cam) with non-zero gammas, and x_pam for the plain
    version."""
    import torch

    x, q, k, v, _, xc, _ = _attention_inputs(b, c, d, torch.float32, gen,
                                             device, h, w)
    dyp = torch.randn(x.shape, generator=gen, device=device)
    dyc = torch.randn(x.shape, generator=gen, device=device)
    gp = torch.tensor([0.7], device=device)
    gc = torch.tensor([-0.4], device=device)
    return (q, k, v, gp, xc, gc, dyp, dyc), x


# tolerance of the backward kernel against its plain version, as a share
# of each gradient's largest magnitude: PAM (dq, dk, dv, dgamma_pam) and
# CAM (dx_cam, dgamma_cam), whose C x C gram sums run in another order
BWD_TOL = {"dx_pam": 1e-4, "dq": 1e-4, "dk": 1e-4, "dv": 1e-4,
           "dgamma_pam": 1e-4, "dx_cam": 1e-3, "dgamma_cam": 1e-3}


def _backward_work(b, c, d, p=40):
    """(bytes, fp32 FLOP) the backward must move and do: it reads q, k,
    v, x_cam and both upstream gradients and writes dq, dk, dv, dx_cam and
    a value per row for each gamma (dx_pam is dy_pam itself); the products
    are E = q k^T, dy v^T, A^T dy, dE k, dE^T q (PAM) and x^T x, dy^T x,
    dy Bm, x S (CAM), each 2 FLOP a multiply-add; the gram x^T x is
    symmetric, so it needs one product per pair, c (c + 1) / 2 of them.
    What a kernel recomputes (the wide kernel's CAM passes) is not work
    the function needs and does not count."""
    nbytes = b * p * (4 * d + 6 * c) * 4 + 2 * b * 4
    macs = b * (3 * p * p * d + 2 * p * p * c + 3 * p * c * c
                + p * c * (c + 1) // 2)
    return nbytes, 2.0 * macs


def _library_grads(x, q, k, v, gp, xc, gc, dyp, dyc):
    """The gradients of `_attention_library` (SDPA's backward for PAM, bmm
    and softmax for CAM) by autograd, its forward included: the yardstick
    of the backward kernel. Timed here only; the port never calls it."""
    import torch

    with torch.enable_grad():
        ins = [t.detach().requires_grad_(True)
               for t in (x, q, k, v, gp, xc, gc)]
        return torch.autograd.grad(_attention_library(*ins), ins, (dyp, dyc))


def _backward_sides(args):
    """Device ms of the wide backward kernel's CAM clusters alone and of
    its PAM clusters alone on `args` (graphs of 200 calls of the kernel's
    side entry, outside the launch counts), each side's outputs equal to
    the whole kernel's; {} for a shape of the first kernel."""
    import ctypes

    import torch

    from cadre_tpu_torch.ops import _build
    from cadre_tpu_torch.ops import dual_attention as da

    q, k, v, gp, xc, gc, dyp, dyc = args
    b, h, w, c = xc.shape
    p, d = h * w, q.shape[-1]
    if da.backward_narrow(p, c, d):
        return {}
    fn = _build.load("dual_attention_bwd").dual_attention_bwd_side
    fn.argtypes = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 5 + \
        [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    outs = [torch.empty_like(q), torch.empty_like(k), torch.empty_like(v),
            torch.empty_like(xc),
            torch.zeros(2, b * da.backward_shares(p, c, d),
                        device=xc.device),
            torch.empty(b, da.backward_scratch_floats(p), device=xc.device)]
    times = {}
    for name, side in (("cam_ms", 1), ("pam_ms", 2)):
        def call(side=side):
            _build.check(fn(*(t.data_ptr() for t in args),
                            *(t.data_ptr() for t in outs), b, p, c, d, side,
                            _build.cuda_stream(xc)), "dual_attention_bwd_side")
        times[name] = device_ms(call)
    want = da.dual_attention_backward(*args)
    torch.cuda.synchronize()
    sums = outs[4].sum(dim=1)
    got = (outs[0], outs[1], outs[2], sums[0].reshape(1), outs[3],
           sums[1].reshape(1))
    require(all(torch.equal(g, w_) for g, w_ in zip(got, want[1:])),
            f"dual_attention_bwd: a side alone differs from the whole "
            f"kernel at B={b} P={p} C={c}")
    return times


def _backward_portable(args, want, tag):
    """The wide backward past C = 256 with its CAM ranks in portable
    clusters of 8 (two groups a rank at C = 512: the layout of a card that
    cannot hold a cluster of 16), through the kernel's side entry, held to
    `want` (autograd through the plain versions) within BWD_TOL, twice
    bit-equal; returns the errors' text."""
    import ctypes

    import torch

    from cadre_tpu_torch.ops import _build
    from cadre_tpu_torch.ops import dual_attention as da

    q, k, v, gp, xc, gc, dyp, dyc = args
    b, h, w, c = xc.shape
    p, d = h * w, q.shape[-1]
    fn = _build.load("dual_attention_bwd").dual_attention_bwd_side
    fn.argtypes = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 5 + \
        [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    runs = []
    for _ in range(2):
        outs = [torch.empty_like(q), torch.empty_like(k), torch.empty_like(v),
                torch.empty_like(xc),
                torch.zeros(2, b * da.backward_shares(p, c, d),
                            device=xc.device),
                torch.empty(b, da.backward_scratch_floats(p),
                            device=xc.device)]
        _build.check(fn(*(t.data_ptr() for t in args),
                        *(t.data_ptr() for t in outs), b, p, c, d, 3 | 4,
                        _build.cuda_stream(xc)), "dual_attention_bwd_side")
        sums = outs[4].sum(dim=1)
        runs.append((dyp, outs[0], outs[1], outs[2], sums[0].reshape(1),
                     outs[3], sums[1].reshape(1)))
    torch.cuda.synchronize()
    require(all(torch.equal(g, a) for g, a in zip(*runs)),
            f"dual_attention_bwd {tag}: two portable calls differ")
    worst = []
    for (name, tol), g, w_ in zip(BWD_TOL.items(), runs[0], want):
        rel = float((g - w_).abs().max()) / max(float(w_.abs().max()), 1e-30)
        require(rel <= tol, f"dual_attention_bwd {tag} in portable "
                f"clusters: {name} {rel:.3g} of its scale > {tol}")
        worst.append(rel)
    return (f"(max error / scale {max(worst):.2g}, within the same bounds, "
            f"two calls bit-equal)")


def check_dual_attention_backward(gen, device):
    """The backward kernel against autograd through the plain versions, at
    every shape of BACKWARD_SHAPES and BACKWARD_EDGE_SHAPES, twice with
    bit-equal outputs; its cluster size, shared memory and active clusters;
    timings at BACKWARD_SHAPES; a bf16 call that needs a gradient must
    raise. Returns the kernels line's entry: the trainer's figures (B=48,
    P=40, C=128) and, under `shapes`, every timed shape's."""
    import ctypes

    import torch

    from cadre_tpu_torch.ops import _build
    from cadre_tpu_torch.ops import dual_attention as da

    lib = _build.load("dual_attention_bwd")
    active_fn = lib.dual_attention_bwd_active_clusters
    size_fn = lib.dual_attention_bwd_cluster_size
    shares_fn = lib.dual_attention_bwd_shares
    for fn in (active_fn, size_fn, shares_fn):
        fn.argtypes = [ctypes.c_int] * 3
        fn.restype = ctypes.c_int
    shapes = {}
    for b, c, d, h, w in BACKWARD_SHAPES + BACKWARD_EDGE_SHAPES:
        p = h * w
        tag = _tag(b, c, d, h, w, torch.float32)
        args, x = _backward_inputs(b, c, d, gen, device, h, w)
        got = da.dual_attention_backward(*args)
        again = da.dual_attention_backward(*args)
        want = da.dual_attention_backward_ref(x, *args)
        torch.cuda.synchronize()
        require(all(torch.equal(g, a) for g, a in zip(got, again)),
                f"dual_attention_bwd {tag}: two calls differ")
        worst = {}
        for (name, tol), g, w_ in zip(BWD_TOL.items(), got, want):
            scale = float(w_.abs().max())
            rel = float((g - w_).abs().max()) / max(scale, 1e-30)
            require(scale > 0, f"dual_attention_bwd {tag}: {name} is zero "
                    f"(gammas must be non-zero)")
            require(rel <= tol, f"dual_attention_bwd {tag}: {name} "
                    f"{rel:.3g} of its scale > {tol}")
            worst[name] = rel
        active = active_fn(p, c, d)
        require(active > 0, f"dual_attention_bwd {tag}: no cluster can be "
                f"active ({active})")
        # the wrapper sizes the gamma shares by its own copy of the rule
        size, smem = da.backward_cluster_size(p, c, d), \
            da.backward_smem_bytes(p, c, d)
        require(size == size_fn(p, c, d), f"dual_attention_bwd {tag}: "
                f"cluster size {size} in the wrapper, {size_fn(p, c, d)} in "
                f"the kernel")
        require(da.backward_shares(p, c, d) == shares_fn(p, c, d),
                f"dual_attention_bwd {tag}: {da.backward_shares(p, c, d)} "
                f"gamma shares a row in the wrapper, {shares_fn(p, c, d)} in "
                f"the kernel")
        if da.backward_narrow(p, c, d):
            layout = (f"first kernel, clusters of {size} CAM blocks and one "
                      f"PAM block per row")
        else:
            ranks_fn = lib.dual_attention_bwd_pam_ranks
            ranks_fn.argtypes = [ctypes.c_int] * 4
            ranks_fn.restype = ctypes.c_int
            # the CPU model's PAM partition (and so its gamma-share
            # order) is the kernel's on this card's SM count
            sms = torch.cuda.get_device_properties(device).multi_processor_count
            model = da._pam_ranks(p, c, b, da._pam_slots(sms))
            require(model == ranks_fn(b, p, c, d), f"dual_attention_bwd "
                    f"{tag}: {model} PAM ranks a row in the CPU model, "
                    f"{ranks_fn(b, p, c, d)} in the kernel")
            layout = (f"wide kernel, a launch of clusters of "
                      f"{ranks_fn(b, p, c, d)} PAM ranks per row beside one "
                      f"of {size} CAM ranks per row")
            if c > 256:
                layout += (", and in portable clusters of 8 CAM ranks "
                           + _backward_portable(args, want, tag))
        layout += (f", {smem} B shared memory per block, {active} "
                   f"{'' if da.backward_narrow(p, c, d) else 'CAM '}clusters "
                   f"active at once")
        errs = ", ".join(f"{k} {v:.2g}" for k, v in worst.items())
        if (b, c, d, h, w) not in BACKWARD_SHAPES:
            print(f"[3] dual_attention_bwd {tag}: max error / scale {errs} "
                  f"(bounds 1e-4 PAM / 1e-3 CAM), two calls bit-equal; "
                  f"{layout}")
            continue
        ms = device_ms(lambda: da.dual_attention_backward(*args))
        sides = _backward_sides(args)
        call_ms = time_ms(lambda: da.dual_attention_backward(*args), 200)
        plain_ms = time_ms(lambda: da.dual_attention_backward_ref(x, *args),
                           20)
        lib_in = (x, *args[:6])
        lib_both_ms = device_ms(lambda: _library_grads(*lib_in, *args[6:]))
        lib_fwd_ms = device_ms(lambda: _attention_library(*lib_in))
        lib_ms = lib_both_ms - lib_fwd_ms
        nbytes, flops = _backward_work(b, c, d, p)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / FP32_FLOPS * 1e3
        t_tc = 3 * flops / TF32_TC_FLOPS * 1e3
        bound_by = "bytes" if t_bytes >= t_ops else "operations"
        print(f"[3] dual_attention_bwd {tag}: max error / scale {errs} "
              f"(bounds 1e-4 PAM / 1e-3 CAM), two calls bit-equal; kernel "
              f"{ms:.4f} ms (graph of 200), {call_ms:.4f} ms issued one by "
              f"one, plain {plain_ms:.4f} ms, library {lib_ms:.4f} ms "
              f"(graphs: autograd forward + backward {lib_both_ms:.4f} less "
              f"forward {lib_fwd_ms:.4f}); bound {max(t_bytes, t_ops):.5f} "
              f"ms ({bound_by}: {nbytes / 1e6:.2f} MB, {flops / 1e9:.3f} "
              f"GFLOP of f32 FMA at 67 TFLOP/s); in 3xTF32 on the tensor "
              f"cores {max(t_bytes, t_tc):.5f} ms (3 x {flops / 1e9:.3f} "
              f"GFLOP at 495 TFLOP/s {t_tc:.5f} ms, bytes {t_bytes:.5f} "
              f"ms); {layout}")
        if sides:
            print(f"[3] dual_attention_bwd {tag}: one side of the wide kernel "
                  f"alone, CAM clusters {sides['cam_ms']:.4f} ms, PAM "
                  f"clusters {sides['pam_ms']:.4f} ms (graphs of 200 calls)")
        shapes[tag] = dict(
            max_abs_err=max(float((g - w_).abs().max())
                            for g, w_ in zip(got, want)),
            max_rel_err=worst, ms=ms, call_ms=call_ms, plain_ms=plain_ms,
            bound_ms=max(t_bytes, t_ops), bound_by=bound_by,
            bound_ms_3xtf32=max(t_bytes, t_tc), library_ms=lib_ms,
            cluster_blocks=size, smem_bytes=smem, active_clusters=active,
            **sides)
    x, q, k, v, gp, xc, gc = _attention_inputs(2, 32, 4, torch.bfloat16,
                                               gen, device)
    try:
        da.fused_dual_attention(x.requires_grad_(True), q, k, v, gp, xc, gc)
        refused = False
    except TypeError:
        refused = True
    require(refused, "a bf16 dual attention that needs a gradient ran")
    print("[3] dual_attention bf16 with a gradient needed: refused "
          "(no bf16 backward kernel)")
    main = _tag(*BACKWARD_SHAPES[0], torch.float32)
    return dict(
        name="dual_attention_bwd", route="cuda",
        source="cadre_tpu_torch/csrc/dual_attention_bwd.cu",
        replaces="none: XLA autodiff of cadre_tpu/ops/"
                 "dual_attention.py:22-58 (pam_apply, cam_apply)",
        **{k: shapes[main][k] for k in (
            "max_abs_err", "max_rel_err", "ms", "plain_ms", "bound_ms",
            "bound_by", "bound_ms_3xtf32", "library_ms", "call_ms",
            "cluster_blocks", "smem_bytes", "active_clusters")},
        shape=main, shapes=shapes)


def phase_kernels():
    import torch

    device = torch.device("cuda")
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    kernels = {"paint": check_paint(gen, device),
               "dual_attention": check_dual_attention(gen, device),
               "dual_attention_bwd": check_dual_attention_backward(gen,
                                                                   device)}
    check_conv_epilogue()
    return kernels


CONV_CHECK_B = 32


def check_conv_epilogue():
    """3c: every fused convolution of a folded resnet18 and resnet50
    latent at 144x256 (B=CONV_CHECK_B, channels_last, BatchNorms away from
    (0, 1)) against `conv_bias_relu_ref` on the same inputs, in f32 (TF32
    off) and in bf16 (folded in f32, then cast, as `CadreAgent.create`
    does); each latent runs `fused_convs_per_latent` of them."""
    import torch

    from cadre_tpu_torch.configs.danet_config import danet_params
    from cadre_tpu_torch.models.danet import DANet, fold_batch_norms
    from cadre_tpu_torch.models.resnet import FoldedConv
    from cadre_tpu_torch.ops.conv_epilogue import conv_bias_relu_ref

    gen = torch.Generator().manual_seed(7)
    for arch in ("resnet18", "resnet50"):
        cfg = danet_params(backbone=arch)
        net = _randomised_batch_norms(DANet(cfg, latent_only=True), gen)
        net = fold_batch_norms(net.eval()).to(
            "cuda", memory_format=torch.channels_last)
        frames = torch.rand(CONV_CHECK_B, cfg.image_height, cfg.image_width,
                            4, generator=gen).cuda()
        want = fused_convs_per_latent(arch)
        for dtype in (torch.float32, torch.bfloat16):
            net = net.to(dtype)
            gaps = []

            def hook(conv, args, out):
                if conv.bias is not None:
                    ref = conv_bias_relu_ref(args[0], conv.weight, conv.bias,
                                             conv.stride, conv.padding,
                                             *args[1:])
                    gaps.append(folded_latent_gap(out, ref))

            handles = [m.register_forward_hook(hook) for m in net.modules()
                       if isinstance(m, FoldedConv)]
            try:
                with torch.no_grad():
                    z, fused = _fused_counted(
                        lambda: net.latent(frames.to(dtype)))
            finally:
                for h in handles:
                    h.remove()
            torch.cuda.synchronize()
            _finite(f"{arch} {dtype} folded latent", z)
            name = str(dtype).split(".")[-1]
            require(fused == want == len(gaps),
                    f"3c {arch} {name}: {fused} fused convolutions a latent "
                    f"({len(gaps)} hooked), not {want}")
            require(max(gaps) <= CONV_TOL[name],
                    f"3c {arch} {name}: a fused convolution lies "
                    f"{max(gaps):.3g} from the plain version (relative RMS; "
                    f"at most {CONV_TOL[name]})")
            print(f"[3c] conv_epilogue {arch} {name} B={CONV_CHECK_B}: "
                  f"{fused} fused convolutions a latent, each within "
                  f"{max(gaps):.3g} of the plain version (relative RMS, "
                  f"median {sorted(gaps)[len(gaps) // 2]:.3g}; at most "
                  f"{CONV_TOL[name]})")


# ---------------------------------------------------------------- phase 4

def _finite(name, t):
    import torch

    require(bool(torch.isfinite(t.float()).all()), f"{name} is not finite")


def phase_slice():
    """The main path at production width: a counted rollout, then one
    counted training iteration; returns the iteration's launch counts."""
    import torch

    from cadre_tpu_torch.configs.agent_config import RolloutConfig
    from cadre_tpu_torch.configs.danet_config import danet_params
    from cadre_tpu_torch.envs.torch_env import DrivingEnv, make_route_bank
    from cadre_tpu_torch.rl.agent import CadreAgent, preprocess_obs
    from cadre_tpu_torch.rl.device_rollout import make_device_rollout

    t0 = time.perf_counter()
    agent = CadreAgent.create(danet_params(), bf16_encoder=True,
                              device="cuda")
    bank = make_route_bank(16, seed=0, device="cuda")
    env = DrivingEnv(bank, num_envs=N_ENVS, device="cuda")
    rollout, init_carry = make_device_rollout(
        agent, env, RolloutConfig(num_steps=T_STEPS))
    warm, _ = make_device_rollout(agent, env, RolloutConfig(num_steps=2),
                                  seed=1)
    carry = init_carry()
    carry = warm(carry)[0]                 # first launches, cuDNN choices
    torch.cuda.synchronize()
    print(f"[4] set-up (agent, bank, env, warm-up) "
          f"{time.perf_counter() - t0:.2f} s; obs_dim {agent.obs_dim}")

    per_latent = fused_convs_per_latent(agent.danet_cfg.backbone)
    t0 = time.perf_counter()
    ((carry, steer, throttle, next_values, m), launches), fused = \
        _fused_counted(lambda: _counted(lambda: rollout(carry)))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    require(fused == (T_STEPS + 1) * per_latent,
            f"rollout ran {fused} fused convolutions, not {T_STEPS + 1} "
            f"latents x {per_latent}")

    require(launches["paint"] == 2 * T_STEPS
            and launches["dual_attention"] == T_STEPS + 1
            and launches["dual_attention_bwd"] == 0,
            f"rollout launches {launches}, not {2 * T_STEPS} / "
            f"{T_STEPS + 1}")
    f = agent.obs_dim
    require(tuple(steer.obs.shape) == (T_STEPS + 1, N_ENVS, 8, f),
            f"steer buffer obs {tuple(steer.obs.shape)}")
    for sig, buf in (("steer", steer), ("throttle", throttle)):
        for name, t in buf._asdict().items():
            if name != "step":              # the host ring pointer
                _finite(f"{sig}.{name}", t)
    for name, t in m._asdict().items():
        _finite(name, t)
    for name in ("rgb", "route_fig", "measurements"):
        _finite(f"obs.{name}", carry.obs[name])
    _finite("next_values", torch.stack(next_values))
    require(int(steer.action[:T_STEPS].max()) < 33
            and int(throttle.action[:T_STEPS].max()) < 3, "action out of range")
    print(f"[4] rollout N={N_ENVS} T={T_STEPS}: {seconds:.3f} s, "
          f"{N_ENVS * T_STEPS / seconds:.1f} env-steps/s; episodes_done "
          f"{float(m.episodes_done):.0f}, mean rewards "
          f"{float(m.mean_steer_reward):.4f}/{float(m.mean_throttle_reward):.4f}"
          f", checksum {float(m.checksum):.6f}; launches {launches}, fused "
          f"convolutions {fused}")

    for b in (N_ENVS, 256):
        reps = -(-b // N_ENVS)
        x = preprocess_obs(carry.obs["rgb"].repeat(reps, 1, 1, 1)[:b],
                           carry.obs["route_fig"].repeat(reps, 1, 1)[:b])
        x = x.to(torch.bfloat16)
        with torch.no_grad():
            z, fused = _fused_counted(lambda: agent.encoder.latent(x))
            ms = time_ms(lambda: agent.encoder.latent(x), 10)
        _finite(f"bf16 latent B={b}", z)
        require(fused == per_latent, f"a latent ran {fused} fused "
                f"convolutions, not {per_latent}")
        print(f"[4] encoder bf16 B={b}: {ms:.3f} ms, "
              f"{b / ms * 1e3:.1f} frames/s; {fused} fused convolutions")

    # where one rollout step's device time goes
    prof_steps = 5
    short, _ = make_device_rollout(agent, env,
                                   RolloutConfig(num_steps=prof_steps),
                                   seed=2)
    carry = profile(lambda: short(carry)[0], f"{prof_steps} steps",
                    prof_steps, "step")
    return train_iteration(agent, env, carry, (steer, throttle))


def profile(fn, what: str, per: int, unit: str, tag: str = "4"):
    """Run fn() once under torch.profiler; print the wall time, the
    device's busy time and idle share, its op count per `unit` (`per` of
    them in the run) and the top ops, each line tagged `[tag]`. Returns
    fn()'s result."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # device-side events only (kernels, copies): the aten ops that launch
    # them carry the same time again, and so does a user-annotated range
    # (Optimizer.step's) that the profiler also reports on the device
    cuda = torch.autograd.DeviceType.CUDA
    rows = [e for e in prof.key_averages() if e.device_type == cuda
            and not getattr(e, "is_user_annotation", False)]
    busy_us = sum(e.self_device_time_total for e in rows)
    kernels = sum(e.count for e in rows)
    require(busy_us > 0, f"profile of {what}: no device time")
    print(f"[{tag}] profile of {what}: wall {wall * 1e3:.1f} ms, "
          f"device busy {busy_us / 1e3:.1f} ms "
          f"({100.0 * (1 - busy_us / 1e6 / wall):.1f}% idle), "
          f"{kernels} device ops, {kernels / per:.0f} per {unit}")
    rows.sort(key=lambda e: -e.self_device_time_total)
    for e in rows[:12]:
        print(f"[{tag}]   {e.self_device_time_total / 1e3:9.3f} ms "
              f"{e.count:6d}x {e.key[:80]}")
    return out


def _tile_buffer(buf, t):
    """A RolloutBuffer's steps repeated up to t steps, zero slot after."""
    import torch

    reps = -(-t // buf.num_steps)

    def tile(x):
        x = x[:-1].repeat(reps, *([1] * (x.dim() - 1)))[:t]
        return torch.cat([x, torch.zeros_like(x[:1])])

    return buf._replace(**{k: tile(x) for k, x in buf._asdict().items()
                           if isinstance(x, torch.Tensor)})


def train_iteration(agent, env, carry, bufs):
    """One whole training iteration at production size (T_TRAIN steps of
    N_ENVS envs, TrainConfig's 4 epochs of RolloutConfig's 2 minibatches)
    after a T=2 warm-up iteration; then a profile of one update on the
    T_STEPS rollout's buffers `bufs` tiled to T_TRAIN. Returns the launch
    counts of the counted iteration."""
    import dataclasses

    import torch

    from cadre_tpu_torch.configs.agent_config import (
        RolloutConfig,
        TrainConfig,
    )
    from cadre_tpu_torch.rl.device_rollout import make_device_iteration
    from cadre_tpu_torch.rl.fused_update import (
        make_fused_iteration_update,
        minibatch_layout,
    )

    train_cfg, rollout_cfg = TrainConfig(), RolloutConfig(num_steps=T_TRAIN)
    opt = agent.opt
    warm, _ = make_device_iteration(agent, env, RolloutConfig(num_steps=2),
                                    train_cfg, seed=3)
    t0 = time.perf_counter()
    carry, m = warm(opt, carry)
    float(m.checksum)
    print(f"[4] warm-up iteration T=2: {time.perf_counter() - t0:.2f} s")

    iteration, _ = make_device_iteration(agent, env, rollout_cfg, train_cfg,
                                         seed=4)
    before = [p.detach().clone() for p in agent.policy_parameters()]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ((carry, m), launches), fused = _fused_counted(
        lambda: _counted(lambda: iteration(opt, carry)))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    per_latent = fused_convs_per_latent(agent.danet_cfg.backbone)
    require(fused == (T_TRAIN + 1) * per_latent,
            f"iteration ran {fused} fused convolutions, not {T_TRAIN + 1} "
            f"latents x {per_latent}")

    require(launches["paint"] == 2 * T_TRAIN
            and launches["dual_attention"] == T_TRAIN + 1
            and launches["dual_attention_bwd"] == 0,
            f"iteration launches {launches}, not {2 * T_TRAIN} / "
            f"{T_TRAIN + 1}")
    for name, t in m._asdict().items():
        if isinstance(t, torch.Tensor):
            _finite(name, t)
    params = agent.policy_parameters()
    for i, p in enumerate(params):
        _finite(f"policy parameter {i}", p.detach())
    moved = sum(not torch.equal(a, b.detach()) for a, b in zip(before, params))
    require(moved == len(params),
            f"only {moved} of {len(params)} policy tensors moved")
    steps = T_TRAIN * N_ENVS
    eff_mb, mb_rows = minibatch_layout(steps, rollout_cfg.mini_batch_num)
    print(f"[4] iteration N={N_ENVS} T={T_TRAIN} E={train_cfg.ppo_epoch} "
          f"M={eff_mb} ({mb_rows} rows per minibatch): {seconds:.3f} s, "
          f"{steps / seconds:.1f} env-steps/s; rollout "
          f"{m.rollout_seconds:.3f} s ({steps / m.rollout_seconds:.1f} "
          f"env-steps/s), update {seconds - m.rollout_seconds:.3f} s; peak "
          f"memory allocated {peak / 2**30:.2f} GiB; losses value "
          f"{float(m.value_loss):.5f} policy {float(m.policy_loss):.5f} "
          f"entropy {float(m.entropy_loss):.5f}; episodes_done "
          f"{float(m.episodes_done):.0f}; launches {launches}, fused "
          f"convolutions {fused}")

    ppo_cfg = dataclasses.replace(agent.ppo_cfg,
                                  ppo_epoch=train_cfg.ppo_epoch)
    update = make_fused_iteration_update(agent.steer, agent.throttle,
                                         ppo_cfg, rollout_cfg, seed=5)
    steer, throttle = (_tile_buffer(b, T_TRAIN) for b in bufs)
    zeros = torch.zeros(N_ENVS, device=steer.obs.device)
    n_steps = train_cfg.ppo_epoch * eff_mb
    aux, launched = _counted(lambda: profile(
        lambda: update(opt, steer, throttle, (zeros, zeros)),
        f"one update (T={T_TRAIN}, {n_steps} minibatch steps)", n_steps,
        "minibatch step"))
    require(not any(launched.values()), "the update launched a kernel")
    for name, t in aux._asdict().items():
        _finite(f"update {name}", t)
    return launches


# ---------------------------------------------------------------- phase 5

def phase_cpu_agreement():
    """A small f32 agent and 2 envs on the card against the same on the
    CPU (plain versions there), from the same weights and draws."""
    import torch

    from cadre_tpu_torch.configs.danet_config import danet_params
    from cadre_tpu_torch.envs.torch_env import (
        DrivingEnv,
        ResetDraws,
        StepDraws,
        make_route_bank,
    )
    from cadre_tpu_torch.rl.agent import CadreAgent

    cfg = danet_params(da_feature_channel=32, inter_att_dims=24, z_dims=16)
    gpu, cpu = torch.device("cuda"), torch.device("cpu")
    agents, envs = {}, {}
    for dev in (cpu, gpu):
        agent = CadreAgent.create(cfg, seed=1, device=dev)
        with torch.no_grad():
            agent.encoder.da_head.sa.gamma.fill_(0.5)
            agent.encoder.da_head.sc.gamma.fill_(0.3)
        agents[dev.type] = agent
        envs[dev.type] = DrivingEnv(make_route_bank(3, seed=0, device=dev),
                                    2, device=dev)

    def to_gpu(d):
        return StepDraws(ResetDraws(*(None if t is None else t.to(gpu)
                                       for t in d.reset)),
                         d.noise.to(gpu))

    draws = envs["cpu"].draw_step()
    s_c, o_c = envs["cpu"].reset(draws)
    s_g, o_g = envs["cuda"].reset(to_gpu(draws))
    feats_c = agents["cpu"].encode(o_c)
    feats_g = agents["cuda"].encode({k: v.to(gpu) for k, v in o_c.items()})
    err = float((feats_g.cpu() - feats_c).abs().max())
    scale = float(feats_c.abs().max())
    require(err <= 1e-3 * scale, f"encoder cuda vs cpu: {err:.3g} > 1e-3 "
            f"x {scale:.3g}")
    worst = {"rewards": 0.0, "measurements": 0.0, "rgb_px": 0.0,
             "fig_px": 0.0}
    controls = torch.tensor([[0.1, 0.6, 0.0], [-0.2, 1.0, 0.0]])
    for step in range(3):
        draws = envs["cpu"].draw_step()
        s_c, out_c = envs["cpu"].step(s_c, controls, draws)
        s_g, out_g = envs["cuda"].step(s_g, controls.to(gpu), to_gpu(draws))
        require(bool((out_c.done == out_g.done.cpu()).all()),
                f"step {step}: done differs")
        for name in ("rewards", "measurements"):
            worst[name] = max(worst[name], float(
                (getattr(out_c, name) - getattr(out_g, name).cpu()).abs()
                .max()))
        worst["rgb_px"] = max(worst["rgb_px"], float(
            ((out_c.rgb - out_g.rgb.cpu()).abs() > 1e-3).float().mean()))
        worst["fig_px"] = max(worst["fig_px"], float(
            (out_c.route_fig != out_g.route_fig.cpu()).float().mean()))
    require(worst["rewards"] <= 1e-3 and worst["measurements"] <= 1e-3,
            f"env cuda vs cpu: {worst}")
    require(worst["rgb_px"] <= 0.005 and worst["fig_px"] <= 0.005,
            f"env images cuda vs cpu: {worst}")
    print(f"[5] cuda vs cpu, small f32 agent: latent max|err| {err:.3g} "
          f"(scale {scale:.3g}, bound 1e-3 x scale); 3 env steps: {worst} "
          f"(bounds 1e-3, 1e-3, 0.5% px, 0.5% px)")
    update_agreement()


def _zero_gradient(key, shape, ordinal):
    """The elements of a policy-bank tensor whose gradient is zero whatever
    the data: the transformer's attention key biases (softmax(q k^T) does
    not move when a row's scores shift by q . b) and, under the ordinal
    head, the first raw logit's row of fc3 (log sigmoid(raw_0) enters
    every ordinal logit alike). Adam moves them by rounding noise only."""
    import torch

    mask = torch.zeros(shape, dtype=torch.bool)
    if key.endswith(".key.bias"):
        mask[...] = True
    elif ordinal and key.startswith("control.fc3."):
        mask[:, 0] = True
    return mask


def update_agreement(tag: str = "5", **options):
    """One fused PPO update (E=2, M=2) of small f32 banks (PolicyBank
    `options`) on the card and on the CPU, from the same weights, buffers
    and permutations: LossAux within 1e-5 relative, every updated tensor
    within 1% of the largest change the CPU update made to it; elements of
    `_zero_gradient` within Adam's bound on their E*M steps instead."""
    import numpy as np
    import torch

    from cadre_tpu_torch.configs.agent_config import RolloutConfig
    from cadre_tpu_torch.models.policy import PolicyBank
    from cadre_tpu_torch.rl.fused_update import make_fused_iteration_update
    from cadre_tpu_torch.rl.ppo import PPOConfig, make_optimizer
    from cadre_tpu_torch.rl.rollout import RolloutBuffer

    f, t, n, seq, epochs, mbs = 50, 6, 4, 3, 2, 2
    rng = np.random.RandomState(11)

    def arrays(n_out):
        a = dict(obs=rng.standard_normal((t, n, seq, f)),
                 action=rng.randint(0, n_out, (t, n)),
                 log_prob=-np.abs(rng.standard_normal((t, n))) - 0.5,
                 value=0.1 * rng.standard_normal((t, n)),
                 reward=rng.standard_normal((t, n)),
                 mask=(rng.rand(t, n) > 0.25).astype(np.float64),
                 command=rng.randint(0, 4, (t, n)),
                 hn=0.5 * rng.standard_normal((t, n, f)),
                 cn=0.5 * rng.standard_normal((t, n, f)))
        return {k: np.concatenate([v, np.zeros_like(v[:1])])
                for k, v in a.items()}

    data = {"steer": arrays(33), "throttle": arrays(3)}
    nv = rng.standard_normal((2, n))
    perms = [np.stack([rng.permutation(t * n)[:t * n // mbs * mbs]
                       .reshape(mbs, -1) for _ in range(epochs)])
             .reshape(epochs * mbs, -1) for _ in range(2)]
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(12)
        init = {s: PolicyBank(4, a, f, **options).state_dict()
                for s, a in (("steer", 33), ("throttle", 3))}
    out = {}
    for dev in ("cpu", "cuda"):
        def tensor(x):
            return torch.as_tensor(x, dtype=torch.int64 if x.dtype.kind
                                   == "i" else torch.float32, device=dev)

        banks = {}
        for s, a in (("steer", 33), ("throttle", 3)):
            banks[s] = PolicyBank(4, a, f, **options).to(dev)
            banks[s].load_state_dict(init[s])
        update = make_fused_iteration_update(
            banks["steer"], banks["throttle"], PPOConfig(ppo_epoch=epochs),
            RolloutConfig(num_steps=t, mini_batch_num=mbs, seq_length=seq,
                          feature_dims=f))
        opt = make_optimizer([*banks["steer"].parameters(),
                              *banks["throttle"].parameters()], PPOConfig())
        aux = update(opt, *(RolloutBuffer(**{k: tensor(v) for k, v in
                                            data[s].items()})
                            for s in ("steer", "throttle")),
                     (tensor(nv[0]), tensor(nv[1])),
                     tuple(tensor(p) for p in perms))
        out[dev] = ([float(x) for x in aux],
                    {(s, k): v.cpu() for s in banks
                     for k, v in banks[s].state_dict().items()})
    (aux_c, p_c), (aux_g, p_g) = out["cpu"], out["cuda"]
    aux_err = max(abs(g - c) / max(abs(c), 1e-30)
                  for g, c in zip(aux_g, aux_c))
    require(aux_err <= 1e-5, f"update cuda vs cpu: LossAux {aux_g} vs "
            f"{aux_c}, {aux_err:.3g} relative > 1e-5")
    worst = 0.0
    adam_bound = 3.17 * PPOConfig().lr * epochs * mbs
    for key, c in p_c.items():
        before = init[key[0]][key[1]]
        zero = _zero_gradient(key[1], c.shape, options.get("ordinal", False))
        for moved in (c - before, p_g[key] - before):
            require(float(moved[zero].abs().sum()) == 0.0 or float(
                moved[zero].abs().max()) <= adam_bound,
                    f"update cuda vs cpu: {key} moved beyond Adam's bound "
                    f"where its gradient is zero")
        if zero.all():
            continue
        change = float((c - before)[~zero].abs().max())
        require(change > 0, f"update cuda vs cpu: {key} did not move")
        worst = max(worst, float((p_g[key] - c)[~zero].abs().max())
                    / change)
    require(worst <= 0.01, f"update cuda vs cpu: a tensor {worst:.3g} of "
            f"its largest change from the CPU's > 0.01")
    print(f"[{tag}] cuda vs cpu, one fused update (f={f}, T={t}, N={n}, E="
          f"{epochs}, M={mbs}{', ' if options else ''}"
          f"{', '.join(f'{k}={v}' for k, v in options.items())}): LossAux "
          f"{aux_err:.3g} relative (bound 1e-5); parameters at most "
          f"{worst:.3g} of each tensor's largest change (bound 0.01)")


# ---------------------------------------------------------------- phase 6

def phase_cli():
    """The training CLI at production width for two short iterations, in
    its own process; its snapshot must load into a fresh agent."""
    import os
    import shutil

    import torch

    from cadre_tpu_torch.configs.danet_config import danet_params
    from cadre_tpu_torch.rl.agent import CadreAgent

    root = os.path.dirname(os.path.abspath(__file__))
    work = os.path.join(root, "build", "smoke_train")
    shutil.rmtree(work, ignore_errors=True)
    cmd = [sys.executable, "-m", "cadre_tpu_torch.main", "--env", "jax",
           "--num-envs", str(N_ENVS), "--num-steps", str(T_STEPS),
           "--iterations", "2", "--work-dir", work]
    t0 = time.perf_counter()
    out = subprocess.run(cmd, cwd=root, capture_output=True, text=True,
                         timeout=600)
    seconds = time.perf_counter() - t0
    require(out.returncode == 0, f"the CLI exited {out.returncode}: "
            f"{out.stderr[-3000:]}")
    for line in out.stdout.strip().splitlines():
        print(f"[6]   {line}")
    path = os.path.join(work, "models", "ppo_model_2.pt")
    require(os.path.exists(path), f"the CLI wrote no {path}")
    agent = CadreAgent.create(danet_params(), seed=1, device="cuda")
    agent.load_snapshot(path)
    saved = torch.load(path, map_location="cuda", weights_only=True)
    for name in ("steer", "throttle"):
        for k, v in getattr(agent, name).state_dict().items():
            require(torch.equal(v, saved[name][k]),
                    f"snapshot {name}.{k} did not load back equal")
    print(f"[6] python -m cadre_tpu_torch.main --env jax --num-envs "
          f"{N_ENVS} --num-steps {T_STEPS} --iterations 2: exit 0 in "
          f"{seconds:.1f} s; {os.path.relpath(path, root)} loads back equal")


# ---------------------------------------------------------------- phase 7

def _smoke_dir(name: str) -> str:
    import os

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        name)
    os.makedirs(path, exist_ok=True)
    return path


def eval_routes() -> str:
    """The eval's route XML, written under build/ (see
    town_maps.write_lane_routes)."""
    import os

    from cadre_tpu_torch.envs.town_maps import write_lane_routes

    return write_lane_routes(os.path.join(_smoke_dir("smoke_eval"),
                                          "town01.xml"), EVAL_ENVS,
                             n_short=EVAL_SHORT)


def eval_bank(device):
    """The eval bank: the EVAL_ENVS routes of `eval_routes()` traced over
    Town01, as scripts/run_nocrash_eval.py banks its eval XMLs."""
    from cadre_tpu_torch.envs.torch_env import make_route_bank

    return make_route_bank(EVAL_ENVS, seed=1000, routes_file=eval_routes(),
                           map_name="Town01", device=device)


def eval_env_config():
    """The NoCrash "regular" tier of scripts/run_nocrash_eval.py (Town01
    [20, 50] town-wide -> 3 vehicles and 6 walkers on the route), in eval
    mode."""
    from cadre_tpu_torch.envs.torch_env import EnvConfig

    return EnvConfig(training=False, n_vehicles=3, n_walkers=6)


def member_snapshots(agent, k: int, what: str):
    """k random member snapshots of `agent`'s banks (seeds 0..k-1), saved
    with save_snapshot under build/; returns their paths."""
    import os

    import torch

    from cadre_tpu_torch.models.policy import PolicyBank

    cfg, f = agent.agent_cfg, agent.obs_dim
    paths = []
    for seed in range(k):
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            banks = {s: PolicyBank(cfg.command_num, a, f).state_dict()
                     for s, a in (("steer", cfg.num_steer_outputs),
                                  ("throttle", cfg.num_throttle_outputs))}
        paths.append(os.path.join(_smoke_dir(what), f"member_{seed}.pt"))
        torch.save(banks, paths[-1])
    return paths


def _check_rows(rows, what):
    for r in rows:
        require(0.0 <= r["completion"] <= 1.0
                and 0.0 <= r["driving_score"] <= 100.0
                and r["error"] != "exceed speed", f"{what}: bad row {r}")


def phase_eval():
    """The eval path at full width; returns its launch counts."""
    import torch

    from cadre_tpu_torch.configs.danet_config import danet_params
    from cadre_tpu_torch.envs.torch_env import DrivingEnv
    from cadre_tpu_torch.rl.agent import CadreAgent, Ensemble
    from cadre_tpu_torch.rl.device_eval import (
        evaluate_device,
        evaluate_ensemble,
    )

    t0 = time.perf_counter()
    bank = eval_bank("cuda")
    lens = bank.route_len.tolist()
    print(f"[7a] bank of {len(lens)} Town01 routes traced from "
          f"{eval_routes()} in {time.perf_counter() - t0:.2f} s: "
          f"{min(lens)}-{max(lens)} m, "
          f"{int((bank.lights[..., 0] < 1e7).sum())} lights")
    short = list(range(EVAL_ENVS - EVAL_SHORT, EVAL_ENVS))
    require(len(lens) == EVAL_ENVS
            and min(lens[:EVAL_ENVS - EVAL_SHORT]) > 20
            and all(lens[i] <= 13 for i in short), f"eval bank {lens}")

    agent = CadreAgent.create(danet_params(), bf16_encoder=True,
                              device="cuda")
    paths = member_snapshots(agent, EVAL_MEMBERS, "smoke_members")
    env = DrivingEnv(bank, EVAL_ENVS, eval_env_config(), device="cuda")
    ids = list(range(EVAL_ENVS))
    evaluate_device(agent, env, paths, max_steps=2, seed=1, route_ids=ids)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    rows, launches = _counted(lambda: evaluate_device(
        agent, env, paths, max_steps=EVAL_STEPS, seed=7, route_ids=ids))
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    t0 = time.perf_counter()
    ensemble = Ensemble.load(agent, paths)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    want = {"paint": 2 + 2 * EVAL_STEPS, "dual_attention": 1 + EVAL_STEPS,
            "dual_attention_bwd": 0}
    require(launches == want, f"eval launches {launches}, not {want}")
    _check_rows(rows, "eval")
    require(all(r["route_id"] in ids for r in rows)
            and len({r["route_id"] for r in rows}) == len(rows),
            "eval: more than one row for a route")
    require(set(short) <= {r["route_id"] for r in rows},
            f"eval: the short routes {short} scored no row")
    run_s = seconds - load_s
    errors = {}
    for r in rows:
        errors[r["error"]] = errors.get(r["error"], 0) + 1
    print(f"[7b] eval K={EVAL_MEMBERS} N={EVAL_ENVS} {EVAL_STEPS} steps "
          f"(bf16 encoder, regular tier): {seconds:.3f} s with the "
          f"snapshot load (timed alone after it: {load_s:.3f} s); without "
          f"it "
          f"{EVAL_ENVS * EVAL_STEPS / run_s:.1f} eval env-steps/s, "
          f"{EVAL_MEMBERS * EVAL_ENVS * EVAL_STEPS / run_s:.1f} "
          f"member-steps/s; peak memory allocated {peak / 2**30:.2f} GiB; "
          f"{len(rows)} routes finished: {errors}; launches {launches}")
    if rows:
        print(f"[7b] mean completion {sum(r['completion'] for r in rows) / len(rows):.4f}, "
              f"mean driving score "
              f"{sum(r['driving_score'] for r in rows) / len(rows):.3f}")
    prof_steps = 5
    profile(lambda: evaluate_ensemble(agent, env, ensemble,
                                      max_steps=prof_steps, seed=8,
                                      route_ids=ids),
            f"an eval of {prof_steps} steps (members loaded)", prof_steps,
            "eval step", tag="7b")
    nocrash_train(agent)
    eval_cpu_agreement()
    expert_on_eval_bank(bank)
    return launches


def nocrash_train(agent):
    """One training iteration with the NoCrash options at N_ENVS x
    T_STEPS on a bank of Town01 traces (scripts/run_nocrash_eval.py's
    training env plus hazards and stop signs)."""
    import numpy as np
    import torch

    from cadre_tpu_torch.configs.agent_config import RolloutConfig
    from cadre_tpu_torch.envs.route_parser import parse_routes_file
    from cadre_tpu_torch.envs.torch_env import (
        DrivingEnv,
        EnvConfig,
        make_route_bank,
    )
    from cadre_tpu_torch.envs.town_maps import town_map, trace_dense_route
    from cadre_tpu_torch.rl.device_rollout import make_device_iteration

    town = town_map("Town01")
    dense = [trace_dense_route(town, np.asarray([w.xy for w in r.trajectory]))
             for r in parse_routes_file(eval_routes())]
    bank = make_route_bank(len(dense), seed=3, dense_routes=dense,
                           stop_sign_prob=0.5, device="cuda")
    cfg = EnvConfig(n_vehicles=8, n_walkers=0, priority_routes=True,
                    n_hazards=2, n_junction_hazards=1)
    env = DrivingEnv(bank, N_ENVS, cfg, seed=3, device="cuda")
    iteration, init_carry = make_device_iteration(
        agent, env, RolloutConfig(num_steps=T_STEPS), seed=3)
    opt = agent.opt
    carry = init_carry()
    pinned = list(range(NOCRASH_PINNED))
    carry = carry._replace(env_state=_midway_timed_out(
        carry.env_state, bank, pinned))
    t0 = time.perf_counter()
    (carry, m), launches = _counted(lambda: iteration(opt, carry))
    float(m.checksum)
    seconds = time.perf_counter() - t0
    want = {"paint": 2 * T_STEPS, "dual_attention": T_STEPS + 1,
            "dual_attention_bwd": 0}
    require(launches == want, f"NoCrash iteration launches {launches}, "
            f"not {want}")
    for name, t in m._asdict().items():
        if isinstance(t, torch.Tensor):
            _finite(f"NoCrash iteration {name}", t)
    for name, t in carry.env_state._asdict().items():
        _finite(f"NoCrash env state {name}", t)
    for i, p in enumerate(agent.policy_parameters()):
        _finite(f"NoCrash policy parameter {i}", p.detach())
    moved = (carry.env_state.route_prio < 100).any(1)
    require(float(m.episodes_done) >= len(pinned)
            and bool(moved[pinned].all()),
            f"NoCrash iteration: {float(m.episodes_done):.0f} episodes "
            f"ended, priority moved in envs "
            f"{moved.nonzero().flatten().tolist()}, not in all of {pinned}")
    n_signs = int((bank.stop_signs[..., 0] < 1e7).sum())
    print(f"[7c] NoCrash training iteration N={N_ENVS} T={T_STEPS} "
          f"(8 vehicles, 2 + 1 hazards, priority routes, {n_signs} stop "
          f"signs in {len(dense)} traced routes): {seconds:.3f} s, "
          f"episodes_done {float(m.episodes_done):.0f}, routes below "
          f"priority 100: "
          f"{int((carry.env_state.route_prio < 100).any(0).sum())}, envs "
          f"with a moved priority: {int(moved.sum())}; launches "
          f"{launches}")


def _midway_timed_out(state, bank, envs):
    """`state` with each env of `envs` halfway along its route, facing
    along it, and past its route timeout, so that its episode ends on the
    next step at about half completion (the env tests' way of forcing an
    end)."""
    import torch

    state = state._replace(**{k: getattr(state, k).clone() for k in
                              ("pos", "yaw", "head", "progress", "step")})
    for i in envs:
        r = int(state.route_id[i])
        j = int(bank.route_len[r]) // 2
        d = bank.routes[r, j + 1] - bank.routes[r, j]
        state.pos[i] = bank.routes[r, j]
        state.yaw[i] = torch.rad2deg(torch.atan2(d[1], d[0]))
        state.head[i] = j - 1
        state.progress[i] = j
        state.step[i] = 100000
    return state


def eval_cpu_agreement():
    """A small f32 agent, K=2 members, N=3 envs, 8 eval steps on the card
    and on the CPU from the same draws, on a bank whose two short routes
    end their episodes: equal rows (error, steps, infractions, route),
    completion within 1e-3, driving score within 0.1."""
    import numpy as np
    import torch

    from cadre_tpu_torch.configs.danet_config import danet_params
    from cadre_tpu_torch.envs.route_parser import interpolate_route
    from cadre_tpu_torch.envs.synthetic import synthetic_route
    from cadre_tpu_torch.envs.torch_env import (
        DrivingEnv,
        EnvConfig,
        draw_step,
        make_route_bank,
    )
    from cadre_tpu_torch.rl.agent import CadreAgent
    from cadre_tpu_torch.rl.device_eval import EvalDraws, evaluate_device
    from cadre_tpu_torch.rl.device_rollout import ActDraws
    from cadre_tpu_torch.rl.distributions import gumbel

    k, n, steps = 2, 3, 8
    small = danet_params(da_feature_channel=32, inter_att_dims=24, z_dims=16)
    cfg = EnvConfig(n_vehicles=2, n_walkers=2, n_hazards=1,
                    n_junction_hazards=1, training=False)
    dense = [np.asarray([[0.0, 0.0], [1.0, 0.0], [2.0, 0.0]]),
             np.asarray([[0.0, 0.0], [0.0, 1.5], [0.0, 3.0]]),
             interpolate_route(synthetic_route(np.random.RandomState(4)))]
    gen = torch.Generator()
    gen.manual_seed(9)
    cpu = torch.device("cpu")
    draws = EvalDraws(draw_step(cfg, 3, n, gen, cpu), [
        ActDraws(gumbel((k, n, 33), gen, cpu), gumbel((k, n, 3), gen, cpu),
                 draw_step(cfg, 3, n, gen, cpu)) for _ in range(steps)])

    def on(dev, x):
        if isinstance(x, torch.Tensor):
            return x.to(dev)
        if isinstance(x, (tuple, list)):
            items = [on(dev, y) for y in x]
            return type(x)(*items) if hasattr(x, "_fields") else \
                type(x)(items)
        return x

    rows = {}
    for dev in ("cpu", "cuda"):
        agent = CadreAgent.create(small, seed=1, device=dev)
        with torch.no_grad():
            agent.encoder.da_head.sa.gamma.fill_(0.5)
            agent.encoder.da_head.sc.gamma.fill_(0.3)
        paths = member_snapshots(agent, k, f"smoke_small_members_{dev}")
        env = DrivingEnv(make_route_bank(3, seed=5, dense_routes=dense,
                                         device=dev), n, cfg, device=dev)
        rows[dev] = evaluate_device(agent, env, paths, draws=on(dev, draws))
    c, g = rows["cpu"], rows["cuda"]
    require(len(c) == len(g) >= 2, f"eval cuda vs cpu: {len(g)} rows on "
            f"the card, {len(c)} on the CPU")
    worst = [0.0, 0.0]
    for a, b in zip(g, c):
        for key in ("error", "steps", "red_lights", "stops"):
            require(a[key] == b[key], f"eval cuda vs cpu: {a} vs {b}")
        worst[0] = max(worst[0], abs(a["completion"] - b["completion"]))
        worst[1] = max(worst[1], abs(a["driving_score"] - b["driving_score"]))
    require(worst[0] <= 1e-3 and worst[1] <= 0.1,
            f"eval cuda vs cpu: completion {worst[0]:.3g}, driving score "
            f"{worst[1]:.3g}")
    print(f"[7d] eval cuda vs cpu, small f32 agent, K={k} N={n} {steps} "
          f"steps, same draws: {len(g)} rows, errors and steps equal; "
          f"completion within {worst[0]:.3g} (bound 1e-3), driving score "
          f"within {worst[1]:.3g} (bound 0.1)")


def expert_on_eval_bank(bank):
    """The scripted expert on the card over the eval bank: no traffic, no
    rendering, EVAL_ENVS envs for 300 steps."""
    import numpy as np
    import torch

    from cadre_tpu_torch.envs.torch_env import EnvConfig
    from cadre_tpu_torch.envs.torch_expert import expert_episode_stats

    steps = 300
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    comp, err = expert_episode_stats(
        bank, num_envs=EVAL_ENVS, steps=steps, seed=0, device="cuda",
        config=EnvConfig(render=False, n_vehicles=0, n_walkers=0))
    seconds = time.perf_counter() - t0
    require(np.isfinite(comp).all() and ((comp >= 0) & (comp <= 1)).all(),
            "expert: completion out of [0, 1]")
    share = float(np.mean(err == 6)) if len(err) else float("nan")
    mean = float(np.mean(comp)) if len(comp) else float("nan")
    print(f"[7e] expert over the eval bank, N={EVAL_ENVS}, {steps} steps "
          f"(no traffic, no rendering): {seconds:.3f} s, "
          f"{EVAL_ENVS * steps / seconds:.1f} env-steps/s; {len(comp)} "
          f"episodes finished, mean completion {mean:.4f}, success share "
          f"{share:.3f}")


# ---------------------------------------------------------------- phase 8

PERCEPTION_SHARDS = 4
PERCEPTION_STEPS = 20           # steps on one repeated batch
# parameters that must move in training: the backbone's stem and first
# block, the head's conv before PAM, the PAM projection and both gammas
PERCEPTION_WATCH = ("backbone.conv1.weight", "backbone.layer1.0.conv1.weight",
                    "da_head.conv5a.0.weight", "da_head.sa.query_conv.weight",
                    "da_head.sa.gamma", "da_head.sc.gamma")


def perception_shards(n_shards: int = PERCEPTION_SHARDS,
                      frames: int = PERCEPTION_BATCH, seed: int = 0) -> str:
    """`n_shards` shards of `frames` frames in the loader's .npz format,
    made from `seed` under build/smoke_perception/: a class map of sky and
    road split at a horizon with three boxes of other classes, the camera
    its palette colours with a per-frame brightness, a route raster
    ribbon of 255s, and labels drawn in their ranges. Returns the
    directory."""
    import glob
    import os

    import numpy as np

    rng = np.random.RandomState(seed)
    out = _smoke_dir("smoke_perception")
    for old in glob.glob(os.path.join(out, "*.npz")):
        os.remove(old)
    palette = rng.randint(0, 256, (8, 3))
    rows = np.arange(144)[None, :, None]
    for i in range(n_shards):
        horizon = rng.randint(50, 90, frames)
        seg = np.where(rows < horizon[:, None, None], 0, 1) \
            .repeat(256, 2).astype(np.uint8)
        route = np.zeros((frames, 256, 144), np.uint8)
        for f in range(frames):
            for cls in rng.randint(2, 8, 3):
                y, x = rng.randint(0, 120), rng.randint(0, 220)
                seg[f, y:y + rng.randint(8, 24), x:x + rng.randint(8, 36)] = cls
            c = rng.randint(40, 100)
            route[f, 100:, c:c + 8] = 255
        light = rng.uniform(0.8, 1.2, (frames, 1, 1, 1))
        rgb = np.clip(palette[seg] * light, 0, 255).astype(np.uint8)
        np.savez_compressed(
            os.path.join(out, f"shard_{i:05d}.npz"), camera_rgb=rgb,
            camera_seg=seg, route_fig=route,
            speed=rng.uniform(0, 8, frames),
            target_speed=np.full(frames, 7.0),
            steer=rng.uniform(-0.5, 0.5, frames),
            throttle=rng.uniform(0, 1, frames),
            command=rng.randint(0, 4, frames),
            light_state=rng.randint(0, 4, frames),
            light_dist=rng.uniform(-1, 30, frames),
            dis=rng.uniform(0, 1, frames), theta=rng.uniform(0, 1, frames))
    return out


def phase_perception():
    """Perception pretraining at full width and the handoff to PPO;
    returns the launch counts of the 20 repeated-batch steps and what
    phase 12 reuses: the trainer, its batch, the shards' directory, 8b's
    ms per step and peak memory."""
    import os

    import torch

    from cadre_tpu_torch.configs.danet_config import (
        PerceptionTrainParams,
        danet_params,
    )
    from cadre_tpu_torch.perception.data import (
        PerceptionDataLoader,
        compute_stats,
    )
    from cadre_tpu_torch.perception.trainer import PerceptionTrainer

    t0 = time.perf_counter()
    data_dir = perception_shards()
    loader = PerceptionDataLoader(data_dir, batch_size=PERCEPTION_BATCH,
                                  seed=0, packed=True, cache_in_memory=True)
    stats = compute_stats(loader.paths)
    print(f"[8a] {PERCEPTION_SHARDS} shards x {PERCEPTION_BATCH} frames "
          f"written to {os.path.relpath(data_dir)} in "
          f"{time.perf_counter() - t0:.2f} s; seg class weights "
          f"{[round(float(w), 4) for w in stats.seg_class_weight]}")

    cfg = danet_params()
    trainer = PerceptionTrainer(
        cfg, PerceptionTrainParams(batch_size=PERCEPTION_BATCH),
        steps_per_epoch=len(loader), seed=0,
        seg_class_weight=stats.seg_class_weight,
        light_class_weight=stats.light_class_weight, device="cuda")
    params = dict(trainer.model.named_parameters())
    before = {n: params[n].detach().clone() for n in PERCEPTION_WATCH}
    work = _smoke_dir("smoke_perception_work")
    t0 = time.perf_counter()
    epoch, launches = _counted(lambda: trainer.solve(
        loader, epochs=1, work_dir=work,
        log_fn=lambda line: print(f"[8b]   {line}")))
    seconds = time.perf_counter() - t0
    steps = len(loader)
    want = {"paint": 0, "dual_attention": steps, "dual_attention_bwd": steps}
    require(launches == want, f"perception epoch launches {launches}, "
            f"not {want}")
    require(all(v == v and abs(v) < float("inf") for v in epoch.values()),
            f"perception epoch losses {epoch}")
    require(os.path.exists(os.path.join(work, "net_epoch0.pt")),
            "solve wrote no net_epoch0.pt")
    print(f"[8b] solve: 1 epoch of {steps} steps at B={PERCEPTION_BATCH} "
          f"(full width, f32, prefetched packed batches) in {seconds:.2f} "
          f"s with first-call set-up; launches {launches}")

    batch = {k: torch.as_tensor(v).cuda() for k, v in next(iter(loader))
             .items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    losses, launches = _counted(lambda: [
        trainer.train_step(batch, sync=False)
        for _ in range(PERCEPTION_STEPS)])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    totals = [float(l["total"]) for l in losses]
    want = {"paint": 0, "dual_attention": PERCEPTION_STEPS,
            "dual_attention_bwd": PERCEPTION_STEPS}
    require(launches == want, f"perception launches {launches}, not {want}")
    for step in losses:
        for name, v in step.items():
            _finite(f"perception loss {name}", v)
    require(totals[-1] < totals[0], f"perception total did not fall over "
            f"{PERCEPTION_STEPS} steps: {totals[0]:.1f} -> {totals[-1]:.1f}")
    moved = {n: float((params[n].detach() - before[n]).abs().max())
             for n in PERCEPTION_WATCH}
    require(all(v > 0 for v in moved.values()), f"not moved: {moved}")
    for name, p in params.items():
        _finite(f"perception parameter {name}", p.detach())
    print(f"[8b] {PERCEPTION_STEPS} steps on one batch at B="
          f"{PERCEPTION_BATCH}: {seconds:.3f} s, "
          f"{PERCEPTION_STEPS * PERCEPTION_BATCH / seconds:.1f} train "
          f"frames/s ({seconds / PERCEPTION_STEPS * 1e3:.2f} ms per step); "
          f"peak memory allocated {peak / 2**30:.2f} GiB; total loss "
          f"{totals[0]:.1f} -> {totals[-1]:.1f} ("
          + ", ".join(f"{k} {float(v):.3f}" for k, v in losses[-1].items())
          + f"); largest moves {moved}; launches {launches}")
    prof_steps = 3
    profile(lambda: [trainer.train_step(batch, sync=False)
                     for _ in range(prof_steps)],
            f"{prof_steps} train steps (B={PERCEPTION_BATCH})", prof_steps,
            "train step", tag="8b")
    ckpt = os.path.join(work, "smoke_trained.pt")
    trainer.save(ckpt)
    perception_cpu_agreement(batch)
    perception_cli(data_dir)
    perception_handoff(trainer, ckpt, batch)
    return launches, dict(trainer=trainer, batch=batch, data_dir=data_dir,
                          step_ms=seconds / PERCEPTION_STEPS * 1e3,
                          peak=peak)


def _masks_to(masks, device):
    """Dropout masks (a DropoutMasks, a tuple of tensors or None) on
    `device`."""
    if masks is None:
        return None
    moved = [None if t is None else t.to(device) for t in masks]
    return type(masks)(*moved) if hasattr(masks, "_fields") else tuple(moved)


def step_agreement(tag, what, make, loss64, small, masks, wd):
    """One train step of a small model on the card and on the CPU from
    the same weights (`make(device)` builds the trainer, its model from a
    fixed seed), batch and dropout masks, at the schedule's peak rate.
    Losses within 1e-4 relative. Gradients against the CPU's own float64
    gradient (`loss64(trainer, masks)`, the total loss of the model in
    float64): each tensor on the card within max(1e-3 of its scale, 3x
    the CPU f32 gradient's own distance) (f32 rounding of the h*w-scaled
    losses moves some tensors by percents). Parameters: within 1% of the
    largest change on the CPU, at every element whose float64 gradient
    (with weight decay `wd`) is ten times above that tensor's f32
    rounding noise; below it Adam's first step takes the rounding's
    sign."""
    runs = {}
    for dev in ("cpu", "cuda", "cpu64"):
        trainer = make("cuda" if dev == "cuda" else "cpu")
        trainer.step = 1                    # lr(1) = tp.lr: the peak
        m = _masks_to(masks, trainer.device)
        init = {n: p.detach().cpu().double().clone()
                for n, p in trainer.model.named_parameters()}
        if dev == "cpu64":
            trainer.model.double()
            total = loss64(trainer, m)
            total.backward()
            loss = float(total.detach())
        else:
            loss = trainer.train_step(small, masks=m)["total"]
        named = dict(trainer.model.named_parameters())
        runs[dev] = (loss, init,
                     {n: p.grad.detach().cpu().double() for n, p in
                      named.items()},
                     {n: p.detach().cpu().double() for n, p in named.items()})
    check_step_agreement(tag, what, runs, wd, len(small["speed"]))


def check_step_agreement(tag, what, runs, wd, batch):
    """step_agreement's bounds on `runs`: {'cpu', 'cuda', 'cpu64'} ->
    (loss, initial parameters, gradients, parameters after the step), the
    tensors float64 on the CPU. Runs under 'f32_noise' (other f32 steps
    of the same function) add their distances from float64 to the CPU
    f32's as measures of f32 rounding: the largest sets the bound."""
    others = runs.get("f32_noise", [])
    (l_c, init, g_c, p_c), (l_g, _, g_g, p_g), (_, _, g64, _) = (
        runs["cpu"], runs["cuda"], runs["cpu64"])
    rel = abs(l_g - l_c) / abs(l_c)
    require(rel <= 1e-4, f"{what} step cuda vs cpu: loss {l_g} vs {l_c}")
    largest = max(float(g.abs().max()) for g in g64.values())
    worst_g, worst_p, checked = 0.0, 0.0, 0
    for n, exact in g64.items():
        scale = max(float(exact.abs().max()), 1e-6 * largest)
        noise = max(float((g[n] - exact).abs().max())
                    for g in [g_c] + [run[2] for run in others])
        err = float((g_g[n] - exact).abs().max())
        bound = max(1e-3 * scale, 3.0 * noise)
        require(err <= bound, f"{what} step cuda vs cpu: grad {n} "
                f"{err:.3g} from float64 (cpu f32: {noise:.3g}, scale "
                f"{scale:.3g})")
        worst_g = max(worst_g, err / bound)
        change = float((p_c[n] - init[n]).abs().max())
        require(change > 0 and bool((p_g[n] != init[n]).any()),
                f"{what} step: {n} did not move")
        firm = (exact + wd * init[n]).abs() > 10.0 * noise
        checked += int(firm.sum())
        if firm.any():
            d = float((p_g[n] - p_c[n])[firm].abs().max())
            require(d <= 0.01 * change, f"{what} step cuda vs cpu: "
                    f"{n} {d:.3g} > 1% of its largest change {change:.3g}")
            worst_p = max(worst_p, d / change)
    total = sum(g.numel() for g in g64.values())
    noise_of = "the cpu f32's distance" if not others else \
        f"the largest of {len(others) + 1} f32 steps' distances"
    print(f"[{tag}] one train step, {what}, B={batch}, cuda "
          f"vs cpu: loss {rel:.3g} relative (bound 1e-4); each gradient's "
          f"distance from the cpu's float64 one at most {worst_g:.3g} of its "
          f"bound (max(1e-3 of its scale, 3x {noise_of})); "
          f"parameters within {worst_p:.3g} of each tensor's largest change "
          f"at the {checked} of {total} elements whose gradient is firm "
          f"(bound 0.01)")


def _double_batch(trainer, small):
    return {k: v.double() if v.is_floating_point() else v
            for k, v in trainer._to_device(small).items()}


def perception_cpu_agreement(batch):
    """Phase 8c: step_agreement for a small f32 DANet on 4 frames."""
    import torch

    from cadre_tpu_torch.configs.danet_config import (
        PerceptionTrainParams,
        danet_params,
    )
    from cadre_tpu_torch.models.danet import draw_dropout_masks
    from cadre_tpu_torch.perception.trainer import PerceptionTrainer

    cfg = danet_params(da_feature_channel=32, inter_att_dims=24, z_dims=16)
    tp = PerceptionTrainParams(warmup_epochs=1)
    small = {k: v[:4].cpu() for k, v in batch.items()}
    gen = torch.Generator()
    gen.manual_seed(3)
    masks = draw_dropout_masks(cfg, 4, gen)

    def make(device):
        return PerceptionTrainer(cfg, tp, steps_per_epoch=1, seed=4,
                                 device=device)

    def loss64(trainer, m):
        tb = _double_batch(trainer, small)
        return trainer._losses(trainer._apply(tb, m), tb)[0]

    step_agreement("8c", "small f32 model", make, loss64, small, masks,
                   tp.weight_decay)


def perception_cli(data_dir):
    """`python -m cadre_tpu_torch.train_perception` on the shards, one
    epoch at B=48 with a held-out shard, in its own process."""
    import os
    import shutil

    root = os.path.dirname(os.path.abspath(__file__))
    work = os.path.join(root, "build", "smoke_perception_cli")
    shutil.rmtree(work, ignore_errors=True)
    cmd = [sys.executable, "-m", "cadre_tpu_torch.train_perception",
           "--data-dir", data_dir, "--epochs", "1", "--batch-size",
           str(PERCEPTION_BATCH), "--holdout", "--work-dir", work]
    t0 = time.perf_counter()
    out = subprocess.run(cmd, cwd=root, capture_output=True, text=True,
                         timeout=600)
    seconds = time.perf_counter() - t0
    require(out.returncode == 0, f"the perception CLI exited "
            f"{out.returncode}: {out.stderr[-3000:]}")
    for line in out.stdout.strip().splitlines():
        print(f"[8d]   {line}")
    require(os.path.exists(os.path.join(work, "net_epoch0.pt")),
            "the perception CLI wrote no net_epoch0.pt")
    print(f"[8d] python -m cadre_tpu_torch.train_perception --epochs 1 "
          f"--batch-size {PERCEPTION_BATCH} --holdout: exit 0 in "
          f"{seconds:.1f} s")


def perception_handoff(trainer, ckpt, batch):
    """PPO on the trained encoder: the training CLI with
    --danet-checkpoint in its own process, then an agent built from the
    checkpoint, whose folded latent must equal the trainer's net folded
    the same way bit for bit, and lie within FOLD_TOL of the trainer's
    unfolded latent."""
    import os
    import shutil

    import torch

    from cadre_tpu_torch.configs.danet_config import danet_params
    from cadre_tpu_torch.perception.data import unpack_batch
    from cadre_tpu_torch.rl.agent import CadreAgent
    from cadre_tpu_torch.utils.checkpoint import load_danet_checkpoint

    root = os.path.dirname(os.path.abspath(__file__))
    work = os.path.join(root, "build", "smoke_handoff")
    shutil.rmtree(work, ignore_errors=True)
    cmd = [sys.executable, "-m", "cadre_tpu_torch.main", "--env", "jax",
           "--danet-checkpoint", ckpt, "--num-envs", str(N_ENVS),
           "--num-steps", str(T_STEPS), "--iterations", "1", "--work-dir",
           work]
    t0 = time.perf_counter()
    out = subprocess.run(cmd, cwd=root, capture_output=True, text=True,
                         timeout=600)
    seconds = time.perf_counter() - t0
    require(out.returncode == 0, f"the CLI on the trained encoder exited "
            f"{out.returncode}: {out.stderr[-3000:]}")
    for line in out.stdout.strip().splitlines():
        print(f"[8e]   {line}")
    require(os.path.exists(os.path.join(work, "models", "ppo_model_1.pt")),
            "the CLI on the trained encoder wrote no snapshot")
    agent = CadreAgent.create(danet_params(), device="cuda",
                              encoder_state=load_danet_checkpoint(
                                  ckpt, danet_params()))
    x = unpack_batch(batch)["x"]
    trainer.model.eval()
    with torch.no_grad():
        want = trainer.model.latent(x)
        folded = folded_like_the_agent(trainer.model).latent(x)
        got = agent.encoder.latent(x)
    trainer.model.train()
    torch.cuda.synchronize()
    require(torch.equal(got, folded), f"agent latent differs from the "
            f"folded trainer's by {float((got - folded).abs().max()):.3g}")
    gap = folded_latent_gap(got, want)
    require(gap <= FOLD_TOL, f"agent latent differs from the trainer's by "
            f"{gap:.3g} (relative RMS; at most {FOLD_TOL})")
    print(f"[8e] python -m cadre_tpu_torch.main --env jax --danet-checkpoint "
          f"{os.path.relpath(ckpt, root)} --num-envs {N_ENVS} --num-steps "
          f"{T_STEPS} --iterations 1: exit 0 in {seconds:.1f} s; the agent's "
          f"folded f32 latent of {x.shape[0]} frames equals the folded "
          f"trainer's bit for bit and lies {gap:.3g} (relative RMS) from "
          f"the unfolded trainer's")


# ---------------------------------------------------------------- phase 9

T_HOST = 200            # RolloutConfig's default steps, as `--env sim` runs
HOST_PROFILE_TICKS = 20
T_SINGLE = 20           # steps of the `train` episode (`--num-envs 1`)


def _host_vec_env():
    from cadre_tpu_torch.envs.sim_env import SimDrivingEnv
    from cadre_tpu_torch.envs.vec_env import VecDrivingEnv

    return VecDrivingEnv([lambda k=k: SimDrivingEnv(seed=k, vehicle_num=(2, 2))
                          for k in range(N_HOST)])


def phase_host_env():
    """The host-env path of `--env sim --num-envs N_HOST` at production
    width (the f32 encoder root main.py builds): one counted train_vec
    iteration of T_HOST fused ticks after a T=2 warm-up, the act / env /
    update split, a profile of a short train_vec iteration, the counted
    `train` episode of `--num-envs 1`, then the CLI with N_HOST envs and
    with one. Returns the launch counts of the train_vec iteration and of
    the `train` episode, and the iteration's env-steps/s and split."""
    import torch

    from cadre_tpu_torch.configs.agent_config import (
        RolloutConfig,
        TrainConfig,
    )
    from cadre_tpu_torch.configs.danet_config import danet_params
    from cadre_tpu_torch.rl.agent import CadreAgent
    from cadre_tpu_torch.rl.vec_train import train_vec

    t0 = time.perf_counter()
    agent = CadreAgent.create(danet_params(), device="cuda")
    vec = _host_vec_env()
    f, train_cfg = agent.obs_dim, TrainConfig()
    train_vec(vec, agent, RolloutConfig(num_steps=2, feature_dims=f),
              train_cfg, iterations=1, seed=1)
    torch.cuda.synchronize()
    print(f"[9] set-up (agent, {N_HOST} sim envs, warm-up iteration T=2) "
          f"{time.perf_counter() - t0:.2f} s")

    before = [p.detach().clone() for p in agent.policy_parameters()]
    rollout_cfg = RolloutConfig(num_steps=T_HOST, feature_dims=f)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    stats, launches = _counted(lambda: train_vec(
        vec, agent, rollout_cfg, train_cfg, iterations=1, seed=2))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    s = stats[0]
    # one encoder call, so one launch, per tick and one for the bootstrap;
    # `refreshes` of them encode whole windows (B = 8 * N_HOST)
    require(launches == {"paint": 0, "dual_attention": T_HOST + 1,
                         "dual_attention_bwd": 0},
            f"host iteration launches {launches}, not 0 / {T_HOST + 1} / 0")
    losses = [s.value_loss, s.policy_loss, s.entropy_loss]
    require(all(map(math.isfinite, losses)), f"losses {losses}")
    params = agent.policy_parameters()
    for i, p in enumerate(params):
        _finite(f"policy parameter {i}", p.detach())
    moved = sum(not torch.equal(a, b.detach()) for a, b in zip(before, params))
    require(moved == len(params),
            f"only {moved} of {len(params)} policy tensors moved")
    steps = T_HOST * N_HOST
    split = ", ".join(f"{k} {v:.3f} s ({100 * v / seconds:.1f}%)"
                      for k, v in s.phase_seconds.items())
    print(f"[9] train_vec N={N_HOST} T={T_HOST} E={train_cfg.ppo_epoch} "
          f"M={rollout_cfg.mini_batch_num}, f32 encoder: {seconds:.3f} s, "
          f"{steps / seconds:.1f} env-steps/s; {split}; {s.refreshes} "
          f"refresh ticks (B={8 * N_HOST}), {T_HOST + 1 - s.refreshes} "
          f"incremental (B={N_HOST}); {s.episodes_finished} episodes ended; "
          f"peak memory allocated {peak / 2**30:.2f} GiB; losses value "
          f"{s.value_loss:.5f} policy {s.policy_loss:.5f} entropy "
          f"{s.entropy_loss:.5f}; launches {launches}")

    figure = {"env_steps_per_s": steps / seconds, "seconds": seconds,
              "split": {k: v / seconds for k, v in s.phase_seconds.items()}}
    prof = profile(lambda: train_vec(
        vec, agent, RolloutConfig(num_steps=HOST_PROFILE_TICKS,
                                  feature_dims=f),
        train_cfg, iterations=1, seed=3)[0],
        f"one train_vec iteration of {HOST_PROFILE_TICKS} ticks (its update "
        f"included)", HOST_PROFILE_TICKS, "tick", tag="9")
    split = ", ".join(f"{k} {v:.3f} s" for k, v in prof.phase_seconds.items())
    print(f"[9]   its split under the profiler: {split}")
    single = host_single(agent)
    host_cli()
    return launches, single, figure


class _LastDone:
    """A host env that remembers whether its last step ended the
    episode."""

    def __init__(self, env):
        self.env, self.done = env, False

    def reset(self):
        return self.env.reset()

    def step(self, control):
        obs, reward, self.done, info = self.env.step(control)
        return obs, reward, self.done, info


def host_single(agent):
    """One episode of `rl.train.train` (the `--num-envs 1` loop) on one sim
    env, T_SINGLE steps, launches counted: each act encodes the whole
    8-frame window in one launch, and the bootstrap is one more unless the
    episode ended on its last step. Returns the launch counts."""
    import torch

    from cadre_tpu_torch.configs.agent_config import (
        RolloutConfig,
        TrainConfig,
    )
    from cadre_tpu_torch.envs.sim_env import SimDrivingEnv
    from cadre_tpu_torch.rl.train import train

    env = _LastDone(SimDrivingEnv(seed=0, vehicle_num=(2, 2)))
    cfg = RolloutConfig(num_steps=T_SINGLE, feature_dims=agent.obs_dim)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    stats, launches = _counted(lambda: train(
        env, agent, cfg, TrainConfig(), max_episode=1, seed=4))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    acts = T_SINGLE + (0 if env.done else 1)
    require(launches == {"paint": 0, "dual_attention": acts,
                         "dual_attention_bwd": 0},
            f"train episode launches {launches}, not 0 / {acts} / 0")
    s = stats[0]
    losses = [s.value_loss, s.policy_loss, s.entropy_loss]
    require(all(map(math.isfinite, losses)), f"train losses {losses}")
    boot = ("skipped: the last step ended the episode" if env.done
            else "included")
    print(f"[9] train (--num-envs 1) T={T_SINGLE}, one episode: "
          f"{seconds:.3f} s, {T_SINGLE / seconds:.1f} env-steps/s; "
          f"{acts} acts of B=8 (bootstrap {boot}); "
          f"losses value {s.value_loss:.5f} policy {s.policy_loss:.5f} "
          f"entropy {s.entropy_loss:.5f}; launches {launches}")
    return launches


def host_cli():
    """`python -m cadre_tpu_torch.main --env sim` at production width, with
    N_HOST envs for two iterations of 20 steps and with one env for one
    episode of 20 steps, each in its own process; each snapshot must load
    into a fresh agent."""
    import os
    import shutil

    import torch

    from cadre_tpu_torch.configs.danet_config import danet_params
    from cadre_tpu_torch.rl.agent import CadreAgent

    root = os.path.dirname(os.path.abspath(__file__))
    runs = {"vec": (["--num-envs", str(N_HOST), "--iterations", "2"],
                    os.path.join("models", "ppo_model_0.pt")),
            "one": (["--num-envs", "1", "--episodes", "1"],
                    os.path.join("0", "models", "ppo_model_0.pt"))}
    agent = CadreAgent.create(danet_params(), seed=1, device="cuda")
    for name, (flags, snapshot) in runs.items():
        work = _smoke_dir(f"smoke_host_{name}")
        shutil.rmtree(work, ignore_errors=True)
        cmd = [sys.executable, "-m", "cadre_tpu_torch.main", "--env", "sim",
               *flags, "--num-steps", "20", "--work-dir", work]
        t0 = time.perf_counter()
        out = subprocess.run(cmd, cwd=root, capture_output=True, text=True,
                             timeout=600)
        seconds = time.perf_counter() - t0
        require(out.returncode == 0, f"the {name} CLI exited "
                f"{out.returncode}: {out.stderr[-3000:]}")
        for line in (out.stderr + out.stdout).strip().splitlines()[-3:]:
            print(f"[9]   {line}")
        path = os.path.join(work, snapshot)
        require(os.path.exists(path), f"the CLI wrote no {path}")
        agent.load_snapshot(path)
        saved = torch.load(path, map_location="cuda", weights_only=True)
        for sig in ("steer", "throttle"):
            for k, v in getattr(agent, sig).state_dict().items():
                require(torch.equal(v, saved[sig][k]),
                        f"snapshot {sig}.{k} did not load back equal")
        print(f"[9] python -m cadre_tpu_torch.main --env sim "
              f"{' '.join(flags)} --num-steps 20: exit 0 in {seconds:.1f} s; "
              f"{os.path.relpath(path, root)} loads back equal")


# --------------------------------------------------------------- phase 10

# the host-env eval: K member snapshots, as many episodes, each cut at
# HOST_EVAL_STEPS ticks (root eval.py's evaluate, max_steps)
HOST_EVAL_MEMBERS = 4
HOST_EVAL_EPISODES = 2
HOST_EVAL_STEPS = 200
# scenario types armed on every route of the eval, at these metres along it
HOST_EVAL_SCENARIOS = (("Scenario1", 2), ("Scenario3", 10),
                       ("Scenario7", 20), ("Scenario10", 30))
# the eval's traffic: root eval.py's (and `python -m cadre_tpu_torch.eval`'s)
# defaults, --vehicles 20 --walkers 50
HOST_EVAL_TRAFFIC = (20, 50)


def host_eval_files(n_routes: int, n_short: int, name: str):
    """A route XML of town_maps.write_lane_routes and a scenario JSON with
    HOST_EVAL_SCENARIOS' triggers on each of its routes, under build/;
    returns their paths."""
    import json
    import os

    import numpy as np

    from cadre_tpu_torch.envs.route_parser import (
        interpolate_route,
        parse_routes_file,
    )
    from cadre_tpu_torch.envs.town_maps import write_lane_routes

    work = _smoke_dir(name)
    routes = write_lane_routes(os.path.join(work, "routes.xml"), n_routes,
                               n_short=n_short)
    events = []
    for cfg in parse_routes_file(routes):
        dense = interpolate_route(np.asarray([w.xy for w in cfg.trajectory]))
        for stype, metres in HOST_EVAL_SCENARIOS:
            x, y = dense[min(metres, len(dense) - 1)]
            events.append({"scenario_type": stype,
                           "available_event_configurations": [
                               {"transform": {"x": float(x), "y": float(y),
                                              "z": 0.0, "yaw": 0.0}}]})
    scenarios = os.path.join(work, "scenarios.json")
    with open(scenarios, "w") as f:
        json.dump({"available_scenarios": [{"Town01": events}]}, f)
    return routes, scenarios


def phase_host_eval(in_process):
    """The host-env eval and the process envs at production width (the
    f32 encoder of root eval.py and main.py): (a) `rl.evaluate.evaluate`
    of HOST_EVAL_MEMBERS members over HOST_EVAL_EPISODES scenario-armed
    sim episodes of at most HOST_EVAL_STEPS ticks, launches counted (one
    dual-attention launch per tick: EnsembleAgent.act encodes the tick's 8
    frames once for every member); (b) the same eval on the card and on
    the CPU from the same draws; (c) `python -m cadre_tpu_torch.eval` on
    a 12 m route with the scenarios; (d) the native rasterizer against
    numpy; (e) one counted train_vec iteration of N_HOST sim envs in
    worker processes (`--proc-envs`), T_HOST ticks, beside phase 9's
    in-process figure `in_process`. Returns the launch counts of (a) and
    of (e)."""
    import os

    import torch

    from cadre_tpu_torch.configs.agent_config import EvalConfig
    from cadre_tpu_torch.configs.danet_config import danet_params
    from cadre_tpu_torch.envs.sim_env import SimDrivingEnv
    from cadre_tpu_torch.rl.agent import CadreAgent
    from cadre_tpu_torch.rl.evaluate import evaluate

    card = card_line()
    routes, scenarios = host_eval_files(HOST_EVAL_EPISODES, 0,
                                        "smoke_host_eval")
    agent = CadreAgent.create(danet_params(), seed=2, device="cuda")
    paths = member_snapshots(agent, HOST_EVAL_MEMBERS, "smoke_host_members")
    env = SimDrivingEnv(routes_file=routes, scenario_file=scenarios,
                        vehicle_num=HOST_EVAL_TRAFFIC, training=False, seed=0,
                        work_dir=_smoke_dir("smoke_host_eval_run"))
    csv = os.path.join(_smoke_dir("smoke_host_eval_run"),
                       "criteria_results.csv")
    if os.path.exists(csv):
        os.remove(csv)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    results, launches = _counted(lambda: evaluate(
        env, agent, paths, EvalConfig(eval_episode=HOST_EVAL_EPISODES),
        seed=0, max_steps=HOST_EVAL_STEPS, result_file=csv))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    ticks = sum(r.steps for r in results)
    require(len(results) == HOST_EVAL_EPISODES and ticks > 0,
            f"host eval: {len(results)} episodes, {ticks} ticks")
    require(launches == {"paint": 0, "dual_attention": ticks,
                         "dual_attention_bwd": 0},
            f"host eval launches {launches}, not 0 / {ticks} / 0")
    for r in results:
        require(0.0 <= r.completion_ratio <= 100.0
                and 0.0 <= r.driving_score <= 100.0
                and 0 < r.steps <= HOST_EVAL_STEPS, f"host eval: bad {r}")
    with open(csv) as f:
        rows = f.read().strip().splitlines()
    require(len(rows) == 1 + HOST_EVAL_EPISODES
            and rows[0].startswith("RouteCompletionTest"),
            f"host eval: criteria CSV has {len(rows)} lines")
    mean_completion = sum(r.completion_ratio for r in results) / len(results)
    mean_score = sum(r.driving_score for r in results) / len(results)
    print(f"[10a] host eval, K={HOST_EVAL_MEMBERS} members, f32 encoder, "
          f"{HOST_EVAL_EPISODES} sim episodes ({HOST_EVAL_TRAFFIC[0]} "
          f"vehicles, {HOST_EVAL_TRAFFIC[1]} walkers, "
          f"{', '.join(t for t, _ in HOST_EVAL_SCENARIOS)} on each route), "
          f"max {HOST_EVAL_STEPS} steps: {ticks} ticks in {seconds:.3f} s, "
          f"{ticks / seconds:.1f} ticks/s, "
          f"{HOST_EVAL_MEMBERS * ticks / seconds:.1f} member-steps/s; "
          f"episodes {[(r.steps, r.error_message) for r in results]}; mean "
          f"completion {mean_completion:.2f}%, mean driving score "
          f"{mean_score:.2f}; criteria CSV {len(rows) - 1} rows; peak memory "
          f"allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
          f"launches {launches}; card {card}")
    host_eval_cpu_agreement(routes, scenarios)
    host_eval_cli(paths, scenarios)
    native_raster_agreement()
    proc = host_proc_envs(in_process, card)
    return launches, proc


def host_eval_cpu_agreement(routes, scenarios):
    """A small f32 agent, K=2 members, two scenario-armed sim episodes of
    at most 30 ticks at the eval's traffic, on the card and on the CPU
    from the same draws: every member's (steer, throttle) pair equal on
    every tick, equal steps and end messages, completion within 1e-3 and
    driving score within 0.1 (the figures of phase 7d)."""
    import torch

    from cadre_tpu_torch.configs.agent_config import EvalConfig
    from cadre_tpu_torch.configs.danet_config import danet_params
    from cadre_tpu_torch.envs.sim_env import SimDrivingEnv
    from cadre_tpu_torch.rl.agent import CadreAgent, EnsembleAgent
    from cadre_tpu_torch.rl.distributions import gumbel
    from cadre_tpu_torch.rl.evaluate import evaluate

    k, episodes, steps = 2, 2, 30
    small = danet_params(da_feature_channel=32, inter_att_dims=24, z_dims=16)
    gen = torch.Generator()
    gen.manual_seed(11)
    cpu = torch.device("cpu")
    draws = [(gumbel((k, 1, 33), gen, cpu), gumbel((k, 1, 3), gen, cpu))
             for _ in range(episodes * steps)]
    out, acts = {}, {}
    act = EnsembleAgent.act
    for dev in ("cpu", "cuda"):
        agent = CadreAgent.create(small, seed=1, device=dev)
        with torch.no_grad():
            agent.encoder.da_head.sa.gamma.fill_(0.5)
            agent.encoder.da_head.sc.gamma.fill_(0.3)
        paths = member_snapshots(agent, k, f"smoke_small_host_members_{dev}")
        env = SimDrivingEnv(routes_file=routes, scenario_file=scenarios,
                            vehicle_num=HOST_EVAL_TRAFFIC, training=False,
                            seed=3)
        acts[dev] = record = []

        def recorded(self, tick_data, noise, record=record):
            record.append(act(self, tick_data, noise))
            return record[-1]

        EnsembleAgent.act = recorded      # every member's pair, every tick
        try:
            out[dev] = evaluate(env, agent, paths,
                                EvalConfig(eval_episode=episodes), seed=0,
                                max_steps=steps, draws=draws)
        finally:
            EnsembleAgent.act = act
    differ = [t for t, (a, b) in enumerate(zip(acts["cuda"], acts["cpu"]))
              if a != b]
    require(len(acts["cuda"]) == len(acts["cpu"]) > 0 and not differ,
            f"host eval cuda vs cpu: {len(acts['cuda'])} / "
            f"{len(acts['cpu'])} ticks, actions differ at ticks {differ[:5]}"
            + (f": {acts['cuda'][differ[0]]} vs {acts['cpu'][differ[0]]}"
               if differ else ""))
    worst = [0.0, 0.0]
    for a, b in zip(out["cuda"], out["cpu"]):
        require((a.steps, a.error_message) == (b.steps, b.error_message),
                f"host eval cuda vs cpu: {a} vs {b}")
        worst[0] = max(worst[0], abs(a.completion_ratio - b.completion_ratio))
        worst[1] = max(worst[1], abs(a.driving_score - b.driving_score))
    require(worst[0] <= 1e-3 and worst[1] <= 0.1,
            f"host eval cuda vs cpu: completion {worst[0]:.3g}, driving "
            f"score {worst[1]:.3g}")
    print(f"[10b] host eval cuda vs cpu, small f32 agent, K={k}, "
          f"{episodes} episodes of at most {steps} ticks "
          f"({HOST_EVAL_TRAFFIC[0]} vehicles, {HOST_EVAL_TRAFFIC[1]} "
          f"walkers), same draws: the {k} members' (steer, throttle) pairs "
          f"equal on all {len(acts['cuda'])} ticks, steps and end messages "
          f"equal, completion within {worst[0]:.3g} (bound 1e-3), driving "
          f"score within {worst[1]:.3g} (bound 0.1)")


def host_eval_cli(paths, scenarios):
    """`python -m cadre_tpu_torch.eval --env sim` at production width on
    one 12 m route with the scenarios and the CLI's default traffic, the
    members given by a glob: exit 0 and root eval.py's closing line."""
    import os
    import shutil

    root = os.path.dirname(os.path.abspath(__file__))
    routes, _ = host_eval_files(1, 1, "smoke_host_eval_cli")
    work = _smoke_dir("smoke_host_eval_cli_run")
    shutil.rmtree(work, ignore_errors=True)
    cmd = [sys.executable, "-m", "cadre_tpu_torch.eval", "--env", "sim",
           "--snapshots", os.path.join(os.path.dirname(paths[0]), "*.pt"),
           "--routes", routes, "--scenarios", scenarios, "--episodes", "1",
           "--work-dir", work]
    t0 = time.perf_counter()
    out = subprocess.run(cmd, cwd=root, capture_output=True, text=True,
                         timeout=600)
    seconds = time.perf_counter() - t0
    require(out.returncode == 0, f"the eval CLI exited {out.returncode}: "
            f"{out.stderr[-3000:]}")
    last = out.stdout.strip().splitlines()[-1]
    require(last.startswith("mean completion ratio over 1 episodes: "),
            f"the eval CLI's last line: {last!r}")
    for line in out.stderr.strip().splitlines()[-2:]:
        print(f"[10c]   {line}")
    print(f"[10c] python -m cadre_tpu_torch.eval --env sim --snapshots "
          f"<{len(paths)} members> --routes <one 12 m route> --scenarios "
          f"<{len(HOST_EVAL_SCENARIOS)} types> --episodes 1: exit 0 in "
          f"{seconds:.1f} s; {last}")


def native_raster_agreement():
    """The native route rasterizer against its numpy version on this
    machine: random polylines, half-pixel ones (ties) and ones across the
    canvas edges, bit-equal."""
    import numpy as np

    from cadre_tpu_torch.envs import route_fig

    rng = np.random.RandomState(0)
    for i in range(60):
        n = rng.randint(2, 30)
        pts = np.cumsum(rng.uniform(-14, 14, (n, 2)), axis=0) + [72, 128]
        if i % 3 == 1:
            pts = np.round(pts * 2) / 2
        if i % 3 == 2:
            pts = rng.uniform(-20, 280, (n, 2))
        require(np.array_equal(route_fig.rasterize_polyline(pts),
                               route_fig.rasterize_polyline_numpy(pts)),
                f"native raster differs from numpy on polyline {i}")
    print("[10d] native route rasterizer bit-equal to numpy on 60 "
          "polylines (random, half-pixel, across the edges)")


# ticks of the envs stepped alone, with no agent: the env phase's own rate
ENV_ALONE_TICKS = 100


def _env_alone(vec) -> float:
    """env-steps/s of `vec` stepped ENV_ALONE_TICKS ticks on fixed
    controls (half throttle, straight), after a reset, with no agent."""
    vec.reset()
    controls = [[0.0, 0.5, 0.0]] * vec.num_envs
    t0 = time.perf_counter()
    for _ in range(ENV_ALONE_TICKS):
        vec.step(controls)
    return ENV_ALONE_TICKS * vec.num_envs / (time.perf_counter() - t0)


def host_proc_envs(in_process, card):
    """One train_vec iteration of N_HOST sim envs (2 vehicles, 2 walkers,
    as phase 9) in worker processes behind the shared-memory rings
    (`main.py --proc-envs`), T_HOST fused ticks after a T=2 warm-up, its
    launches counted, its env-steps/s and split beside phase 9's
    in-process iteration; then the same envs stepped alone, in process
    and in workers. Returns the launch counts."""
    import functools
    import math
    import os

    import torch

    from cadre_tpu_torch.configs.agent_config import (
        RolloutConfig,
        TrainConfig,
    )
    from cadre_tpu_torch.configs.danet_config import danet_params
    from cadre_tpu_torch.envs.sim_env import SimDrivingEnv
    from cadre_tpu_torch.rl.agent import CadreAgent
    from cadre_tpu_torch.rl.vec_train import train_vec
    from cadre_tpu_torch.runtime.proc_vec_env import ProcVecDrivingEnv

    t0 = time.perf_counter()
    agent = CadreAgent.create(danet_params(), device="cuda")
    vec = ProcVecDrivingEnv([functools.partial(SimDrivingEnv, seed=k,
                                               vehicle_num=(2, 2))
                             for k in range(N_HOST)])
    try:
        f, train_cfg = agent.obs_dim, TrainConfig()
        train_vec(vec, agent, RolloutConfig(num_steps=2, feature_dims=f),
                  train_cfg, iterations=1, seed=1)
        torch.cuda.synchronize()
        print(f"[10e] set-up (agent, {N_HOST} env worker processes, warm-up "
              f"iteration T=2) {time.perf_counter() - t0:.2f} s")
        rollout_cfg = RolloutConfig(num_steps=T_HOST, feature_dims=f)
        t0 = time.perf_counter()
        stats, launches = _counted(lambda: train_vec(
            vec, agent, rollout_cfg, train_cfg, iterations=1, seed=2))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        alone_proc = _env_alone(vec)
    finally:
        vec.close()
    alone_in = _env_alone(_host_vec_env())
    require(not any(p.is_alive() for p in vec._procs),
            "an env worker outlived close()")
    require(launches == {"paint": 0, "dual_attention": T_HOST + 1,
                         "dual_attention_bwd": 0},
            f"--proc-envs launches {launches}, not 0 / {T_HOST + 1} / 0")
    s = stats[0]
    losses = [s.value_loss, s.policy_loss, s.entropy_loss]
    require(all(map(math.isfinite, losses)), f"--proc-envs losses {losses}")
    steps = T_HOST * N_HOST
    split = ", ".join(f"{k} {v:.3f} s ({100 * v / seconds:.1f}%)"
                      for k, v in s.phase_seconds.items())
    before = ", ".join(f"{k} {100 * v:.1f}%"
                       for k, v in in_process["split"].items())
    print(f"[10e] train_vec --proc-envs N={N_HOST} T={T_HOST} "
          f"E={train_cfg.ppo_epoch} M={rollout_cfg.mini_batch_num}, f32 "
          f"encoder: {seconds:.3f} s, {steps / seconds:.1f} env-steps/s; "
          f"{split}; {s.episodes_finished} episodes ended; launches "
          f"{launches}; card {card}")
    print(f"[10e] beside phase 9's in-process iteration: "
          f"{in_process['env_steps_per_s']:.1f} env-steps/s ({before}); "
          f"process envs {steps / seconds:.1f} env-steps/s, "
          f"{steps / seconds / in_process['env_steps_per_s']:.2f}x; card "
          f"{card}")
    print(f"[10e] the {N_HOST} envs stepped alone ({ENV_ALONE_TICKS} ticks, "
          f"no agent): in process {alone_in:.1f} env-steps/s, in worker "
          f"processes {alone_proc:.1f} env-steps/s "
          f"({alone_proc / alone_in:.2f}x); {os.cpu_count()} CPU cores")
    return launches


# --------------------------------------------------------------- phase 11

ZOO_FRAMES = 1024               # collected frames: two shards of 512
ZOO_SHARD = 512
ZOO_STEPS = 20                  # timed DABetaVAE steps on one batch
ZOO_CLI_FRAMES = 96             # frames the oldv2_vae CLI collects itself
# the DABetaVAE parameters that must move: the stem, the head's conv
# before PAM, the PAM projection and both gammas
ZOO_WATCH = ("backbone.conv1.weight", "da_head.conv5a.0.weight",
             "da_head.sa.query_conv.weight", "da_head.sa.gamma",
             "da_head.sc.gamma")


def zoo_collect():
    """11a: ZOO_FRAMES expert frames from the port's sim with the
    perception CLI's collection settings; returns the shard directory."""
    import glob
    import os

    import numpy as np

    from cadre_tpu_torch.envs.expert import OracleExpert
    from cadre_tpu_torch.envs.sim_env import SimDrivingEnv
    from cadre_tpu_torch.perception.data import (
        PerceptionDataLoader,
        collect_dataset,
    )

    out = _smoke_dir("smoke_collect")
    for old in glob.glob(os.path.join(out, "*.npz")):
        os.remove(old)
    env = SimDrivingEnv(seed=0, seq_length=2, vehicle_num=(8, 8),
                        randomize_weather=True, light_times=(3.0, 3.0, 3.0),
                        npc_cruise=(1.5, 5.0))
    t0 = time.perf_counter()
    shards = collect_dataset(env, OracleExpert(), ZOO_FRAMES, out,
                             shard_size=ZOO_SHARD)
    seconds = time.perf_counter() - t0
    require(len(shards) == ZOO_FRAMES // ZOO_SHARD, f"shards {shards}")
    seg, light, geom = set(), set(), []
    for path in shards:
        with np.load(path) as z:
            seg |= set(np.unique(z["camera_seg"]).tolist())
            light |= set(np.unique(z["light_state"]).tolist())
            geom.append(np.stack([z["dis"], z["theta"]]))
    require(len(seg) >= 4, f"collected seg classes {sorted(seg)}")
    require(len(light) >= 2, f"collected light states {sorted(light)}")
    require(bool(np.isfinite(np.concatenate(geom, 1)).all()),
            "collected dis / theta not finite")
    loader = PerceptionDataLoader(out, batch_size=PERCEPTION_BATCH)
    require(loader.num_frames == ZOO_FRAMES, f"the loader reads "
            f"{loader.num_frames} frames")
    print(f"[11a] collect_dataset: {ZOO_FRAMES} frames in {len(shards)} "
          f"shards from SimDrivingEnv (8 vehicles, 8 walkers, random "
          f"weather, 3/3/3 s lights) and OracleExpert in {seconds:.2f} s, "
          f"{ZOO_FRAMES / seconds:.1f} collected frames/s; seg classes "
          f"{sorted(seg)}, light states {sorted(light)}")
    return out


def zoo_da_beta_vae(data_dir):
    """11b: auto_da_beta_vae at full width through PerceptionTrainer's
    zoo path: one epoch of solve on shard 0 with shard 1 as eval_loader
    (recon PNGs read back), then ZOO_STEPS timed steps on one batch;
    returns their launch counts."""
    import os
    import shutil

    import torch

    from cadre_tpu_torch.configs.danet_config import PerceptionTrainParams
    from cadre_tpu_torch.configs.experiments import experiment_params
    from cadre_tpu_torch.models.registry import build_model
    from cadre_tpu_torch.perception.data import (
        PerceptionDataLoader,
        compute_stats,
    )
    from cadre_tpu_torch.perception.trainer import PerceptionTrainer
    from cadre_tpu_torch.perception.visualize import read_png

    paths = PerceptionDataLoader(data_dir).paths
    loader = PerceptionDataLoader(paths[:1], batch_size=PERCEPTION_BATCH,
                                  seed=0, packed=True, cache_in_memory=True)
    held = PerceptionDataLoader(paths[1:], batch_size=PERCEPTION_BATCH,
                                seed=1, packed=True, cache_in_memory=True)
    stats = compute_stats(loader.paths)
    cfg = experiment_params("auto_da_beta_vae")
    model = build_model("da_beta_vae", cfg, seed=0)
    trainer = PerceptionTrainer(
        cfg, PerceptionTrainParams(batch_size=PERCEPTION_BATCH),
        steps_per_epoch=len(loader), seed=0,
        seg_class_weight=stats.seg_class_weight,
        light_class_weight=stats.light_class_weight, device="cuda",
        model=model)
    params = dict(trainer.model.named_parameters())
    before = {n: params[n].detach().clone() for n in ZOO_WATCH}
    work = _smoke_dir("smoke_zoo_work")
    shutil.rmtree(os.path.join(work, "recon_epoch0"), ignore_errors=True)
    t0 = time.perf_counter()
    epoch, launches = _counted(lambda: trainer.solve(
        loader, epochs=1, work_dir=work, eval_loader=held,
        log_fn=lambda line: print(f"[11b]   {line}")))
    seconds = time.perf_counter() - t0
    steps, evals = len(loader), len(held)
    want = {"paint": 0, "dual_attention": steps + evals + 1,
            "dual_attention_bwd": steps}
    require(launches == want, f"DABetaVAE solve launches {launches}, "
            f"not {want} (train steps, eval batches and the recon batch)")
    require(all(v == v and abs(v) < float("inf") for v in epoch.values())
            and "visual_kld" in epoch, f"DABetaVAE epoch losses {epoch}")
    require(os.path.exists(os.path.join(work, "net_epoch0.pt")),
            "solve wrote no net_epoch0.pt")
    pngs = sorted(os.listdir(os.path.join(work, "recon_epoch0")))
    require(pngs == [f"sample_{i}.png" for i in range(4)], f"recon {pngs}")
    grid = read_png(os.path.join(work, "recon_epoch0", "sample_0.png"))
    require(grid.shape == (144, 4 * 256, 3), f"recon grid {grid.shape}")
    print(f"[11b] solve: 1 epoch of {steps} steps at B={PERCEPTION_BATCH} "
          f"(auto_da_beta_vae: input mode 5, output mode 9, full width, "
          f"f32) and an eval of {evals} batches in {seconds:.2f} s with "
          f"first-call set-up; recon PNGs {pngs} read back, grid "
          f"{grid.shape}; launches {launches}")

    batch = {k: torch.as_tensor(v).cuda() for k, v in next(iter(loader))
             .items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    losses, launches = _counted(lambda: [
        trainer.train_step(batch, sync=False) for _ in range(ZOO_STEPS)])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    totals = [float(l["total"]) for l in losses]
    want = {"paint": 0, "dual_attention": ZOO_STEPS,
            "dual_attention_bwd": ZOO_STEPS}
    require(launches == want, f"DABetaVAE launches {launches}, not {want}")
    for step in losses:
        for name, v in step.items():
            _finite(f"DABetaVAE loss {name}", v)
    require(totals[-1] < totals[0], f"DABetaVAE total did not fall over "
            f"{ZOO_STEPS} steps: {totals[0]:.1f} -> {totals[-1]:.1f}")
    moved = {n: float((params[n].detach() - before[n]).abs().max())
             for n in ZOO_WATCH}
    require(all(v > 0 for v in moved.values()), f"not moved: {moved}")
    for name, p in params.items():
        _finite(f"DABetaVAE parameter {name}", p.detach())
    print(f"[11b] {ZOO_STEPS} DABetaVAE steps on one batch at B="
          f"{PERCEPTION_BATCH}: {seconds:.3f} s, "
          f"{ZOO_STEPS * PERCEPTION_BATCH / seconds:.1f} train frames/s "
          f"({seconds / ZOO_STEPS * 1e3:.2f} ms per step); peak memory "
          f"allocated {peak / 2**30:.2f} GiB; total loss {totals[0]:.1f} -> "
          f"{totals[-1]:.1f} ("
          + ", ".join(f"{k} {float(v):.3f}" for k, v in losses[-1].items())
          + f"); largest moves {moved}; launches {launches}")
    prof_steps = 3
    profile(lambda: [trainer.train_step(batch, sync=False)
                     for _ in range(prof_steps)],
            f"{prof_steps} DABetaVAE train steps (B={PERCEPTION_BATCH})",
            prof_steps, "train step", tag="11b")
    return launches, batch


def zoo_cil_timing(batch):
    """11b: ZOO_STEPS CILTrainer steps of a CilrsNet (resnet18, train_cil's
    default) on one batch of B=PERCEPTION_BATCH frames; frames/s and peak
    memory."""
    import torch

    from cadre_tpu_torch.configs.danet_config import PerceptionTrainParams
    from cadre_tpu_torch.models.cil import CilrsNet
    from cadre_tpu_torch.models.registry import seeded
    from cadre_tpu_torch.perception.cil_trainer import CILTrainer

    model = seeded(0, lambda: CilrsNet(arch="resnet18"))
    trainer = CILTrainer(model, PerceptionTrainParams(
        batch_size=PERCEPTION_BATCH), steps_per_epoch=ZOO_STEPS, seed=0,
        device="cuda")
    trainer.train_step(batch)                 # first launches, cuDNN choices
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    losses, launches = _counted(lambda: [
        trainer.train_step(batch, sync=False) for _ in range(ZOO_STEPS)])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    for step in losses:
        for name, v in step.items():
            _finite(f"CIL loss {name}", v)
    require(sum(launches.values()) == 0, f"CIL launches {launches}")
    print(f"[11b] {ZOO_STEPS} CILTrainer steps (CilrsNet resnet18) on one "
          f"batch at B={PERCEPTION_BATCH}: {seconds:.3f} s, "
          f"{ZOO_STEPS * PERCEPTION_BATCH / seconds:.1f} train frames/s; "
          f"peak memory allocated {peak / 2**30:.2f} GiB; total loss "
          f"{float(losses[0]['total']):.4f} -> "
          f"{float(losses[-1]['total']):.4f}")


def zoo_cpu_agreement(batch):
    """11c: step_agreement (phase 8c's bounds) for a small DABetaVAE (its
    head's channel mask replayed) and a small CilrsNet."""
    import torch

    from cadre_tpu_torch.configs.danet_config import PerceptionTrainParams
    from cadre_tpu_torch.configs.experiments import experiment_params
    from cadre_tpu_torch.models.cil import CilrsNet
    from cadre_tpu_torch.models.danet import DropoutMasks
    from cadre_tpu_torch.models.registry import build_model, seeded
    from cadre_tpu_torch.perception.cil_trainer import CILTrainer, cil_loss
    from cadre_tpu_torch.perception.data import unpack_batch
    from cadre_tpu_torch.perception.trainer import PerceptionTrainer

    tp = PerceptionTrainParams(warmup_epochs=1)
    small = {k: v[:4].cpu() for k, v in batch.items()}
    cfg = experiment_params("auto_da_beta_vae", da_feature_channel=32,
                            inter_att_dims=24, z_dims=16)
    gen = torch.Generator()
    gen.manual_seed(3)
    masks = DropoutMasks(torch.rand(4, 128, generator=gen) < 0.9)

    def make_vae(device):
        return PerceptionTrainer(
            cfg, tp, steps_per_epoch=1, seed=4, device=device,
            model=build_model("da_beta_vae", cfg, seed=4))

    def vae64(trainer, m):
        tb = _double_batch(trainer, small)
        return trainer._losses(trainer._apply(tb, m), tb)[0]

    step_agreement("11c", "small DABetaVAE", make_vae, vae64, small, masks,
                   tp.weight_decay)

    def make_cil(device):
        return CILTrainer(seeded(4, lambda: CilrsNet(arch="resnet18")), tp,
                          steps_per_epoch=1, seed=4, device=device)

    def cil64(trainer, m):
        b = {k: v.double() if v.is_floating_point() else v
             for k, v in unpack_batch(small).items()}
        controls, speed = trainer.model(b["camera_rgb"], b["speed"],
                                        b["command"], masks=m)
        return cil_loss(controls, speed, b)[0]

    step_agreement("11c", "CilrsNet resnet18", make_cil, cil64, small, None,
                   tp.weight_decay)


def _run_cli(tag, module, args):
    """`python -m <module> <args>` in its own process from the repo root;
    prints its output, returns its wall seconds."""
    import os

    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", module, *args], cwd=root,
                         capture_output=True, text=True, timeout=600)
    seconds = time.perf_counter() - t0
    require(out.returncode == 0, f"{module} exited {out.returncode}: "
            f"{out.stderr[-3000:]}")
    for line in out.stdout.strip().splitlines():
        print(f"[{tag}]   {line}")
    return seconds


def zoo_clis(data_dir):
    """11d: the 'invaild' ablation through the perception CLI in process
    (its launches counted), `--collect 96 --model oldv2_vae` and
    `train_cil` in their own processes; every checkpoint read back."""
    import dataclasses
    import os
    import shutil

    import torch

    from cadre_tpu_torch import train_perception
    from cadre_tpu_torch.configs.danet_config import danet_params
    from cadre_tpu_torch.configs.experiments import experiment_params
    from cadre_tpu_torch.models.cil import CilrsNet
    from cadre_tpu_torch.models.danet import DANet
    from cadre_tpu_torch.models.registry import adapt_config, build_model
    from cadre_tpu_torch.utils.checkpoint import load_danet_checkpoint

    root = os.path.dirname(os.path.abspath(__file__))
    work = os.path.join(root, "build", "smoke_zoo_cli")
    shutil.rmtree(work, ignore_errors=True)
    args = ["--data-dir", data_dir, "--experiment", "auto_danet_exp50",
            "--epochs", "1", "--batch-size", str(PERCEPTION_BATCH),
            "--holdout", "--work-dir", os.path.join(work, "exp50")]
    t0 = time.perf_counter()
    path, launches = _counted(lambda: train_perception.main(args))
    seconds = time.perf_counter() - t0
    steps = evals = ZOO_SHARD // PERCEPTION_BATCH
    want = {"paint": 0, "dual_attention": steps + evals,
            "dual_attention_bwd": steps}
    require(launches == want, f"auto_danet_exp50 CLI launches {launches}, "
            f"not {want}")
    cfg = experiment_params("auto_danet_exp50")
    DANet(cfg).load_state_dict(load_danet_checkpoint(path, cfg))
    print(f"[11d] train_perception --experiment auto_danet_exp50 (the "
          f"'invaild' ablation) --epochs 1 --holdout: {seconds:.1f} s in "
          f"process; launches {launches}; {os.path.relpath(path, root)} "
          f"read back")

    own = os.path.join(work, "collect96")
    seconds = _run_cli("11d", "cadre_tpu_torch.train_perception", [
        "--data-dir", own, "--collect", str(ZOO_CLI_FRAMES), "--model",
        "oldv2_vae", "--epochs", "1", "--batch-size", str(PERCEPTION_BATCH),
        "--work-dir", os.path.join(work, "oldv2")])
    cfg = dataclasses.replace(adapt_config("oldv2_vae", danet_params()),
                              model_name="oldv2_vae")
    build_model("oldv2_vae", cfg).load_state_dict(load_danet_checkpoint(
        os.path.join(work, "oldv2", "net_epoch0.pt"), cfg))
    print(f"[11d] train_perception --collect {ZOO_CLI_FRAMES} --model "
          f"oldv2_vae --epochs 1: exit 0 in {seconds:.1f} s; its checkpoint "
          f"read back")

    seconds = _run_cli("11d", "cadre_tpu_torch.train_cil", [
        "--data-dir", data_dir, "--model", "cilrs", "--epochs", "1",
        "--batch-size", str(PERCEPTION_BATCH), "--work-dir",
        os.path.join(work, "cil")])
    blob = torch.load(os.path.join(work, "cil", "cil_epoch0.pt"),
                      weights_only=True)
    require(blob["config"] == {"model_name": "cilrs", "arch": "resnet18"},
            f"cil checkpoint config {blob['config']}")
    CilrsNet(arch="resnet18").load_state_dict(blob["state_dict"])
    print(f"[11d] train_cil --model cilrs --epochs 1: exit 0 in "
          f"{seconds:.1f} s; cil_epoch0.pt read back")


def phase_zoo():
    """The perception zoo at full width: collection, DABetaVAE training,
    the CIL trainer, the card against the CPU and the CLIs; returns the
    launch counts of the timed DABetaVAE steps."""
    t0 = time.perf_counter()
    data_dir = zoo_collect()
    launches, batch = zoo_da_beta_vae(data_dir)
    zoo_cil_timing(batch)
    zoo_cpu_agreement(batch)
    zoo_clis(data_dir)
    print(f"[11] phase 11 in {time.perf_counter() - t0:.1f} s")
    return launches


# --------------------------------------------------------------- phase 12

MSGPACK_MEMBERS = 4             # 12a's ensemble (phase 10a's K)
MESH_STEPS = 20                 # 12b's timed world-1 perception steps
MESH_RANK_STEPS = 3             # 12c's full-width two-rank steps
MESH_RANK_BATCH = PERCEPTION_BATCH // 2     # frames per rank in 12c
MESH_TIMEOUT = 600              # seconds for each torchrun or rank group
FUSED_ENVS, FUSED_T = 32, 20    # 12c's sharded fused update (16 per rank)


def _run_process(tag, cmd, timeout=MESH_TIMEOUT):
    """`cmd` from the repo root in a session of its own, killed with every
    process it started if it outlives `timeout`; its output lines printed
    under `tag`. Returns (stdout, wall seconds)."""
    import os
    import signal

    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=root, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            start_new_session=True)
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise PhaseError(f"{' '.join(cmd[:6])} ... did not end within "
                         f"{timeout} s")
    seconds = time.perf_counter() - t0
    require(proc.returncode == 0, f"{' '.join(cmd[:8])} ... exited "
            f"{proc.returncode}: {err[-3000:]}")
    for line in out.strip().splitlines():
        if line.startswith(f"[{tag}]"):          # the worker's own lines
            print(line)
        elif not line.startswith("MESH_STEP "):
            print(f"[{tag}]   {line}")
    return out, seconds


def _torchrun(tag, args):
    """`torchrun --standalone --nproc-per-node 1 <args>`: a world of one
    rank over NCCL."""
    return _run_process(tag, [sys.executable, "-m", "torch.distributed.run",
                              "--standalone", "--nproc-per-node", "1",
                              *args])


def msgpack_handoff(pretrained):
    """12a: phase 8b's trained DANet written as the JAX package's .msgpack
    (import_danet_torch, save_pytree), read back, an agent built from it:
    its folded f32 latent equals the trainer's net folded the same way bit
    for bit (and lies within FOLD_TOL of the unfolded one). The writer's
    and the reader's MB/s (host figures)."""
    import os

    import torch

    from cadre_tpu_torch.configs.danet_config import danet_params
    from cadre_tpu_torch.perception.data import unpack_batch
    from cadre_tpu_torch.rl.agent import CadreAgent
    from cadre_tpu_torch.utils.checkpoint import (
        import_danet_torch,
        load_danet_checkpoint,
        load_pytree,
        save_pytree,
    )

    trainer, batch, cfg = pretrained["trainer"], pretrained["batch"], \
        danet_params()
    path = os.path.join(_smoke_dir("smoke_msgpack"), "net_trained.msgpack")
    t0 = time.perf_counter()
    save_pytree(path, import_danet_torch(trainer.model.state_dict(), cfg))
    write_s = time.perf_counter() - t0
    mb = os.path.getsize(path) / 2 ** 20
    t0 = time.perf_counter()
    load_pytree(path)
    read_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    state = load_danet_checkpoint(path, cfg)
    load_s = time.perf_counter() - t0
    agent = CadreAgent.create(cfg, device="cuda", encoder_state=state)
    x = unpack_batch(batch)["x"]
    trainer.model.eval()
    with torch.no_grad():
        want = trainer.model.latent(x)
        folded = folded_like_the_agent(trainer.model).latent(x)
        got = agent.encoder.latent(x)
    trainer.model.train()
    torch.cuda.synchronize()
    require(torch.equal(got, folded), f"the .msgpack agent's latent differs "
            f"from the folded trainer's by "
            f"{float((got - folded).abs().max()):.3g}")
    gap = folded_latent_gap(got, want)
    require(gap <= FOLD_TOL, f"the .msgpack agent's latent differs from the "
            f"trainer's by {gap:.3g} (relative RMS; at most {FOLD_TOL})")
    print(f"[12a] phase 8b's DANet as a JAX .msgpack: {mb:.1f} MiB written "
          f"in {write_s:.3f} s ({mb / write_s:.1f} MB/s, host), read in "
          f"{read_s:.3f} s ({mb / read_s:.1f} MB/s), read and converted to "
          f"a state_dict in {load_s:.3f} s; the agent built from it gives "
          f"the folded trainer's f32 latent of {x.shape[0]} frames bit for "
          f"bit, {gap:.3g} (relative RMS) from the unfolded trainer's")


def _reference_policy(banks, commands):
    """A reference ppo_model_<N>.pt dict ('{signal}_{ppo,lstm}_{k}'
    state_dicts, ppo_agent/agent.py:245-260) of PolicyBank state_dicts."""
    out = {}
    for signal, sd in banks.items():
        for k in range(commands):
            ac = {}
            for i in range(3):
                ac[f"control.linear.{2 * i}.weight"] = \
                    sd[f"control.fc{i + 1}.weight"][k]
                ac[f"control.linear.{2 * i}.bias"] = \
                    sd[f"control.fc{i + 1}.bias"][k]
                ac[f"critic.{2 * i}.weight"] = sd[f"critic_fc{i + 1}.weight"][k]
                ac[f"critic.{2 * i}.bias"] = sd[f"critic_fc{i + 1}.bias"][k]
            out[f"{signal}_ppo_{k}"] = ac
            out[f"{signal}_lstm_{k}"] = {
                f"rnn.{n}": sd[f"lstm.{n}"][k]
                for n in ("weight_ih", "weight_hh", "bias_ih", "bias_hh")}
    return out


def msgpack_members():
    """12a: MSGPACK_MEMBERS member snapshots saved as .msgpack with their
    .opt by the production f32 agent; `python -m cadre_tpu_torch.eval
    --env sim` on them in process, one episode, its launches counted (one
    K2 per tick); a reference-format .pt of member 0 acting as member 0.
    Returns the eval's launches."""
    import glob
    import os
    import shutil

    import torch

    from cadre_tpu_torch import eval as eval_cli
    from cadre_tpu_torch.configs.danet_config import danet_params
    from cadre_tpu_torch.models.policy import PolicyBank
    from cadre_tpu_torch.rl.agent import CadreAgent, Ensemble, snapshot_banks
    from cadre_tpu_torch.rl.distributions import gumbel

    agent = CadreAgent.create(danet_params(), device="cuda")
    cfg, f = agent.agent_cfg, agent.obs_dim
    work = _smoke_dir("smoke_msgpack_members")
    for old in glob.glob(os.path.join(work, "*")):
        os.remove(old)
    paths = []
    for seed in range(MSGPACK_MEMBERS):
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            for name, a in (("steer", cfg.num_steer_outputs),
                            ("throttle", cfg.num_throttle_outputs)):
                agent.banks()[name].load_state_dict(
                    PolicyBank(cfg.command_num, a, f).state_dict())
        paths.append(os.path.join(work, f"member_{seed}.msgpack"))
        agent.save_snapshot(paths[-1], agent.opt)
        require(os.path.exists(paths[-1] + ".opt"), "no .opt beside "
                f"{paths[-1]}")
    routes, scenarios = host_eval_files(1, 1, "smoke_msgpack_eval")
    run = _smoke_dir("smoke_msgpack_eval_run")
    shutil.rmtree(run, ignore_errors=True)
    t0 = time.perf_counter()
    results, launches = _counted(lambda: eval_cli.main([
        "--env", "sim", "--snapshots", os.path.join(work, "*.msgpack"),
        "--routes", routes, "--scenarios", scenarios, "--episodes", "1",
        "--work-dir", run]))
    seconds = time.perf_counter() - t0
    ticks = sum(r.steps for r in results)
    want = {"paint": 0, "dual_attention": ticks, "dual_attention_bwd": 0}
    require(launches == want, f"msgpack eval launches {launches}, not "
            f"{want}")
    print(f"[12a] python -m cadre_tpu_torch.eval --env sim --snapshots "
          f"<{MSGPACK_MEMBERS} .msgpack members> --episodes 1 in process: "
          f"{ticks} ticks in {seconds:.1f} s, completion "
          f"{results[0].completion_ratio:.2f}%; launches {launches}")

    reference = os.path.join(work, "ppo_model_0.pt")
    torch.save(_reference_policy(snapshot_banks(paths[0], agent),
                                 cfg.command_num), reference)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    n = 8
    hist = torch.randn(8, n, f, device="cuda", generator=gen)
    commands = torch.randint(0, cfg.command_num, (n,), device="cuda",
                             generator=gen)
    zeros = torch.zeros(n, f, device="cuda")
    noise = (gumbel((1, n, cfg.num_steer_outputs), gen, "cuda"),
             gumbel((1, n, cfg.num_throttle_outputs), gen, "cuda"))
    acts = [Ensemble.load(agent, [p]).act(hist, commands, (zeros, zeros),
                                          *noise)
            for p in (paths[0], reference)]
    require(all(torch.equal(a, b) for a, b in zip(*acts)),
            "the reference-format .pt acts otherwise than its .msgpack")
    print(f"[12a] a reference-format ppo_model_0.pt of member 0 "
          f"('{{steer,throttle}}_{{ppo,lstm}}_{{k}}' state_dicts): its "
          f"actions on {n} envs equal the .msgpack member's on the same "
          f"noise")
    return launches


def config_cli():
    """12a: `main --config config_files/agent_config.py --env sim
    --num-envs 2 --iterations 1` as a process (the config's T=200)."""
    import os
    import shutil

    work = _smoke_dir("smoke_config_cli")
    shutil.rmtree(work, ignore_errors=True)
    _, seconds = _run_process("12a", [
        sys.executable, "-m", "cadre_tpu_torch.main", "--config",
        "config_files/agent_config.py", "--env", "sim", "--num-envs", "2",
        "--iterations", "1", "--work-dir", work])
    require(os.path.exists(os.path.join(work, "models", "ppo_model_0.pt")),
            "main --config wrote no snapshot")
    print(f"[12a] python -m cadre_tpu_torch.main --config "
          f"config_files/agent_config.py --env sim --num-envs 2 "
          f"--iterations 1: exit 0 in {seconds:.1f} s")


def mesh_step_worker(data_dir: str) -> int:
    """`chip_smoke.py --mesh-step <shards>` under torchrun: MESH_STEPS
    data-parallel perception steps of the production DANet at B=48 f32
    after a warm-up, launches counted, then as many with the cross-replica
    BatchNorm forced on (at world 1 the trainer keeps the plain one), a
    profile of 3 steps of each; prints one line `MESH_STEP {json}`."""
    import torch
    import torch.distributed as dist

    from cadre_tpu_torch.configs.danet_config import (
        PerceptionTrainParams,
        danet_params,
    )
    from cadre_tpu_torch.models.torch_compat import set_batch_norm_group
    from cadre_tpu_torch.parallel.mesh import close_mesh, make_mesh
    from cadre_tpu_torch.parallel.perception_step import (
        make_distributed_perception_trainer,
    )
    from cadre_tpu_torch.perception.data import (
        PerceptionDataLoader,
        compute_stats,
    )

    no_tf32()
    mesh = make_mesh(device="cuda")
    try:
        loader = PerceptionDataLoader(data_dir, batch_size=PERCEPTION_BATCH,
                                      seed=0, packed=True,
                                      cache_in_memory=True)
        stats = compute_stats(loader.paths)
        trainer = make_distributed_perception_trainer(
            danet_params(), PerceptionTrainParams(batch_size=PERCEPTION_BATCH),
            len(loader), mesh, seg_class_weight=stats.seg_class_weight,
            light_class_weight=stats.light_class_weight)
        batch = {k: torch.as_tensor(v).to(mesh.device)
                 for k, v in next(iter(loader)).items()}
        figures = dict(world=mesh.world, backend=dist.get_backend())
        for name in ("plain_bn", "cross_replica_bn"):
            if name == "cross_replica_bn":
                set_batch_norm_group(trainer.model, mesh.group)
            trainer.train_step(batch)                    # warm-up
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            losses, launches = _counted(lambda: [
                trainer.train_step(batch, sync=False)
                for _ in range(MESH_STEPS)])
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            totals = [float(l["total"]) for l in losses]
            figures[name] = dict(
                ms=seconds / MESH_STEPS * 1e3,
                fps=MESH_STEPS * PERCEPTION_BATCH / seconds,
                peak=torch.cuda.max_memory_allocated(), launches=launches,
                first=totals[0], last=totals[-1])
            profile(lambda: [trainer.train_step(batch, sync=False)
                             for _ in range(3)],
                    f"3 data-parallel steps, world 1, {name}", 3,
                    "train step", tag="12b")
        print("MESH_STEP " + json.dumps(figures), flush=True)
    finally:
        close_mesh()
    return 0


def mesh_world_of_one(pretrained):
    """12b: world size 1 over NCCL, each a torchrun process: the
    perception CLI with --mesh (one epoch on 8a's shards, the holdout
    report), the timed data-parallel perception step beside 8b's, and
    `main --mesh data` on --env jax (N=32, T=20) and --env sim (8 envs).
    Returns the timed step's launches."""
    import os
    import shutil

    data_dir = pretrained["data_dir"]
    work = _smoke_dir("smoke_mesh_perception")
    shutil.rmtree(work, ignore_errors=True)
    _, seconds = _torchrun("12b", [
        "-m", "cadre_tpu_torch.train_perception", "--mesh", "--data-dir",
        data_dir, "--epochs", "1", "--batch-size", str(PERCEPTION_BATCH),
        "--holdout", "--work-dir", work])
    require(os.path.exists(os.path.join(work, "net_epoch0.pt")),
            "train_perception --mesh wrote no net_epoch0.pt")
    print(f"[12b] torchrun --nproc-per-node 1 -m "
          f"cadre_tpu_torch.train_perception --mesh --epochs 1 --batch-size "
          f"{PERCEPTION_BATCH} --holdout: exit 0 in {seconds:.1f} s")

    out, _ = _torchrun("12b", [os.path.abspath(__file__), "--mesh-step",
                               data_dir])
    line = [ln for ln in out.splitlines() if ln.startswith("MESH_STEP ")]
    require(len(line) == 1, f"no MESH_STEP line in {out[-2000:]}")
    figures = json.loads(line[0][len("MESH_STEP "):])
    require(figures["world"] == 1 and figures["backend"] == "nccl",
            f"12b mesh {figures}")
    want = {"paint": 0, "dual_attention": MESH_STEPS,
            "dual_attention_bwd": MESH_STEPS}
    for name, what in (("plain_bn", "the trainer's own (world 1: plain "
                                    "BatchNorm)"),
                       ("cross_replica_bn", "cross-replica BatchNorm "
                                            "forced on")):
        m = figures[name]
        require(m["launches"] == want, f"12b {name} launches "
                f"{m['launches']}, not {want}")
        require(math.isfinite(m["first"]) and math.isfinite(m["last"]),
                f"12b {name} losses {m['first']}, {m['last']}")
        ratio = m["ms"] / pretrained["step_ms"]
        print(f"[12b] data-parallel perception step, world 1 over NCCL, "
              f"{what}, B={PERCEPTION_BATCH} f32, {MESH_STEPS} steps after "
              f"a warm-up: {m['ms']:.2f} ms per step ({m['fps']:.1f} train "
              f"frames/s), peak {m['peak'] / 2 ** 30:.2f} GiB; phase 8b's "
              f"plain step in this run: {pretrained['step_ms']:.2f} ms, peak "
              f"{pretrained['peak'] / 2 ** 30:.2f} GiB ({ratio:.3f}x); total "
              f"{m['first']:.1f} -> {m['last']:.1f}; launches "
              f"{m['launches']}")

    for env_args, what in ((["--env", "jax", "--num-envs", str(N_ENVS),
                             "--num-steps", str(T_STEPS)], "jax"),
                           (["--env", "sim", "--num-envs", str(N_HOST),
                             "--num-steps", str(T_STEPS)], "sim")):
        run = _smoke_dir(f"smoke_mesh_main_{what}")
        shutil.rmtree(run, ignore_errors=True)
        _, seconds = _torchrun("12b", ["-m", "cadre_tpu_torch.main", "--mesh",
                                       "data", *env_args, "--iterations", "1",
                                       "--work-dir", run])
        snaps = [os.path.join(run, "models", f"ppo_model_{i}.pt")
                 for i in (0, 1)]
        require(any(os.path.exists(p) for p in snaps),
                f"main --mesh data --env {what} wrote no snapshot")
        print(f"[12b] torchrun --nproc-per-node 1 -m cadre_tpu_torch.main "
              f"--mesh data {' '.join(env_args)} --iterations 1: exit 0 in "
              f"{seconds:.1f} s")
    return figures["plain_bn"]["launches"]


def _state_digest(model) -> str:
    """A digest of every parameter and buffer's bytes."""
    import hashlib

    h = hashlib.sha256()
    for v in model.state_dict().values():
        h.update(v.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def _rank_full_width(mesh, data_dir):
    """MESH_RANK_STEPS steps of the production DANet, f32, on this rank's
    MESH_RANK_BATCH of one global batch, at the schedule's peak rate: each
    step's total loss, launches, ms and state digest."""
    import torch

    from cadre_tpu_torch.configs.danet_config import (
        PerceptionTrainParams,
        danet_params,
    )
    from cadre_tpu_torch.parallel.perception_step import (
        make_distributed_perception_trainer,
    )
    from cadre_tpu_torch.perception.data import (
        PerceptionDataLoader,
        compute_stats,
    )

    loader = PerceptionDataLoader(data_dir, batch_size=PERCEPTION_BATCH,
                                  seed=0, packed=True)
    stats = compute_stats(loader.paths)
    trainer = make_distributed_perception_trainer(
        danet_params(), PerceptionTrainParams(batch_size=PERCEPTION_BATCH,
                                              warmup_epochs=1),
        1, mesh, seg_class_weight=stats.seg_class_weight,
        light_class_weight=stats.light_class_weight)
    trainer.step = 1                  # lr(1) = tp.lr: the peak
    batch = next(iter(loader))
    steps = []
    for _ in range(MESH_RANK_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses, launches = _counted(lambda: trainer.train_step(batch))
        torch.cuda.synchronize()
        steps.append(dict(total=losses["total"], launches=launches,
                          ms=(time.perf_counter() - t0) * 1e3,
                          digest=_state_digest(trainer.model)))
    return dict(steps=steps, peak=torch.cuda.max_memory_allocated())


def _rank_small_step(mesh, small):
    """One two-rank step of phase 8c's small head on this rank's half of
    `small` (4 frames), on the card, on the CPU and on the CPU in float64:
    step_agreement's runs, numpy."""
    import dataclasses

    import torch

    from cadre_tpu_torch.configs.danet_config import PerceptionTrainParams
    from cadre_tpu_torch.perception.trainer import PerceptionTrainer

    cfg, masks = _small_head_masks()
    runs = {}
    for dev in ("cpu", "cuda", "cpu64"):
        device = "cuda" if dev == "cuda" else "cpu"
        trainer = PerceptionTrainer(
            cfg, PerceptionTrainParams(warmup_epochs=1), 1, seed=4,
            mesh=dataclasses.replace(mesh, device=torch.device(device)))
        trainer.step = 1
        batch = {k: v.to(device) for k, v in small.items()}
        init = {n: p.detach().cpu().double().numpy()
                for n, p in trainer.model.named_parameters()}
        if dev == "cpu64":
            trainer.model.double()
            batch = {k: v.double() if v.is_floating_point() else v
                     for k, v in trainer._to_device(batch).items()}
        loss = trainer.train_step(batch, masks=_masks_to(masks, device))
        named = dict(trainer.model.named_parameters())
        runs[dev] = (loss["total"], init,
                     {n: p.grad.detach().cpu().double().numpy()
                      for n, p in named.items()},
                     {n: p.detach().cpu().double().numpy()
                      for n, p in named.items()})
    return runs


def _small_head_masks():
    """The dropout masks of _rank_small_step: 2 frames' from seed 3."""
    import torch

    from cadre_tpu_torch.configs.danet_config import danet_params
    from cadre_tpu_torch.models.danet import draw_dropout_masks

    gen = torch.Generator()
    gen.manual_seed(3)
    cfg = danet_params(da_feature_channel=32, inter_att_dims=24, z_dims=16)
    return cfg, draw_dropout_masks(cfg, 2, gen)


def _one_process_small_step(small, device):
    """The two-rank small step's function in one process on `device`: all
    4 frames, plain BatchNorm over them, each half with the ranks' masks.
    Its f32 distance from float64 is one measure of f32 rounding in this
    function (check_step_agreement's 'f32_noise'): the card's own, or
    phase 8c's CPU step's."""
    import torch

    from cadre_tpu_torch.configs.danet_config import PerceptionTrainParams
    from cadre_tpu_torch.perception.trainer import PerceptionTrainer

    cfg, masks = _small_head_masks()
    masks = type(masks)(*(None if t is None else torch.cat([t, t])
                          for t in masks))
    trainer = PerceptionTrainer(cfg, PerceptionTrainParams(warmup_epochs=1),
                                1, seed=4, device=device)
    trainer.step = 1
    init = {n: p.detach().cpu().double()
            for n, p in trainer.model.named_parameters()}
    loss = trainer.train_step({k: v.to(device) for k, v in small.items()},
                              masks=_masks_to(masks, device))["total"]
    named = dict(trainer.model.named_parameters())
    return (loss, init,
            {n: p.grad.detach().cpu().double() for n, p in named.items()},
            {n: p.detach().cpu().double() for n, p in named.items()})


def _rank_fused(mesh):
    """The sharded fused update at full width (F=530, this rank's 16 of
    FUSED_ENVS envs, one minibatch, E=1) and, on rank 0, the world-1
    update of all FUSED_ENVS envs from the same banks and buffers: the
    largest difference of each parameter, relative to its scale."""
    import torch

    from cadre_tpu_torch.configs.agent_config import RolloutConfig
    from cadre_tpu_torch.models.policy import PolicyBank
    from cadre_tpu_torch.rl import fused_update, ppo
    from cadre_tpu_torch.rl.rollout import RolloutBuffer

    f, seq, t, n = 530, 8, FUSED_T, FUSED_ENVS
    gen = torch.Generator().manual_seed(11)

    def buffer(outputs):
        def z(x):                     # slot T is zero padding
            return torch.cat([x, torch.zeros_like(x[:1])])

        return RolloutBuffer(
            obs=z(torch.randn(t, n, seq, f, generator=gen)),
            action=z(torch.randint(0, outputs, (t, n), generator=gen)),
            log_prob=z(-torch.rand(t, n, generator=gen) - 0.5),
            value=z(0.1 * torch.randn(t, n, generator=gen)),
            reward=z(torch.randn(t, n, generator=gen)),
            mask=z((torch.rand(t, n, generator=gen) > 0.05).float()),
            command=z(torch.randint(0, 4, (t, n), generator=gen)),
            hn=z(0.5 * torch.randn(t, n, f, generator=gen)),
            cn=z(0.5 * torch.randn(t, n, f, generator=gen)))

    bufs = (buffer(33), buffer(3))
    nv = (torch.randn(n, generator=gen), torch.randn(n, generator=gen))

    def run(rows, m):
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(0)
            banks = (PolicyBank(4, 33, f).cuda(), PolicyBank(4, 3, f).cuda())
        cfg = ppo.PPOConfig(ppo_epoch=1)
        update = fused_update.make_fused_iteration_update(
            *banks, cfg, RolloutConfig(num_steps=t, mini_batch_num=1,
                                       seq_length=seq, feature_dims=f),
            mesh=m)
        opt = ppo.make_optimizer([*banks[0].parameters(),
                                  *banks[1].parameters()], cfg)
        aux = update(opt, *(b._replace(**{
            k: v[:, rows].cuda() for k, v in b._asdict().items()
            if torch.is_tensor(v)}) for b in bufs),
            tuple(v[rows].cuda() for v in nv))
        return [float(x) for x in aux], {
            (i, k): v.detach().cpu().double()
            for i, bank in enumerate(banks)
            for k, v in bank.state_dict().items()}

    half = n // mesh.world
    aux, state = run(slice(mesh.rank * half, (mesh.rank + 1) * half), mesh)
    if mesh.rank:
        return None
    want_aux, want = run(slice(None), None)
    worst = 0.0
    for k, v in want.items():
        err = (state[k] - v).abs() - 2e-4 * v.abs()
        worst = max(worst, float(err.max()) / 2e-5)
    return dict(aux=aux, want_aux=want_aux, worst=worst)


def _rank_update_card_vs_cpu(mesh):
    """make_distributed_update (gradients summed over the ranks) on the
    card and on the CPU from the same banks and 32-row minibatches (16 per
    rank, F=530): the largest parameter difference in units of rtol 2e-4
    + atol 1e-5."""
    import dataclasses

    import torch

    from cadre_tpu_torch.models.policy import PolicyBank
    from cadre_tpu_torch.parallel.train_step import (
        make_distributed_update,
        shard_minibatch,
    )
    from cadre_tpu_torch.rl import ppo
    from cadre_tpu_torch.rl.rollout import Minibatch

    f, seq, rows = 530, 8, 32
    gen = torch.Generator().manual_seed(12)

    def minibatch(outputs):
        return Minibatch(
            obs_seq=torch.randn(seq, rows, f, generator=gen),
            action=torch.randint(0, outputs, (rows,), generator=gen),
            old_value=0.1 * torch.randn(rows, generator=gen),
            returns=torch.randn(rows, generator=gen),
            mask=torch.ones(rows),
            old_log_prob=-torch.rand(rows, generator=gen) - 0.5,
            advantage=torch.randn(rows, generator=gen),
            hidden=(torch.zeros(rows, f), torch.zeros(rows, f)),
            command=torch.randint(0, 4, (rows,), generator=gen))

    mbs = (minibatch(33), minibatch(3))
    out = {}
    for device in ("cuda", "cpu"):
        m = dataclasses.replace(mesh, device=torch.device(device))
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(0)
            banks = (PolicyBank(4, 33, f).to(device),
                     PolicyBank(4, 3, f).to(device))
        cfg = ppo.PPOConfig()
        opt = ppo.make_optimizer([*banks[0].parameters(),
                                  *banks[1].parameters()], cfg)
        make_distributed_update(*banks, cfg, m)(
            opt, *(shard_minibatch(m, mb) for mb in mbs))
        out[device] = {(i, k): v.detach().cpu().double()
                       for i, bank in enumerate(banks)
                       for k, v in bank.state_dict().items()}
    return max(float(((out["cuda"][k] - v).abs() - 2e-4 * v.abs()).max())
               / 1e-5 for k, v in out["cpu"].items())


def _mesh_card_rank(mesh, data_dir, small):
    """12c on one of two gloo ranks sharing the card."""
    no_tf32()
    # first: once the full-width steps have run, cuDNN's f32 algorithms
    # for the small head round some of its gradients differently
    small = _rank_small_step(mesh, small)
    return dict(small=small, full=_rank_full_width(mesh, data_dir),
                fused=_rank_fused(mesh),
                update=_rank_update_card_vs_cpu(mesh))


def mesh_two_ranks_on_the_card(pretrained):
    """12c: two gloo ranks sharing the card. The full-width step at
    MESH_RANK_BATCH frames per rank for MESH_RANK_STEPS steps (parameters
    and BN statistics bit-equal across the ranks after each, a falling
    loss, one K2 and one K3 per step per rank); phase 8c's small head on
    two ranks, card against CPU, within 8c's bounds; the sharded fused
    update at full width against the world-1 update of all its envs; the
    distributed update on the card against the CPU. Returns each rank's
    launches over its full-width steps."""
    import torch

    from cadre_tpu_torch.configs.danet_config import PerceptionTrainParams
    from cadre_tpu_torch.parallel.dryrun import run_ranks

    small = {k: v[:4].cpu() for k, v in pretrained["batch"].items()}
    t0 = time.perf_counter()
    out = run_ranks(_mesh_card_rank, 2, (pretrained["data_dir"], small),
                    timeout_s=MESH_TIMEOUT, device="cuda")
    seconds = time.perf_counter() - t0
    per_rank = []
    for r, res in enumerate(out):
        steps = res["full"]["steps"]
        totals = [s["total"] for s in steps]
        require(all(math.isfinite(v) for v in totals), f"12c losses {totals}")
        require(totals[-1] < totals[0], f"12c rank {r}: total did not fall "
                f"over {MESH_RANK_STEPS} steps: {totals}")
        want = {"paint": 0, "dual_attention": 1, "dual_attention_bwd": 1}
        for i, s in enumerate(steps):
            require(s["launches"] == want, f"12c rank {r} step {i} launches "
                    f"{s['launches']}, not {want}")
            require(s["digest"] == out[0]["full"]["steps"][i]["digest"],
                    f"12c: rank {r}'s parameters differ from rank 0's after "
                    f"step {i}")
        per_rank.append({k: sum(s["launches"][k] for s in steps)
                         for k in want})
    full = out[0]["full"]
    ms = ", ".join("%.0f" % s["ms"] for s in full["steps"])
    totals = " -> ".join("%.1f" % s["total"] for s in full["steps"])
    print(f"[12c] two gloo ranks on one card, full-width DANet f32, "
          f"{MESH_RANK_BATCH} frames per rank: {MESH_RANK_STEPS} steps of "
          f"{ms} ms (rank 0; gloo moves the gradients through the host), "
          f"total {totals}; "
          f"parameters and BN statistics bit-equal across the ranks after "
          f"every step; peak {full['peak'] / 2 ** 30:.2f} GiB per rank; "
          f"launches per rank {per_rank}")
    runs = {dev: (loss, *(
        {n: torch.from_numpy(a) for n, a in tree.items()} for tree in rest))
        for dev, (loss, *rest) in out[0]["small"].items()}
    runs["f32_noise"] = [_one_process_small_step(small, device)
                         for device in ("cuda", "cpu")]
    for one in runs["f32_noise"]:
        rel = abs(one[0] - runs["cuda"][0]) / runs["cuda"][0]
        require(rel <= 1e-4, f"12c: a one-process step's loss differs from "
                f"the two ranks' by {rel:.3g}")
    check_step_agreement("12c", "small head on two ranks", runs,
                         PerceptionTrainParams().weight_decay, 4)
    fused = out[0]["fused"]
    require(fused["worst"] <= 1.0, f"12c sharded fused update vs world 1: "
            f"{fused['worst']:.3g} of rtol 2e-4 + atol 2e-5")
    print(f"[12c] sharded fused update, F=530, {FUSED_ENVS} envs split "
          f"{FUSED_ENVS // 2}/{FUSED_ENVS // 2}, T={FUSED_T}, one minibatch, "
          f"E=1: every parameter within {max(fused['worst'], 0):.3g} of "
          f"rtol 2e-4 + atol 2e-5 of the world-1 update of all "
          f"{FUSED_ENVS} envs (losses {fused['aux']} vs {fused['want_aux']})")
    worst = max(res["update"] for res in out)
    require(worst <= 1.0, f"12c distributed update card vs cpu: {worst:.3g} "
            f"of rtol 2e-4 + atol 1e-5")
    print(f"[12c] make_distributed_update (summed gradients), 32 rows at "
          f"F=530 over two ranks: card within {max(worst, 0):.3g} of rtol "
          f"2e-4 + atol 1e-5 of the CPU; phase 12c in {seconds:.1f} s")
    return per_rank


def phase_utilities_and_mesh(pretrained):
    """Phase 12; returns (the msgpack eval's launches, {'12b': the timed
    world-1 steps' launches, '12c': each rank's})."""
    t0 = time.perf_counter()
    msgpack_handoff(pretrained)
    eval_launches = msgpack_members()
    config_cli()
    world_one = mesh_world_of_one(pretrained)
    two = mesh_two_ranks_on_the_card(pretrained)
    print(f"[12] phase 12 in {time.perf_counter() - t0:.1f} s")
    return eval_launches, {"12b": world_one, "12c": two}


# ------------------------------------------- folded convolution times

CONV_TIMES_B = 2048              # the benchmark's N: one encode's frames


def _conv_shapes(net, frames):
    """Each FoldedConv of `net`'s latent on `frames` by its shape
    (Cin, H, W, Cout, k, stride, padding, residual, bare), with its count
    in one latent, from a run at the frames' batch."""
    import torch

    from cadre_tpu_torch.models.resnet import FoldedConv

    shapes = {}

    def hook(conv, args, out):
        _, cin, h, w = args[0].shape
        cout, _, k, _ = conv.weight.shape
        key = (cin, h, w, cout, k, conv.stride[0], conv.padding[0],
               len(args) > 1, conv.bias is None)
        shapes[key] = shapes.get(key, 0) + 1

    handles = [m.register_forward_hook(hook) for m in net.modules()
               if isinstance(m, FoldedConv)]
    with torch.no_grad():
        net.latent(frames)
    for h in handles:
        h.remove()
    return shapes


def _conv_row(key, b, gen):
    """(bare, unfolded, fused) ms of one folded convolution shape at batch
    b: the bare convolution; as the unfolded net runs it, the convolution,
    eval BatchNorm, the residual add and ReLU each a pass of its own (a
    downsample: convolution and BatchNorm); and the folded form (fused, or
    for a downsample the bare convolution)."""
    import torch
    import torch.nn.functional as F

    from cadre_tpu_torch.ops.conv_epilogue import conv_bias_relu

    cin, h, w, cout, k, stride, pad, residual, bare = key
    cl = torch.channels_last

    def rand(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")

    x = rand(b, cin, h, w).to(memory_format=cl)
    wt = (rand(cout, cin, k, k) / math.sqrt(cin * k * k)).to(
        memory_format=cl)
    bias, mean, gamma, beta = (rand(cout) for _ in range(4))
    var = 0.5 + torch.rand(cout, generator=gen, device="cuda")
    ho, wo = (h + 2 * pad - k) // stride + 1, (w + 2 * pad - k) // stride + 1
    z = rand(b, cout, ho, wo).to(memory_format=cl) if residual else None

    def conv():
        return F.conv2d(x, wt, None, stride, pad)

    def unfolded():
        y = F.batch_norm(conv(), mean, var, gamma, beta, False, 0.0, 1e-5)
        if bare:
            return y
        return torch.relu(y if z is None else y + z)

    def fused():
        return conv() if bare else conv_bias_relu(
            x, wt, bias, (stride, stride), (pad, pad), z)

    with torch.no_grad():
        return tuple(time_ms(fn, 5, warmup=2)
                     for fn in (conv, unfolded, fused))


def conv_times() -> int:
    """`--conv-times` (module docstring): each folded convolution shape of
    the resnet18 and resnet50 latents at the benchmark's N, timed bare,
    unfolded and fused, the sums over one latent, and the whole latent
    unfolded and folded; TF32 convolutions as torch defaults them."""
    import copy

    import torch

    from cadre_tpu_torch.configs.danet_config import danet_params
    from cadre_tpu_torch.models.danet import DANet, fold_batch_norms

    print(card_line())
    print(f"torch {torch.__version__}, cuDNN {torch.backends.cudnn.version()}"
          f", cudnn.allow_tf32 {torch.backends.cudnn.allow_tf32}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    b = CONV_TIMES_B
    for arch in ("resnet18", "resnet50"):
        cfg = danet_params(backbone=arch)
        net = _randomised_batch_norms(DANet(cfg, latent_only=True),
                                      torch.Generator().manual_seed(1))
        net = net.eval().to("cuda", memory_format=torch.channels_last)
        folded = fold_batch_norms(copy.deepcopy(net))
        frames = torch.rand(b, cfg.image_height, cfg.image_width, 4,
                            generator=gen, device="cuda")
        shapes = _conv_shapes(folded, frames[:2])
        print(f"[conv] {arch} B={b}, ms: Cin x H x W -> Cout, k s p; "
              f"residual; bare | calls | bare | unfolded | fused")
        sums = [0.0, 0.0, 0.0]
        for key, calls in shapes.items():
            cin, h, w, cout, k, stride, pad, residual, bare = key
            row = _conv_row(key, b, gen)
            sums = [t + calls * r for t, r in zip(sums, row)]
            print(f"[conv]   {cin}x{h}x{w} -> {cout}, {k}x{k} s{stride} "
                  f"p{pad}{'; z' if residual else ''}"
                  f"{'; bare' if bare else ''} | {calls} | "
                  + " | ".join(f"{t:.3f}" for t in row))
        fused_n = sum(c for key, c in shapes.items() if not key[-1])
        bare_n = sum(shapes.values()) - fused_n
        print(f"[conv]   summed over one latent ({fused_n} fused + {bare_n} "
              f"bare) | | " + " | ".join(f"{t:.1f}" for t in sums))
        with torch.no_grad():
            lat = [time_ms(lambda m=m: m.latent(frames), 3, warmup=2)
                   for m in (net, folded, net, folded)]
        print(f"[conv] {arch} latent B={b}: unfolded {lat[0]:.1f} / "
              f"{lat[2]:.1f} ms, folded {lat[1]:.1f} / {lat[3]:.1f} ms")
        del net, folded, frames
        torch.cuda.empty_cache()
    return 0


# ------------------------------------------- kernel times of checkouts

def _timing_inputs(device):
    """The inputs both kernels are timed on, by case: paint on the main
    path's fig and rgb tables of one env step at N_ENVS and on random
    tables of the same row counts; dual attention at every shape and type
    of ATTENTION_SHAPES and its backward at every shape of
    BACKWARD_SHAPES. Made from fixed seeds."""
    import torch

    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    cases = {}
    step = _main_path_paint_tables(device, steps=1)[0]
    random_rows = {"fig": (0, 103, 56.25), "rgb": (108, 32, None)}
    for name, (base, table) in step.items():
        cases[f"paint main {name}"] = ("paint", (base, table))
        n, h, w, _ = base.shape
        cases[f"paint random {name}"] = ("paint", (base, _paint_tables(
            n, h, w, *random_rows[name], gen, device)))
    for b, c, d, h, w in ATTENTION_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            cases[f"dual_attention {_tag(b, c, d, h, w, dtype)}"] = (
                "dual_attention",
                _attention_inputs(b, c, d, dtype, gen, device, h, w))
    for b, c, d, h, w in BACKWARD_SHAPES:
        cases[f"dual_attention_bwd {_tag(b, c, d, h, w, torch.float32)}"] = (
            "dual_attention_bwd",
            _backward_inputs(b, c, d, gen, device, h, w)[0])
    return cases


def time_kernels_of(root: str, inputs: str) -> int:
    """Child of `compare_kernel_times`: import the port of the checkout at
    `root`, time its wrappers on the saved inputs both ways, print one
    JSON line."""
    import os

    sys.path.insert(0, os.path.abspath(root))
    import torch

    import cadre_tpu_torch
    from cadre_tpu_torch.ops import dual_attention, paint

    where = os.path.dirname(os.path.abspath(cadre_tpu_torch.__file__))
    require(where.startswith(os.path.abspath(root)),
            f"imported the port from {where}, not from {root}")
    fns = {"paint": paint.paint_shapes,
           "dual_attention": dual_attention.fused_dual_attention,
           "dual_attention_bwd": getattr(dual_attention,
                                         "dual_attention_backward", None)}
    times = {}
    for case, (kernel, args) in torch.load(inputs).items():
        if fns[kernel] is None:           # a checkout without this kernel
            times[case] = None
            continue
        args = [a.cuda() for a in args]

        def call(fn=fns[kernel], args=args):
            return fn(*args)

        try:
            call()
        except ValueError:                # a shape this checkout refuses
            times[case] = None
            continue
        times[case] = {"graph_ms": device_ms(call),
                       "one_by_one_ms": time_ms(call, 200)}
    print(json.dumps({"root": root, "times": times}))
    return 0


def compare_kernel_times(roots) -> int:
    """Time the kernels of several checkouts of the port (each a directory
    holding `cadre_tpu_torch/`) on the same inputs, in the order given,
    one process each: per call from a CUDA graph of 200 calls (the
    device's time) and from 200 calls issued one by one (the device's
    time or the host's, whichever is longer)."""
    import os

    import torch

    device = torch.device("cuda")
    inputs = os.path.abspath(os.path.join("build", "timing_inputs.pt"))
    os.makedirs(os.path.dirname(inputs), exist_ok=True)
    cases = _timing_inputs(device)
    torch.save({k: (kernel, [a.cpu() for a in args])
                for k, (kernel, args) in cases.items()}, inputs)
    runs = []
    for root in roots:
        out = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--time-kernels-of", root, inputs],
                             capture_output=True, text=True, timeout=900)
        if out.returncode != 0:
            print(out.stdout + out.stderr, file=sys.stderr)
            raise PhaseError(f"timing the kernels of {root} failed")
        runs.append(json.loads(out.stdout.strip().splitlines()[-1]))
    print(f"[t] card: {card_line()}")
    print("[t] ms per call, graph of 200 / issued one by one, in run order: "
          + ", ".join(r["root"] for r in runs))
    for case in cases:
        figs = "  ".join("n/a" if r["times"][case] is None else
                         f"{r['times'][case]['graph_ms']:.4f} / "
                         f"{r['times'][case]['one_by_one_ms']:.4f}"
                         for r in runs)
        print(f"[t] {case:50s} {figs}")
    def per_step(run, kind, how):
        return sum(run["times"][f"paint {kind} {n}"][how]
                   for n in ("fig", "rgb"))

    for kind in ("main", "random"):
        figs = "  ".join(f"{per_step(r, kind, 'graph_ms'):.4f} / "
                         f"{per_step(r, kind, 'one_by_one_ms'):.4f}"
                         for r in runs)
        print(f"[t] {'paint ' + kind + ' per env step':50s} {figs}")
    print(json.dumps({"runs": runs}))
    return 0


# the phases `--phase-times` runs from each checkout, and the lines it keeps
PHASE_TIMES = ("phase_card", "phase_build", "phase_slice", "phase_perception",
               "phase_host_env", "phase_deep")
PHASE_LINES = ("[4] iteration", "[8b] 20 steps", "[9] train_vec",
               "[9] train (", "[15a] 20 resnet50")


def compare_phase_times(roots) -> int:
    """Phase 4's device iteration, phase 8b's pretraining steps, phase 9's
    host-env iteration and `train` episode and phase 15a's resnet50
    pretraining steps of several checkouts, each
    run by the checkout's own chip_smoke.py in a process of its own, in the
    order given (A B B A shows the spread between runs); prints each run's
    figure lines."""
    import os

    code = "import chip_smoke as cs\n" + "".join(
        f"cs.{name}()\n" for name in PHASE_TIMES)
    print(f"[p] card: {card_line()}")
    for root in roots:
        root = os.path.abspath(root)
        out = subprocess.run([sys.executable, "-c", code], cwd=root,
                             capture_output=True, text=True, timeout=900)
        if out.returncode != 0:
            print(out.stdout[-3000:] + out.stderr[-3000:], file=sys.stderr)
            raise PhaseError(f"phases 4, 8, 9 and 15 of {root} failed")
        for line in out.stdout.splitlines():
            if line.startswith(PHASE_LINES):
                print(f"[p] {os.path.relpath(root)}: {line}")
    return 0


# --------------------------------------------------------------- phase 13

# the policy-bank options of the main path's full-width iteration
OPTIONS = dict(memory="transformer", ordinal=True)
# the use_lstm=False iteration's and the transformer ensemble eval's steps
OPTION_STEPS = 20
# ticks of the harness's storyboard run
HARNESS_TICKS = 300


def _options_agent(**options):
    """A bf16 CoPM agent at production width with the banks `options`."""
    from cadre_tpu_torch.configs.agent_config import AgentConfig
    from cadre_tpu_torch.configs.danet_config import danet_params
    from cadre_tpu_torch.rl.agent import CadreAgent

    return CadreAgent.create(danet_params(), AgentConfig(**options),
                             bf16_encoder=True, device="cuda")


def options_iteration():
    """13a: the main path with memory 'transformer' and the ordinal head:
    one train_device iteration at T=2 to warm up, then one whole counted
    iteration at production size (N_ENVS envs, T_TRAIN steps, 4 PPO epochs
    of 2 minibatches); returns its launch counts."""
    import torch

    from cadre_tpu_torch.configs.agent_config import (
        RolloutConfig,
        TrainConfig,
    )
    from cadre_tpu_torch.envs.torch_env import DrivingEnv, make_route_bank
    from cadre_tpu_torch.rl.device_rollout import (
        make_device_iteration,
        train_device,
    )
    from cadre_tpu_torch.rl.fused_update import minibatch_layout

    t0 = time.perf_counter()
    agent = _options_agent(**OPTIONS)
    env = DrivingEnv(make_route_bank(16, seed=0, device="cuda"),
                     num_envs=N_ENVS, device="cuda")
    train_cfg, rollout_cfg = TrainConfig(), RolloutConfig(num_steps=T_TRAIN)
    rows = train_device(agent, env, 1, RolloutConfig(num_steps=2),
                        train_cfg, seed=3, log_fn=None)
    mem = agent.steer.lstm
    n_mem = sum(p.numel() for p in mem.parameters())
    print(f"[13a] set-up and a T=2 train_device warm-up "
          f"{time.perf_counter() - t0:.2f} s; memory "
          f"{agent.steer.memory} ({n_mem} parameters per signal, "
          f"{mem.layers} blocks, heads of {mem.attn_0.query.weight.shape[2]})"
          f", ordinal {agent.steer.ordinal}; warm-up losses "
          f"{rows[0]['value_loss']:.5f}/{rows[0]['policy_loss']:.5f}")

    iteration, init_carry = make_device_iteration(agent, env, rollout_cfg,
                                                  train_cfg, seed=4)
    carry = init_carry()
    named = [(f"{sig}.{k}", p) for sig, bank in agent.banks().items()
             for k, p in bank.named_parameters()]
    before = [p.detach().clone() for _, p in named]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    (carry, m), launches = _counted(lambda: iteration(agent.opt, carry))
    float(m.checksum)
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    want = {"paint": 2 * T_TRAIN, "dual_attention": T_TRAIN + 1,
            "dual_attention_bwd": 0}
    require(launches == want, f"13a iteration launches {launches}, not "
            f"{want}")
    for name, t in m._asdict().items():
        if isinstance(t, torch.Tensor):
            _finite(f"13a {name}", t)
    still = []
    for (name, p), b in zip(named, before):
        _finite(f"13a {name}", p.detach())
        if torch.equal(p.detach(), b):
            still.append(name)
    # the key biases' gradient is zero (see _zero_gradient): they may rest
    require(all(n.endswith(".key.bias") for n in still),
            f"13a: parameters that did not move: {still}")
    steps = T_TRAIN * N_ENVS
    eff_mb, mb_rows = minibatch_layout(steps, rollout_cfg.mini_batch_num)
    update_s = seconds - m.rollout_seconds
    print(f"[13a] transformer + ordinal iteration N={N_ENVS} T={T_TRAIN} "
          f"E={train_cfg.ppo_epoch} M={eff_mb} ({mb_rows} rows per "
          f"minibatch): {seconds:.3f} s, {steps / seconds:.1f} env-steps/s;"
          f" rollout (act) {m.rollout_seconds:.3f} s "
          f"({steps / m.rollout_seconds:.1f} env-steps/s), update "
          f"{update_s:.3f} s ({100 * update_s / seconds:.1f}%); peak memory "
          f"allocated {peak / 2**30:.2f} GiB; losses value "
          f"{float(m.value_loss):.5f} policy {float(m.policy_loss):.5f} "
          f"entropy {float(m.entropy_loss):.5f}; {len(named)} tensors, "
          f"resting: {still}; launches {launches}")
    return agent, launches


def no_memory_iteration():
    """13b: one train_device iteration of N_ENVS envs x OPTION_STEPS steps
    with use_lstm=False (memory 'none': the newest frame's features), its
    env reset included, launches counted."""
    import torch

    from cadre_tpu_torch.configs.agent_config import RolloutConfig
    from cadre_tpu_torch.envs.torch_env import DrivingEnv, make_route_bank
    from cadre_tpu_torch.rl.device_rollout import train_device

    agent = _options_agent(use_lstm=False)
    require(agent.steer.memory == "none"
            and not hasattr(agent.steer, "lstm"),
            "use_lstm=False built a memory")
    env = DrivingEnv(make_route_bank(16, seed=0, device="cuda"),
                     num_envs=N_ENVS, device="cuda")
    before = [p.detach().clone() for p in agent.policy_parameters()]
    t0 = time.perf_counter()
    rows, launches = _counted(lambda: train_device(
        agent, env, 1, RolloutConfig(num_steps=OPTION_STEPS), seed=5,
        log_fn=None))
    seconds = time.perf_counter() - t0
    # train_device resets the envs first: their render and encode, then
    # two paints and one encode per step and the bootstrap's encode
    want = {"paint": 2 + 2 * OPTION_STEPS,
            "dual_attention": OPTION_STEPS + 2, "dual_attention_bwd": 0}
    require(launches == want, f"13b launches {launches}, not {want}")
    params = agent.policy_parameters()
    for i, p in enumerate(params):
        _finite(f"13b policy parameter {i}", p.detach())
    moved = sum(not torch.equal(a, b.detach())
                for a, b in zip(before, params))
    require(moved == len(params) and all(
        math.isfinite(rows[0][k]) for k in ("value_loss", "policy_loss",
                                            "entropy_loss")),
            f"13b: {moved} of {len(params)} tensors moved, row {rows[0]}")
    print(f"[13b] use_lstm=False iteration N={N_ENVS} T={OPTION_STEPS}: "
          f"{seconds:.3f} s with its set-up, "
          f"{rows[0]['env_steps_per_sec']:.1f} env-steps/s; losses "
          f"{rows[0]['value_loss']:.5f}/{rows[0]['policy_loss']:.5f}/"
          f"{rows[0]['entropy_loss']:.5f}; launches {launches}")


def transformer_ensemble_eval(agent):
    """13c: EVAL_MEMBERS random transformer + ordinal members written as
    .msgpack snapshots by `agent.save_snapshot`, read back bit for bit, and
    their ensemble eval of EVAL_ENVS envs pinned to the eval routes for
    OPTION_STEPS steps, launches counted."""
    import os

    import torch

    from cadre_tpu_torch.envs.torch_env import DrivingEnv
    from cadre_tpu_torch.rl.agent import policy_bank, snapshot_banks
    from cadre_tpu_torch.rl.device_eval import evaluate_device

    cfg, f = agent.agent_cfg, agent.obs_dim
    trained = {s: {k: v.clone() for k, v in b.state_dict().items()}
               for s, b in agent.banks().items()}
    paths, members = [], []
    for seed in range(EVAL_MEMBERS):
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            member = {s: policy_bank(cfg, cfg.command_num, a, f).state_dict()
                      for s, a in (("steer", cfg.num_steer_outputs),
                                   ("throttle", cfg.num_throttle_outputs))}
        for s, bank in agent.banks().items():
            bank.load_state_dict(member[s])
        paths.append(os.path.join(_smoke_dir("smoke_options"),
                                  f"member_{seed}.msgpack"))
        agent.save_snapshot(paths[-1])
        members.append(member)
    for s, bank in agent.banks().items():
        bank.load_state_dict(trained[s])
    for path, member in zip(paths, members):
        back = snapshot_banks(path, agent)
        require(all(torch.equal(back[s][k], v.cpu())
                    for s in member for k, v in member[s].items()),
                f"13c: {path} did not read back bit for bit")
    env = DrivingEnv(eval_bank("cuda"), EVAL_ENVS, eval_env_config(),
                     device="cuda")
    ids = list(range(EVAL_ENVS))
    evaluate_device(agent, env, paths, max_steps=2, seed=1, route_ids=ids)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rows, launches = _counted(lambda: evaluate_device(
        agent, env, paths, max_steps=OPTION_STEPS, seed=7, route_ids=ids))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    want = {"paint": 2 + 2 * OPTION_STEPS,
            "dual_attention": 1 + OPTION_STEPS, "dual_attention_bwd": 0}
    require(launches == want, f"13c launches {launches}, not {want}")
    _check_rows(rows, "13c")
    size = os.path.getsize(paths[0]) / 2**20
    print(f"[13c] eval of {EVAL_MEMBERS} transformer + ordinal .msgpack "
          f"members ({size:.1f} MiB each) N={EVAL_ENVS} {OPTION_STEPS} "
          f"steps: {seconds:.3f} s with the load, "
          f"{EVAL_ENVS * OPTION_STEPS / seconds:.1f} eval env-steps/s; "
          f"{len(rows)} rows; launches {launches}")


def options_act_agreement():
    """13d: act_batch of small f32 transformer + ordinal banks on the card
    against the CPU from the same weights, window and Gumbel noise:
    logits, log-probs and values within 1e-4, equal actions, the carry
    handed back; then one fused update of such banks (update_agreement)."""
    import torch

    from cadre_tpu_torch.models.policy import PolicyBank
    from cadre_tpu_torch.rl.distributions import gumbel

    f, t, n = 50, 8, 6
    gen = torch.Generator().manual_seed(13)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(13)
        bank = PolicyBank(4, 33, f, **OPTIONS)
    obs = torch.randn(t, n, f, generator=gen)
    cmd = torch.randint(0, 4, (n,), generator=gen)
    carry = (torch.randn(n, f, generator=gen), torch.randn(n, f,
                                                         generator=gen))
    noise = gumbel((n, 33), gen, "cpu")
    with torch.no_grad():
        out_c, carry_c = bank.act_batch(obs, cmd, carry, noise)
        bank_g = bank.to("cuda")
        out_g, carry_g = bank_g.act_batch(
            obs.cuda(), cmd.cuda(), tuple(c.cuda() for c in carry),
            noise.cuda())
    err = max(float((getattr(out_g, k).cpu() - getattr(out_c, k)).abs().max())
              for k in ("logits", "log_prob", "value"))
    require(err <= 1e-4 and torch.equal(out_g.action.cpu(), out_c.action)
            and torch.equal(carry_g[0].cpu(), carry[0]),
            f"13d act cuda vs cpu: {err:.3g}, actions "
            f"{out_g.action.tolist()} vs {out_c.action.tolist()}")
    print(f"[13d] cuda vs cpu, transformer + ordinal act_batch (f={f}, "
          f"T={t}, N={n}): max|err| {err:.3g} (bound 1e-4), actions equal")
    update_agreement("13d", **OPTIONS)


XOSC_HARNESS = """<?xml version="1.0"?>
<OpenSCENARIO>
  <ParameterDeclarations>
    <ParameterDeclaration name="leadSpeed" parameterType="double" value="3.0"/>
  </ParameterDeclarations>
  <Entities>
    <ScenarioObject name="hero"><Vehicle name="ego"/></ScenarioObject>
    <ScenarioObject name="lead"><Vehicle name="car"/></ScenarioObject>
    <ScenarioObject name="walker"><Pedestrian name="ped"/></ScenarioObject>
  </Entities>
  <Storyboard>
    <Init><Actions>
      <Private entityRef="lead">
        <PrivateAction><TeleportAction><Position>
          <WorldPosition x="{lx:.3f}" y="{ly:.3f}" h="{lh:.5f}"/>
        </Position></TeleportAction></PrivateAction>
        <PrivateAction><LongitudinalAction><SpeedAction>
          <SpeedActionTarget><AbsoluteTargetSpeed value="$leadSpeed"/></SpeedActionTarget>
        </SpeedAction></LongitudinalAction></PrivateAction>
      </Private>
      <Private entityRef="walker">
        <PrivateAction><TeleportAction><Position>
          <WorldPosition x="{wx:.3f}" y="{wy:.3f}" h="0"/>
        </Position></TeleportAction></PrivateAction>
      </Private>
    </Actions></Init>
    <Story name="s"><Act name="a">
      <ManeuverGroup name="mg">
        <Actors><EntityRef entityRef="lead"/></Actors>
        <Maneuver name="m">
          <Event name="speed_up" priority="overwrite">
            <Action name="go"><PrivateAction><LongitudinalAction><SpeedAction>
              <SpeedActionTarget><AbsoluteTargetSpeed value="6.0"/></SpeedActionTarget>
            </SpeedAction></LongitudinalAction></PrivateAction></Action>
            <StartTrigger><ConditionGroup><Condition name="t"><ByValueCondition>
              <SimulationTimeCondition value="2.0" rule="greaterThan"/>
            </ByValueCondition></Condition></ConditionGroup></StartTrigger>
          </Event>
        </Maneuver>
      </ManeuverGroup>
      <ManeuverGroup name="mg2">
        <Actors><EntityRef entityRef="walker"/></Actors>
        <Maneuver name="m2">
          <Event name="walk" priority="overwrite">
            <Action name="ctrl"><PrivateAction><ControllerAction>
              <AssignControllerAction><Controller name="c"><Properties>
                <Property name="module"
                  value="cadre_tpu_torch.envs.actor_controls.PedestrianControl"/>
              </Properties></Controller></AssignControllerAction>
            </ControllerAction></PrivateAction></Action>
            <StartTrigger><ConditionGroup><Condition name="e"><ByValueCondition>
              <StoryboardElementStateCondition storyboardElementType="event"
                storyboardElementRef="speed_up" state="completeState"/>
            </ByValueCondition></Condition></ConditionGroup></StartTrigger>
          </Event>
        </Maneuver>
      </ManeuverGroup>
    </Act></Story>
  </Storyboard>
</OpenSCENARIO>
"""


def harness_run():
    """13e: the CARLA-free harness (no JAX, no tabulate): a storyboard
    written as .xosc 40 m ahead on a sim env's route, read by
    load_openscenario, run by build_manager's triggers on a SimDrivingEnv
    driven by an NpcAgent through the sensor contract for HARNESS_TICKS
    ticks, then ResultOutputProvider's report (text file and JUnit)."""
    import os
    import xml.etree.ElementTree as ET

    import numpy as np

    from cadre_tpu_torch.envs.autoagents import NpcAgent
    from cadre_tpu_torch.envs.openscenario import (
        build_manager,
        load_openscenario,
    )
    from cadre_tpu_torch.envs.result_writer import ResultOutputProvider
    from cadre_tpu_torch.envs.sim_env import SimDrivingEnv

    t0 = time.perf_counter()
    env = SimDrivingEnv(seed=4, vehicle_num=(0, 0))
    env.reset()
    route = env._route_xy
    i = min(40, len(route) - 2)
    d = route[i + 1] - route[i]
    heading = math.atan2(d[1], d[0])
    side = np.array([-math.sin(heading), math.cos(heading)])
    walker = route[min(80, len(route) - 1)] + 6.0 * side
    doc = XOSC_HARNESS.format(lx=route[i][0], ly=route[i][1], lh=heading,
                              wx=walker[0], wy=walker[1])
    out_dir = _smoke_dir("smoke_harness")
    path = os.path.join(out_dir, "lead_and_walker.xosc")
    with open(path, "w") as fh:
        fh.write(doc)
    cfg = load_openscenario(path)
    mgr = build_manager(cfg, env)
    lead, ped = env._obstacles[-2], env._obstacles[-1]
    require(lead.speed == 3.0 and ped.kind == "walker",
            f"13e: spawned {lead.kind}@{lead.speed} and {ped.kind}")
    agent = NpcAgent()
    plan = [((float(x), float(y)), 0) for x, y in route[::10]]
    agent.set_global_plan(plan, plan)
    start = lead.pos.copy()
    done, ticks, info, speeds = False, 0, {}, []
    while not done and ticks < HARNESS_TICKS:
        mgr.tick(env)
        data = {"GPS": (ticks, env._pos.copy()),
                "IMU": (ticks, np.array([0.0, 0.0, math.radians(env._yaw)])),
                "speed": (ticks, {"speed": env._speed})}
        _, _, done, info = env.step(agent.run_step(data, ticks * env.dt))
        speeds.append(lead.speed)
        ticks += 1
    board = getattr(env, "blackboard", {})
    require(board.get("xosc:speed_up:done") and 6.0 in speeds[19:]
            and board.get("xosc:walk:done")
            and type(ped._control.controller).__name__ == "PedestrianControl"
            and float(np.hypot(*(lead.pos - start))) > 3.0 * 2.0,
            f"13e: storyboard did not run: {sorted(board)}, lead speeds "
            f"{sorted(set(speeds))}")
    # scripts/run_scenario.py's route-scaled budget of game time
    timeout = 0.8 * float(np.hypot(*np.diff(route, axis=0).T).sum()) + 5.0
    report = ResultOutputProvider(
        "lead_and_walker", env._criteria, duration_game=ticks * env.dt,
        duration_system=time.perf_counter() - t0, timeout=timeout,
        timed_out=ticks * env.dt >= timeout,
        other_actors=[f"{ob.kind}@{np.round(ob.pos, 1).tolist()}"
                      for ob in env._obstacles])
    text = report.write(stdout=False,
                        filename=os.path.join(out_dir, "report.txt"),
                        junit=os.path.join(out_dir, "report.xml"))
    suite = ET.parse(os.path.join(out_dir, "report.xml")).getroot()
    require("Results of Scenario: lead_and_walker" in text
            and "╒" in text and int(suite.get("tests")) == len(env._criteria),
            "13e: the report is not whole")
    print(f"[13e] harness: {path} ({len(cfg.events)} events) on a sim env "
          f"driven by an NpcAgent for {ticks} ticks "
          f"({info.get('error_message') or 'still running'}), "
          f"report {report.result()} with {len(env._criteria)} criteria in "
          f"{time.perf_counter() - t0:.2f} s")
    for line in text.strip().splitlines()[:3]:
        print(f"[13e]   {line}")


def phase_options():
    """The policy-bank options and the scenario harness; returns 13a's
    launch counts."""
    t0 = time.perf_counter()
    agent, launches = options_iteration()
    no_memory_iteration()
    transformer_ensemble_eval(agent)
    options_act_agreement()
    harness_run()
    print(f"[13] phase 13 in {time.perf_counter() - t0:.1f} s")
    return launches


# --------------------------------------------------------------- phase 14

CARLA_SINGLE_STEPS = 20  # 14b's `train` episode
NOCRASH_ITERATIONS = 2  # 14f
NOCRASH_EVAL_ROUTES = 25
NOCRASH_EVAL_SHORT = 3


def _carla_stub():
    """tests/torch_carla_stub.py, the in-process fake of the `carla`
    client API (this machine has no CARLA server), installed as `carla`;
    returns the stub module."""
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                        "torch_carla_stub.py")
    spec = importlib.util.spec_from_file_location("torch_carla_stub", path)
    stub = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(stub)
    sys.modules["carla"] = stub.make_module()
    return stub


def _carla_files():
    """A 200 m straight route and a 12 m one on the stub's road, and a
    scenario JSON whose Scenario1 / Scenario3 / Scenario2 triggers lie
    within the trigger radius of the start, under build/; returns their
    paths."""
    import json
    import os

    work = _smoke_dir("smoke_carla")
    paths = {}
    for name, end in (("long", 200.0), ("short", 12.0)):
        paths[name] = os.path.join(work, f"{name}.xml")
        with open(paths[name], "w") as f:
            f.write('<routes><route id="0" map="Town01">'
                    '<waypoint x="0" y="0" z="0"/>'
                    f'<waypoint x="{end}" y="0" z="0"/></route></routes>')
    events = [{"scenario_type": stype, "available_event_configurations": [
        {"transform": {"x": x, "y": 0.0, "z": 0.0, "yaw": 0.0}}]}
        for stype, x in (("Scenario1", 3.0), ("Scenario3", 8.0),
                         ("Scenario2", 10.0))]
    paths["scenarios"] = os.path.join(work, "scenarios.json")
    with open(paths["scenarios"], "w") as f:
        json.dump({"available_scenarios": [{"Town01": events}]}, f)
    return paths


class _MethodTimer:
    """Host seconds and calls of methods, by wrapping them on their
    classes until `restore()`."""

    def __init__(self, methods):
        self.seconds, self.calls = {}, {}
        self._saved = []
        for owner, name in methods:
            fn = getattr(owner, name)
            self._saved.append((owner, name, fn))
            setattr(owner, name, self._wrap(name, fn))

    def _wrap(self, name, fn):
        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                self.seconds[name] = self.seconds.get(name, 0.0) + \
                    time.perf_counter() - t0
                self.calls[name] = self.calls.get(name, 0) + 1

        return timed

    def restore(self):
        for owner, name, fn in self._saved:
            setattr(owner, name, fn)


def _captured(module, name):
    """Wrap `module.name` so that its last return value is kept; returns
    (holder, restore)."""
    fn = getattr(module, name)
    held = {}

    def keep(*args, **kwargs):
        held["out"] = fn(*args, **kwargs)
        return held["out"]

    setattr(module, name, keep)
    return held, lambda: setattr(module, name, fn)


def carla_train(stub, files):
    """14a and 14b: `main --env carla` in process on four stub worlds at
    EnvConfig.ports (a red-light junction on the first), with the
    scenario JSON: one train_vec iteration of CARLA_ENVS envs x T_HOST
    steps, then one `train` episode of CARLA_SINGLE_STEPS steps. Launches
    counted, the act / env / update split and the CARLA-side host time
    per tick. Returns (14a's launches, both snapshots)."""
    import os
    import shutil

    from cadre_tpu_torch import main as pmain
    from cadre_tpu_torch.configs.agent_config import EnvConfig
    from cadre_tpu_torch.envs.carla_env import CarlaDrivingEnv
    from cadre_tpu_torch.rl import train as ptrain
    from cadre_tpu_torch.rl import vec_train

    ports = EnvConfig().ports[:CARLA_ENVS]
    worlds = {port: stub.World("Town01") for port in ports}
    junction = stub.World("Town01", junction_x=40.0)
    light = stub.TrafficLight(junction, stub.Transform(stub.Location(38.0)))
    light.set_state(stub.TrafficLightState.Red)
    junction._actors.append(light)
    worlds[ports[0]] = junction
    stub.Client._worlds = dict(worlds)
    timer = _MethodTimer([(CarlaDrivingEnv, "_world_step"),
                          (stub.World, "tick"),
                          (CarlaDrivingEnv, "_world_tick"),
                          (CarlaDrivingEnv, "_planner_step"),
                          (CarlaDrivingEnv, "spawn_scenario_actor")])
    stats, restore = _captured(vec_train, "train_vec")
    work = _smoke_dir("smoke_carla_vec")
    shutil.rmtree(work, ignore_errors=True)
    argv = ["--env", "carla", "--town", "Town01", "--device", "cuda",
            "--carla-port", str(ports[0]), "--routes", files["long"],
            "--scenarios", files["scenarios"], "--work-dir", work]
    try:
        t0 = time.perf_counter()
        path, launches = _counted(lambda: pmain.main(
            [*argv, "--num-envs", str(CARLA_ENVS), "--num-steps",
             str(T_HOST), "--iterations", "1"]))
        seconds = time.perf_counter() - t0
    finally:
        restore()
    require(launches == {"paint": 0, "dual_attention": T_HOST + 1,
                         "dual_attention_bwd": 0},
            f"14a launches {launches}, not 0 / {T_HOST + 1} / 0")
    require(os.path.exists(path), f"14a wrote no {path}")
    heroes = {port: sum(a.attributes.get("role_name") == "hero"
                        for a in world.get_actors())
              for port, world in worlds.items()}
    require(all(heroes.values()), f"14a: heroes by port {heroes}")
    spawned = timer.calls.get("spawn_scenario_actor", 0)
    require(spawned > 0, "14a: no trigger spawned a scenario actor")
    s = stats["out"][0]
    losses = [s.value_loss, s.policy_loss, s.entropy_loss]
    require(all(map(math.isfinite, losses)), f"14a losses {losses}")
    ticks = timer.calls["_world_tick"]
    step_s = timer.seconds["_world_step"] - timer.seconds["tick"]
    steps = T_HOST * CARLA_ENVS
    iteration_s = sum(s.phase_seconds.values())
    split = ", ".join(f"{k} {v:.3f} s ({100 * v / iteration_s:.1f}%)"
                      for k, v in s.phase_seconds.items())
    print(f"[14a] main --env carla --num-envs {CARLA_ENVS} --num-steps "
          f"{T_HOST} --iterations 1 (stub world, f32 encoder, ports "
          f"{list(ports)}): {seconds:.3f} s with its set-up; the iteration "
          f"{iteration_s:.3f} s, {steps / iteration_s:.1f} env-steps/s; "
          f"{split}; {s.episodes_finished} episodes ended; {spawned} "
          f"scenario actors spawned; losses {losses[0]:.5f}/"
          f"{losses[1]:.5f}/{losses[2]:.5f}; launches {launches}")
    print(f"[14a] CARLA-side host time per tick over {ticks} ticks (resets "
          f"included): sensor fan-in (get_data, waiting on the 20 Hz "
          f"speedometer thread) "
          f"{1e3 * timer.seconds['_world_tick'] / ticks:.3f} ms, planner "
          f"{1e3 * timer.seconds['_planner_step'] / ticks:.3f} ms, control"
          f" + light refresh + criteria "
          f"{1e3 * step_s / timer.calls['_world_step']:.3f} ms, the stub "
          f"server's tick "
          f"{1e3 * timer.seconds['tick'] / timer.calls['tick']:.3f} ms")

    held, restore = _captured(ptrain, "train")
    rollout, restore_rollout = _captured(ptrain, "collect_rollout")
    stub.Client._worlds = dict(worlds)
    single = _smoke_dir("smoke_carla_one")
    shutil.rmtree(single, ignore_errors=True)
    argv[argv.index("--work-dir") + 1] = single
    try:
        t0 = time.perf_counter()
        path1, one = _counted(lambda: pmain.main(
            [*argv, "--num-envs", "1", "--episodes", "1", "--num-steps",
             str(CARLA_SINGLE_STEPS)]))
        seconds = time.perf_counter() - t0
    finally:
        restore()
        restore_rollout()
        timer.restore()
    # the bootstrap acts unless the rollout's last step ended the episode
    acts = CARLA_SINGLE_STEPS + (0 if rollout["out"][1] else 1)
    require(one == {"paint": 0, "dual_attention": acts,
                    "dual_attention_bwd": 0},
            f"14b launches {one}, not 0 / {acts} / 0")
    require(os.path.exists(path1), f"14b wrote no {path1}")
    e = held["out"][0]
    print(f"[14b] main --env carla --num-envs 1 --episodes 1 --num-steps "
          f"{CARLA_SINGLE_STEPS} (train): {seconds:.3f} s with its set-up;"
          f" losses {e.value_loss:.5f}/{e.policy_loss:.5f}/"
          f"{e.entropy_loss:.5f}; launches {one}")
    return launches, [path, path1]


def carla_eval(stub, files, members):
    """14c: `python -m cadre_tpu_torch.eval --env carla` in process
    (training=False: the sequential RouteIndexer) of 14a's and 14b's
    snapshots over one episode of the 12 m route with the scenarios, one
    dual-attention launch per tick; its rows printed."""
    import os
    import shutil

    from cadre_tpu_torch import eval as peval

    stub.Client._worlds = {8010: stub.World("Town01")}
    work = _smoke_dir("smoke_carla_eval")
    shutil.rmtree(work, ignore_errors=True)
    t0 = time.perf_counter()
    results, launches = _counted(lambda: peval.main(
        ["--env", "carla", "--device", "cuda", "--snapshots", *members,
         "--episodes", "1", "--routes", files["short"], "--scenarios",
         files["scenarios"], "--vehicles", "0", "--walkers", "0",
         "--town", "Town01", "--carla-port", "8010", "--work-dir", work]))
    seconds = time.perf_counter() - t0
    ticks = sum(r.steps for r in results)
    require(len(results) == 1 and ticks > 0, f"14c: {results}")
    require(launches == {"paint": 0, "dual_attention": ticks,
                         "dual_attention_bwd": 0},
            f"14c launches {launches}, not 0 / {ticks} / 0")
    r = results[0]
    require(0.0 <= r.completion_ratio <= 100.0
            and 0.0 <= r.driving_score <= 100.0, f"14c: bad {r}")
    with open(os.path.join(work, "criteria_results.csv")) as f:
        rows = f.read().strip().splitlines()
    require(len(rows) == 2 and rows[0].startswith("RouteCompletionTest"),
            f"14c: criteria CSV {rows}")
    print(f"[14c] eval --env carla, K={len(members)} members (14a's and "
          f"14b's snapshots), one episode of the 12 m route: {ticks} ticks "
          f"in {seconds:.3f} s with the load, {ticks / seconds:.1f} "
          f"ticks/s; launches {launches}")
    print(f"[14c]   row: {vars(r)}")
    for line in rows:
        print(f"[14c]   {line}")


def carla_clis():
    """14d and 14e: `simple_test` (its PNG read back equal to the last
    tick's 8 frames, one dual-attention launch per act) and
    `run_scenario` for one registry scenario and for phase 13's .xosc
    (no launches: no model acts), which prints each report."""
    import os

    import numpy as np

    from cadre_tpu_torch import run_scenario, simple_test
    from cadre_tpu_torch.perception.visualize import read_png
    from cadre_tpu_torch.rl.agent import CadreAgent

    png = os.path.join(_smoke_dir("smoke_carla_clis"), "frames.png")
    timer = _MethodTimer([(CadreAgent, "act")])
    try:
        t0 = time.perf_counter()
        tick, launches = _counted(lambda: simple_test.main(
            ["--env", "carla", "--device", "cuda", "--out", png]))
        seconds = time.perf_counter() - t0
    finally:
        timer.restore()
    acts = timer.calls["act"]
    require(launches == {"paint": 0, "dual_attention": acts,
                         "dual_attention_bwd": 0},
            f"14d launches {launches}, not 0 / {acts} / 0")
    frames = read_png(png)
    require(frames.shape == (144, 8 * 256, 3) and np.array_equal(
        frames, np.concatenate(list(tick["rgb"]), axis=1)),
            f"14d: {png} does not read back as the last tick's frames")
    print(f"[14d] simple_test --env carla (the sim env, as the JAX "
          f"script's): {acts} acts in {seconds:.3f} s; {png} "
          f"{frames.shape} reads back equal; launches {launches}")

    xosc = os.path.join(_smoke_dir("smoke_harness"), "lead_and_walker.xosc")
    for what, args in (("registry", ["--scenario", "dynamic_object_crossing",
                                     "--timeout", "20"]),
                       ("xosc", ["--openscenario", xosc, "--seed", "4",
                                 "--agent", "npc", "--timeout", "30"])):
        report = os.path.join(_smoke_dir("smoke_carla_clis"),
                              f"report_{what}.txt")
        t0 = time.perf_counter()
        code, launches = _counted(lambda: run_scenario.main(
            [*args, "--output-file", report]))
        seconds = time.perf_counter() - t0
        require(code in (0, 1) and launches == {
            "paint": 0, "dual_attention": 0, "dual_attention_bwd": 0},
                f"14e {what}: exit {code}, launches {launches}")
        with open(report) as f:
            text = f.read()
        require("Results of Scenario" in text, f"14e {what}: no report")
        print(f"[14e] run_scenario {' '.join(args)}: exit {code} in "
              f"{seconds:.3f} s (its report printed above)")


def carla_nocrash():
    """14f: `run_nocrash_eval` at production width (bf16 encoder) in
    process: NOCRASH_ITERATIONS device iterations of N_ENVS x T_HOST on a
    write_lane_routes XML, a snapshot after each, then the eval of both
    over NOCRASH_EVAL_ROUTES Town01 routes of another XML, tier empty,
    T_HOST steps. Launches counted: the env reset's two paints and one
    encode, then two paints and one dual attention per step and the
    bootstrap's dual attention per iteration, and the same for the
    eval."""
    import os
    import shutil

    from cadre_tpu_torch import run_nocrash_eval
    from cadre_tpu_torch.envs.town_maps import write_lane_routes

    work = _smoke_dir("smoke_nocrash")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    train = write_lane_routes(os.path.join(work, "train.xml"), 16)
    evalx = write_lane_routes(os.path.join(work, "eval.xml"),
                              NOCRASH_EVAL_ROUTES, n_short=NOCRASH_EVAL_SHORT)
    t0 = time.perf_counter()
    art, launches = _counted(lambda: run_nocrash_eval.main(
        ["--device", "cuda", "--num-envs", str(N_ENVS), "--steps",
         str(T_HOST), "--iterations", str(NOCRASH_ITERATIONS),
         "--snap-every", "1", "--eval-members", "2", "--tiers", "empty",
         "--eval-steps", str(T_HOST), "--train-routes", train,
         "--eval-routes", f"Town01={evalx}", "--workdir",
         os.path.join(work, "run")]))
    seconds = time.perf_counter() - t0
    train_paint = 2 + 2 * T_HOST * NOCRASH_ITERATIONS
    train_attention = 1 + (T_HOST + 1) * NOCRASH_ITERATIONS
    want = {"paint": train_paint + 2 + 2 * T_HOST,
            "dual_attention": train_attention + 1 + T_HOST,
            "dual_attention_bwd": 0}
    require(launches == want, f"14f launches {launches}, not {want}")
    tier = art["eval"]["Town01"]["empty"]
    require(tier["routes"] == NOCRASH_EVAL_ROUTES and tier["episodes"] > 0
            and art["protocol"]["ensemble_members"] == 2,
            f"14f: eval {({k: v for k, v in tier.items() if k != 'rows'})}")
    for row in tier["rows"]:
        require(0.0 <= row["completion"] <= 1.0 + 1e-6, f"14f row {row}")
    print(f"[14f] run_nocrash_eval N={N_ENVS} T={T_HOST} x "
          f"{NOCRASH_ITERATIONS} iterations + the eval of 2 members over "
          f"{NOCRASH_EVAL_ROUTES} Town01 routes, {T_HOST} steps, tier "
          f"empty: {seconds:.3f} s; launches {launches} (training: "
          f"{train_paint} paints, {train_attention} dual attentions)")
    for row in art["train"]["rows"]:
        print(f"[14f]   train {row}")
    print(f"[14f]   eval Town01/empty: completion {tier['mean_completion']},"
          f" driving score {tier['mean_driving_score']}, errors "
          f"{tier['errors']}, {tier['episodes']} episodes")
    for row in tier["rows"]:
        print(f"[14f]   eval row {row}")
    return launches


def phase_carla():
    """The CARLA env on the stub world and the last three CLIs; returns
    14a's and 14f's launch counts."""
    t0 = time.perf_counter()
    stub = _carla_stub()
    try:
        files = _carla_files()
        launches, members = carla_train(stub, files)
        carla_eval(stub, files, members)
    finally:
        stub.Client._worlds = {}
        sys.modules.pop("carla", None)
    carla_clis()
    nocrash = carla_nocrash()
    print(f"[14] phase 14 in {time.perf_counter() - t0:.1f} s")
    return launches, nocrash


# --------------------------------------------------------------- phase 15

# the deep-backbone CoPM: the JAX package's DANetParams(backbone=...) with a
# Bottleneck ResNet, whose head runs K2 and K3 at C=512, Cqk=64
DEEP_BACKBONE = "resnet50"
DEEP_STEPS = 20                 # timed resnet50 pretraining steps
WIDE_CAMERA = dict(image_height=288, image_width=512, feat_h=9, feat_w=16)


def _deep_trainer(cfg, stats, model=None, batch=PERCEPTION_BATCH):
    from cadre_tpu_torch.configs.danet_config import PerceptionTrainParams
    from cadre_tpu_torch.perception.trainer import PerceptionTrainer

    return PerceptionTrainer(
        cfg, PerceptionTrainParams(batch_size=batch),
        steps_per_epoch=PERCEPTION_SHARDS, seed=0,
        seg_class_weight=stats.seg_class_weight,
        light_class_weight=stats.light_class_weight, device="cuda",
        model=model)


def _one_counted_step(trainer, batch, what, tag):
    """A warm-up step (cuDNN's choices), then one step under the profiler
    with its launches counted (one K2, one K3) and its peak memory."""
    import torch

    trainer.train_step(batch, sync=False)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, launches = _counted(lambda: profile(
        lambda: trainer.train_step(batch, sync=False), what, 1,
        "train step", tag=tag))
    peak = torch.cuda.max_memory_allocated()
    want = {"paint": 0, "dual_attention": 1, "dual_attention_bwd": 1}
    require(launches == want, f"{what}: launches {launches}, not {want}")
    for name, v in losses.items():
        _finite(f"{what} loss {name}", v)
    print(f"[{tag}] {what}: total loss {float(losses['total']):.1f}; peak "
          f"memory allocated {peak / 2**30:.2f} GiB; launches {launches}")
    return launches


def deep_pretraining(batch, stats):
    """15a: the resnet50 DANet (experiment_params('auto_danet',
    backbone=...)) trained at B=PERCEPTION_BATCH, f32, TF32 off, for
    DEEP_STEPS steps on one batch after a warm-up step: one K2 and one K3
    per step, a falling loss, frames/s, peak memory, a profile."""
    import torch

    from cadre_tpu_torch.configs.experiments import experiment_params

    cfg = experiment_params("auto_danet", backbone=DEEP_BACKBONE)
    trainer = _deep_trainer(cfg, stats)
    params = dict(trainer.model.named_parameters())
    watch = ("backbone.layer4.2.conv3.weight", "da_head.conv5a.0.weight",
             "da_head.sa.gamma", "da_head.sc.gamma")
    before = {n: params[n].detach().clone() for n in watch}
    trainer.train_step(batch, sync=False)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    losses, launches = _counted(lambda: [
        trainer.train_step(batch, sync=False) for _ in range(DEEP_STEPS)])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    want = {"paint": 0, "dual_attention": DEEP_STEPS,
            "dual_attention_bwd": DEEP_STEPS}
    require(launches == want, f"resnet50 pretraining launches {launches}, "
            f"not {want}")
    totals = [float(l["total"]) for l in losses]
    for step in losses:
        for name, v in step.items():
            _finite(f"resnet50 pretraining loss {name}", v)
    require(totals[-1] < totals[0], f"resnet50 total did not fall over "
            f"{DEEP_STEPS} steps: {totals[0]:.1f} -> {totals[-1]:.1f}")
    moved = {n: float((params[n].detach() - before[n]).abs().max())
             for n in watch}
    require(all(v > 0 for v in moved.values()), f"not moved: {moved}")
    for name, p in params.items():
        _finite(f"resnet50 parameter {name}", p.detach())
    print(f"[15a] {DEEP_STEPS} resnet50 DANet steps on one batch at B="
          f"{PERCEPTION_BATCH} (auto_danet, 144x256, head C=512 Cqk=64 P=40, "
          f"f32, TF32 off): {seconds:.3f} s, "
          f"{DEEP_STEPS * PERCEPTION_BATCH / seconds:.1f} train frames/s "
          f"({seconds / DEEP_STEPS * 1e3:.2f} ms per step); peak memory "
          f"allocated {peak / 2**30:.2f} GiB; total loss {totals[0]:.1f} -> "
          f"{totals[-1]:.1f}; largest moves {moved}; launches {launches}")
    prof_steps = 3
    profile(lambda: [trainer.train_step(batch, sync=False)
                     for _ in range(prof_steps)],
            f"{prof_steps} resnet50 train steps (B={PERCEPTION_BATCH})",
            prof_steps, "train step", tag="15a")
    return launches


def deep_da_beta_vae(batch, stats):
    """15b: one step of auto_da_beta_vae on a resnet50 trunk."""
    from cadre_tpu_torch.configs.experiments import experiment_params
    from cadre_tpu_torch.models.registry import build_model

    cfg = experiment_params("auto_da_beta_vae", backbone=DEEP_BACKBONE)
    trainer = _deep_trainer(cfg, stats,
                            build_model("da_beta_vae", cfg, seed=0))
    _one_counted_step(trainer, batch, f"resnet50 DABetaVAE step (B="
                      f"{PERCEPTION_BATCH}, f32)", "15b")


def deep_encoder():
    """15c: the resnet50 CoPM's bf16 latent at B=N_ENVS and 256 (frames/s,
    one K2 a call, peak memory, a profile); returns the agent."""
    import torch

    from cadre_tpu_torch.configs.danet_config import danet_params
    from cadre_tpu_torch.rl.agent import CadreAgent

    agent = CadreAgent.create(danet_params(backbone=DEEP_BACKBONE),
                              bf16_encoder=True, device="cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(15)
    for b in (N_ENVS, 256):
        x = torch.rand(b, 144, 256, 4, generator=gen,
                       device="cuda").to(torch.bfloat16)
        with torch.no_grad():
            agent.encoder.latent(x)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            z, launches = _counted(lambda: agent.encoder.latent(x))
            require(launches["dual_attention"] == 1 and tuple(z.shape) == (
                b, agent.danet_cfg.latent_dim), f"resnet50 latent B={b}: "
                f"{tuple(z.shape)}, launches {launches}")
            _finite(f"resnet50 latent B={b}", z)
            ms = time_ms(lambda: agent.encoder.latent(x), 10)
            peak = torch.cuda.max_memory_allocated()
            print(f"[15c] resnet50 encoder bf16 B={b}: {ms:.3f} ms, "
                  f"{b / ms * 1e3:.1f} frames/s; peak memory allocated "
                  f"{peak / 2**30:.2f} GiB; launches {launches}")
            if b == 256:
                profile(lambda: [agent.encoder.latent(x) for _ in range(3)],
                        "3 resnet50 latents (B=256, bf16)", 3, "latent",
                        tag="15c")
    return agent


def deep_iteration(agent):
    """15d: one whole device iteration (N_ENVS envs, T_TRAIN steps, 4 PPO
    epochs of 2 minibatches) with the resnet50 bf16 encoder after a T=2
    warm-up: two paints and one K2 per step and the bootstrap's K2; its
    env-steps/s, peak memory, and a profile of 5 rollout steps. Returns
    the counted iteration's launches."""
    import torch

    from cadre_tpu_torch.configs.agent_config import (
        RolloutConfig,
        TrainConfig,
    )
    from cadre_tpu_torch.envs.torch_env import DrivingEnv, make_route_bank
    from cadre_tpu_torch.rl.device_rollout import (
        make_device_iteration,
        make_device_rollout,
    )

    env = DrivingEnv(make_route_bank(16, seed=0, device="cuda"),
                     num_envs=N_ENVS, device="cuda")
    warm, init_carry = make_device_iteration(
        agent, env, RolloutConfig(num_steps=2), TrainConfig(), seed=3)
    carry, _ = warm(agent.opt, init_carry())
    iteration, _ = make_device_iteration(
        agent, env, RolloutConfig(num_steps=T_TRAIN), TrainConfig(), seed=4)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    (carry, m), launches = _counted(lambda: iteration(agent.opt, carry))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    want = {"paint": 2 * T_TRAIN, "dual_attention": T_TRAIN + 1,
            "dual_attention_bwd": 0}
    require(launches == want, f"resnet50 iteration launches {launches}, "
            f"not {want}")
    for name, t in m._asdict().items():
        if isinstance(t, torch.Tensor):
            _finite(f"resnet50 iteration {name}", t)
    steps = T_TRAIN * N_ENVS
    print(f"[15d] iteration with the resnet50 bf16 encoder N={N_ENVS} "
          f"T={T_TRAIN} E=4 M=2: {seconds:.3f} s, {steps / seconds:.1f} "
          f"env-steps/s; rollout {m.rollout_seconds:.3f} s, update "
          f"{seconds - m.rollout_seconds:.3f} s; peak memory allocated "
          f"{peak / 2**30:.2f} GiB; launches {launches}")
    prof_steps = 5
    short, _ = make_device_rollout(agent, env,
                                   RolloutConfig(num_steps=prof_steps),
                                   seed=2)
    profile(lambda: short(carry)[0], f"{prof_steps} rollout steps with the "
            f"resnet50 encoder", prof_steps, "step", tag="15d")
    return launches


def wide_camera_step(packed, stats):
    """15e: one f32 pretraining step of a resnet18 DANet on a 288x512
    camera (feat 9x16: the head's P=144), B=PERCEPTION_BATCH, on 8a's
    frames scaled up 2x."""
    import torch

    from cadre_tpu_torch.configs.danet_config import danet_params

    def up(t, dims):
        for d in dims:
            t = t.repeat_interleave(2, dim=d)
        return t

    batch = dict(packed, rgb_u8=up(packed["rgb_u8"], (1, 2)),
                 route_u8=up(packed["route_u8"], (1, 2)),
                 camera_seg=up(packed["camera_seg"], (1, 2)))
    trainer = _deep_trainer(danet_params(**WIDE_CAMERA), stats)
    _one_counted_step(trainer, batch, f"288x512 DANet step (B="
                      f"{PERCEPTION_BATCH}, head C=128 Cqk=16 P=144, f32)",
                      "15e")


# CARLA's default RGB camera (800x600): the JAX backbone's 19x25 features,
# the head's P=475
CARLA_CAMERA = dict(image_height=600, image_width=800, feat_h=19, feat_w=25)
CARLA_CAMERA_BATCH = 16


def carla_camera_step(packed, stats):
    """15f: one f32 pretraining step (TF32 off) of a resnet18 DANet on an
    800x600 camera (feat 19x25: the head's P=475), B=CARLA_CAMERA_BATCH,
    on 8a's frames resized (nearest) to 600x800: one K2 and one K3, a
    finite loss, ms (profiled) and peak memory."""
    import torch

    from cadre_tpu_torch.configs.danet_config import danet_params

    h, w = CARLA_CAMERA["image_height"], CARLA_CAMERA["image_width"]
    n = CARLA_CAMERA_BATCH

    def nearest(t, dims, sizes):
        for d, size in zip(dims, sizes):
            idx = (torch.arange(size, device=t.device) * t.shape[d]) // size
            t = t.index_select(d, idx)
        return t

    batch = {k: v[:n] for k, v in packed.items()}
    batch.update(rgb_u8=nearest(batch["rgb_u8"], (1, 2), (h, w)),
                 route_u8=nearest(batch["route_u8"], (1, 2), (w, h)),
                 camera_seg=nearest(batch["camera_seg"], (1, 2), (h, w)))
    trainer = _deep_trainer(danet_params(**CARLA_CAMERA), stats, batch=n)
    return _one_counted_step(trainer, batch, f"800x600 DANet step (B={n}, "
                             f"head C=128 Cqk=16 P=475, f32)", "15f")


LATENT_PROFILE_CALLS = 5


def _k2_share(fn):
    """K2's device ms per call of fn() and all device ms per call, from
    torch.profiler over LATENT_PROFILE_CALLS calls: the kernels whose name
    holds dual_attention against every device op."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(LATENT_PROFILE_CALLS):
            fn()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    rows = [e for e in prof.key_averages() if e.device_type == cuda
            and not getattr(e, "is_user_annotation", False)]
    busy = sum(e.self_device_time_total for e in rows)
    k2 = sum(e.self_device_time_total for e in rows
             if "dual_attention" in e.key)
    require(k2 > 0 and busy > 0, "profile of the latent: no K2 device time")
    return (k2 / LATENT_PROFILE_CALLS / 1e3, busy / LATENT_PROFILE_CALLS / 1e3)


def carla_camera_latent():
    """15g: the bf16 latent (DANet.latent, as the agent runs it) of a
    resnet18 and of a resnet50 DANet on the 800x600 camera at B=N_ENVS,
    random weights from seeds: frames/s, peak memory, one K2 a call (the
    head's bf16 P=475 at C=128 and at C=512) and K2's device time beside
    the latent's (`_k2_share`); then K2 and K3 timed at
    15f's shape (B=CARLA_CAMERA_BATCH, f32, C=128). Returns the two
    latents' launches."""
    import torch

    from cadre_tpu_torch.configs.danet_config import danet_params
    from cadre_tpu_torch.ops import dual_attention as da
    from cadre_tpu_torch.rl.agent import CadreAgent

    h, w = CARLA_CAMERA["image_height"], CARLA_CAMERA["image_width"]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(17)
    total = {"paint": 0, "dual_attention": 0, "dual_attention_bwd": 0}
    for backbone, c in (("resnet18", 128), (DEEP_BACKBONE, 512)):
        agent = CadreAgent.create(
            danet_params(backbone=backbone, **CARLA_CAMERA),
            bf16_encoder=True, device="cuda")
        x = torch.rand(N_ENVS, h, w, 4, generator=gen,
                       device="cuda").to(torch.bfloat16)
        with torch.no_grad():
            agent.encoder.latent(x)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            z, launches = _counted(lambda: agent.encoder.latent(x))
            want = {"paint": 0, "dual_attention": 1, "dual_attention_bwd": 0}
            require(launches == want and tuple(z.shape) == (
                N_ENVS, agent.danet_cfg.latent_dim), f"{backbone} latent on "
                f"the 800x600 camera: {tuple(z.shape)}, launches {launches}")
            _finite(f"{backbone} latent on the 800x600 camera", z)
            ms = time_ms(lambda: agent.encoder.latent(x), 10)
            peak = torch.cuda.max_memory_allocated()
            k2_ms, busy_ms = _k2_share(lambda: agent.encoder.latent(x))
        print(f"[15g] {backbone} encoder on the 800x600 camera, bf16 B="
              f"{N_ENVS} (head C={c} P=475): {ms:.3f} ms, "
              f"{N_ENVS / ms * 1e3:.1f} frames/s; peak memory allocated "
              f"{peak / 2**30:.2f} GiB; launches {launches}")
        print(f"[15g] {backbone}: K2 {k2_ms:.4f} ms of device time a call "
              f"(profiler, {LATENT_PROFILE_CALLS} calls), "
              f"{100 * k2_ms / ms:.2f}% of the latent's {ms:.3f} ms and "
              f"{100 * k2_ms / busy_ms:.2f}% of its {busy_ms:.3f} ms of "
              f"device time")
        for name in total:
            total[name] += launches[name]
        del agent, x, z
        torch.cuda.empty_cache()
    b = CARLA_CAMERA_BATCH
    args = _attention_inputs(b, 128, 16, torch.float32, gen, "cuda", 19, 25)
    bargs, _ = _backward_inputs(b, 128, 16, gen, "cuda", 19, 25)
    fwd = device_ms(lambda: da.fused_dual_attention(*args))
    bwd = device_ms(lambda: da.dual_attention_backward(*bargs))
    print(f"[15g] at 15f's shape (B={b} P=475 C=128 Cqk=16 f32): K2 "
          f"{fwd:.4f} ms, K3 {bwd:.4f} ms (graphs of 200 calls)")
    return total


def phase_deep(data_dir=None):
    """The deep-backbone CoPM and the wide cameras at full width; returns
    15a's launch counts (pretraining), 15d's (the device iteration) and
    15g's (the 800x600 latents)."""
    import torch

    from cadre_tpu_torch.perception.data import (
        PerceptionDataLoader,
        compute_stats,
    )

    t0 = time.perf_counter()
    no_tf32()
    data_dir = data_dir or perception_shards()
    loader = PerceptionDataLoader(data_dir, batch_size=PERCEPTION_BATCH,
                                  seed=0, packed=True, cache_in_memory=True)
    stats = compute_stats(loader.paths)
    packed = {k: torch.as_tensor(v).cuda() for k, v in next(iter(loader))
              .items()}
    torch.cuda.empty_cache()
    pretraining = deep_pretraining(packed, stats)
    deep_da_beta_vae(packed, stats)
    iteration = deep_iteration(deep_encoder())
    wide_camera_step(packed, stats)
    carla_camera_step(packed, stats)
    latent = carla_camera_latent()
    print(f"[15] phase 15 in {time.perf_counter() - t0:.1f} s")
    return pretraining, iteration, latent


# ---------------------------------------------------------------- main

def main(argv) -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA GPU", file=sys.stderr)
        return 2
    if argv[:1] == ["--time-kernels-of"] and len(argv) == 3:
        return time_kernels_of(*argv[1:])
    try:
        import cadre_tpu_torch  # noqa: F401
    except ImportError as exc:
        print(f"chip_smoke: the port is not beside this script: {exc}",
              file=sys.stderr)
        return 2
    if argv[:1] == ["--mesh-step"] and len(argv) == 2:
        return mesh_step_worker(argv[1])
    if argv == ["--conv-times"]:
        return conv_times()
    for flag, compare in (("--kernel-times", compare_kernel_times),
                          ("--phase-times", compare_phase_times)):
        if argv[:1] == [flag] and len(argv) > 1:
            try:
                return compare(argv[1:])
            except PhaseError as exc:
                print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
                return 1
    if argv:
        print(__doc__, file=sys.stderr)
        return 2
    try:
        card = phase_card()
        phase_build()
        kernels = phase_kernels()
        launches = phase_slice()
        phase_cpu_agreement()
        phase_cli()
        eval_launches = phase_eval()
        perception_launches, pretrained = phase_perception()
        host_launches, single_launches, in_process = phase_host_env()
        host_eval_launches, proc_launches = phase_host_eval(in_process)
        zoo_launches = phase_zoo()
        msgpack_launches, parallel = phase_utilities_and_mesh(pretrained)
        options_launches = phase_options()
        carla_launches, nocrash_launches = phase_carla()
        deep_launches = phase_deep(pretrained["data_dir"])
    except PhaseError as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        return 1
    for name, entry in kernels.items():
        entry["launches"] = launches[name]
        entry["launches_eval"] = eval_launches[name]
        entry["launches_perception"] = perception_launches[name]
        entry["launches_host"] = host_launches[name]
        entry["launches_host_single"] = single_launches[name]
        entry["launches_host_eval"] = host_eval_launches[name]
        entry["launches_host_proc"] = proc_launches[name]
        entry["launches_zoo"] = zoo_launches[name]
        entry["launches_msgpack_eval"] = msgpack_launches[name]
        entry["launches_options"] = options_launches[name]
        entry["launches_carla"] = carla_launches[name]
        entry["launches_nocrash"] = nocrash_launches[name]
        entry["launches_deep"] = {"15a": deep_launches[0][name],
                                  "15d": deep_launches[1][name],
                                  "15g": deep_launches[2][name]}
        entry["launches_parallel"] = {
            "12b": parallel["12b"][name],
            "12c": [rank[name] for rank in parallel["12c"]]}
    # the backward kernel's main path is perception pretraining
    kernels["dual_attention_bwd"]["launches"] = \
        perception_launches["dual_attention_bwd"]
    print(json.dumps({"kernels": list(kernels.values())}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
