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
     host-env trainer's f32 B=8 and B=64 among them), its backward kernel
     at B=48, at phase 5's small head and at every cluster size (C = 32 to
     128), P = 49 and 64 and Cqk = 32, with non-zero gammas, two calls
     bit-equal, and a bf16 call that needs a gradient refused; timings
     against each kernel's bound and, for dual attention and its backward,
     a PyTorch yardstick;
  4. the main path: a bf16 CoPM agent at production width drives 32 device
     envs for a 20-step rollout, then trains one whole iteration at
     production size (T=200, 4 PPO epochs of 2 minibatches) after a T=2
     warm-up iteration, with every kernel's launch count read around each
     of those two runs; a profile of one update;
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
     on (b)'s checkpoint, and an agent built from it giving the trainer's
     latent bit for bit;
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
     back.

It prints one JSON line of kernel figures, the card's name and power limit,
and, last, {"ok": true, "device": {...}}. It exits non-zero, printing no
result, without a CUDA GPU or without the package beside it.

    python3 chip_smoke.py --kernel-times ROOT [ROOT ...]

times the paint, dual-attention and (where a checkout has it) the
dual-attention backward wrappers of each checkout ROOT (a
directory holding `cadre_tpu_torch/`, built there at first use) on the same
inputs, one process per ROOT in the order given, two ways: a CUDA graph of
200 calls, and 200 calls issued one by one. Give the checkouts to compare
as A B B A to see the spread between runs.
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


def phase_card() -> str:
    import torch

    from cadre_tpu_torch.ops import _build

    card = card_line()
    nvcc_v = subprocess.run([_build.nvcc(), "--version"], capture_output=True,
                            text=True, timeout=60).stdout.strip().splitlines()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
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


# (B, C, Cqk) of every call the port makes: the production head at the
# main path's batch (N_ENVS), at B=256, at the eval's B=EVAL_ENVS and at
# the perception trainer's B=PERCEPTION_BATCH, and phase 5's small head
PERCEPTION_BATCH = 48
ATTENTION_SHAPES = ((32, 128, 16), (256, 128, 16), (25, 128, 16),
                    (PERCEPTION_BATCH, 128, 16), (2, 32, 4))
# the host-env trainer's calls (phase 9, f32 encoder): the newest frame of
# each of N_HOST envs on an incremental tick, their 8-frame windows on a
# refresh tick
N_HOST = 8
HOST_ATTENTION_SHAPES = ((N_HOST, 128, 16), (8 * N_HOST, 128, 16))
# the backward kernel's shapes (f32 only): the trainer's and the small
# head's, timed; and (B, C, Cqk, H, W) held to the plain version only: every
# cluster size (C = 32-128), P = 49 (K not a multiple of 8) and P = 64
# (the most the kernel takes), odd Cqk and Cqk = 32
BACKWARD_SHAPES = ((PERCEPTION_BATCH, 128, 16), (2, 32, 4))
BACKWARD_EDGE_SHAPES = ((3, 64, 8, 5, 8), (3, 96, 12, 5, 8),
                        (3, 32, 5, 7, 7), (3, 128, 32, 7, 7),
                        (3, 128, 32, 8, 8), (3, 64, 17, 8, 8))


def check_dual_attention(gen, device):
    import ctypes

    import torch

    from cadre_tpu_torch.ops import _build
    from cadre_tpu_torch.ops import dual_attention as da

    smem_fn = _build.load("dual_attention").dual_attention_smem_bytes
    smem_fn.argtypes = [ctypes.c_int] * 4
    smem_fn.restype = ctypes.c_longlong
    main = None
    for b, c, d in ATTENTION_SHAPES + HOST_ATTENTION_SHAPES:
        host = (b, c, d) in HOST_ATTENTION_SHAPES
        for dtype in (torch.float32,) if host else (torch.float32,
                                                     torch.bfloat16):
            bf16 = dtype == torch.bfloat16
            p = 40
            smem = smem_fn(p, c, d, int(bf16))
            args = _attention_inputs(b, c, d, dtype, gen, device)
            op, oc = da.fused_dual_attention(*args)
            rp = da.pam_apply(*args[:5])
            rc = da.cam_apply(args[5], args[6])
            torch.cuda.synchronize()
            err_p = float((op.float() - rp.float()).abs().max())
            err_c = float((oc.float() - rc.float()).abs().max())
            tag = f"B={b} C={c} Cqk={d} {str(dtype).split('.')[-1]}"
            if not bf16:
                require(err_p <= 2e-4, f"dual_attention {tag}: PAM err "
                        f"{err_p:.3g} > 2e-4")
                require(err_c <= 2e-3, f"dual_attention {tag}: CAM err "
                        f"{err_c:.3g} > 2e-3")
                tol = "f32 atol 2e-4 PAM / 2e-3 CAM"
            else:
                ulps = []
                for out, ref, x in ((op, rp, args[0]), (oc, rc, args[5])):
                    scale = torch.maximum(ref.float().abs(), x.float().abs())
                    ulps.append(float(((out.float() - ref.float()).abs()
                                       / _bf16_ulp(scale)).max()))
                require(max(ulps) <= BF16_ULP_BOUND,
                        f"dual_attention {tag}: {max(ulps)} bf16 ulps > "
                        f"{BF16_ULP_BOUND}")
                tol = (f"bf16 {ulps[0]:.1f}/{ulps[1]:.1f} ulps "
                       f"<= {BF16_ULP_BOUND}")
            ms = device_ms(lambda: da.fused_dual_attention(*args))
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
            print(f"[3] dual_attention {tag}: max|err| PAM {err_p:.3g} CAM "
                  f"{err_c:.3g} ({tol}); kernel {ms:.4f} ms, library "
                  f"{lib_ms:.4f} ms (graphs of 200 calls); issued one by "
                  f"one: kernel {call_ms:.4f} ms, library {lib_call_ms:.4f} "
                  f"ms (200 calls), plain {plain_ms:.4f} ms (20 calls); "
                  f"bound {max(t_bytes, t_ops):.5f} ms "
                  f"({'bytes' if t_bytes >= t_ops else 'operations'}); "
                  f"{smem} B shared memory per block")
            if (b, c, d) == ATTENTION_SHAPES[0] and bf16:
                main = dict(
                    name="dual_attention", route="cuda",
                    source="cadre_tpu_torch/csrc/dual_attention.cu",
                    replaces="cadre_tpu/ops/pallas_dual_attention.py:63 "
                             "(dual_attention_pallas)",
                    max_abs_err=max(err_p, err_c), ms=ms, plain_ms=plain_ms,
                    bound_ms=max(t_bytes, t_ops),
                    bound_by="bytes" if t_bytes >= t_ops else "operations",
                    library_ms=lib_ms, call_ms=call_ms,
                    library_call_ms=lib_call_ms,
                    shapes=f"B={b} P=40 C={c} Cqk={d} bf16")
            elif (b, c, d) in ATTENTION_SHAPES[1:3] and bf16:
                require(main is not None, "dual_attention: B=32 not run")
                main.update({f"ms_b{b}": ms, f"library_ms_b{b}": lib_ms,
                             f"call_ms_b{b}": call_ms,
                             f"library_call_ms_b{b}": lib_call_ms,
                             f"bound_ms_b{b}": max(t_bytes, t_ops)})
            elif host:
                require(main is not None, "dual_attention: B=32 not run")
                main.update({f"ms_b{b}_f32": ms,
                             f"library_ms_b{b}_f32": lib_ms,
                             f"call_ms_b{b}_f32": call_ms,
                             f"library_call_ms_b{b}_f32": lib_call_ms,
                             f"plain_ms_b{b}_f32": plain_ms,
                             f"bound_ms_b{b}_f32": max(t_bytes, t_ops),
                             f"bound_by_b{b}_f32": "bytes" if t_bytes >= t_ops
                             else "operations"})
            elif b == PERCEPTION_BATCH and not bf16:
                require(main is not None, "dual_attention: B=32 not run")
                main.update({"ms_b48_f32": ms, "library_ms_b48_f32": lib_ms,
                             "call_ms_b48_f32": call_ms,
                             "plain_ms_b48_f32": plain_ms,
                             "bound_ms_b48_f32": max(t_bytes, t_ops)})
    return main


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
    symmetric, so it needs one product per pair, c (c + 1) / 2 of them."""
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


def _bwd_lib_fn(name, argtypes, restype):
    import ctypes

    from cadre_tpu_torch.ops import _build

    fn = getattr(_build.load("dual_attention_bwd"), name)
    fn.argtypes = [ctypes.c_int] * argtypes
    fn.restype = restype
    return fn


def check_dual_attention_backward(gen, device):
    """The backward kernel against autograd through the plain versions, at
    every shape of BACKWARD_SHAPES and BACKWARD_EDGE_SHAPES, twice with
    bit-equal outputs; its cluster size, shared memory and active clusters;
    timings at BACKWARD_SHAPES; a bf16 call that needs a gradient must
    raise."""
    import ctypes

    import torch

    from cadre_tpu_torch.ops import dual_attention as da

    smem_fn = _bwd_lib_fn("dual_attention_bwd_smem_bytes", 3,
                          ctypes.c_longlong)
    size_fn = _bwd_lib_fn("dual_attention_bwd_cluster_size", 1, ctypes.c_int)
    active_fn = _bwd_lib_fn("dual_attention_bwd_active_clusters", 3,
                            ctypes.c_int)
    entry = None
    shapes = [(b, c, d, 5, 8) for b, c, d in BACKWARD_SHAPES]
    for b, c, d, h, w in shapes + list(BACKWARD_EDGE_SHAPES):
        p = h * w
        tag = f"B={b} P={p} C={c} Cqk={d} f32"
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
        layout = (f"clusters of {size_fn(c)} CAM blocks and one PAM block "
                  f"per row, {smem_fn(p, c, d)} B shared memory per block, "
                  f"{active} clusters active at once")
        errs = ", ".join(f"{k} {v:.2g}" for k, v in worst.items())
        if (b, c, d) not in BACKWARD_SHAPES:
            print(f"[3] dual_attention_bwd {tag}: max error / scale {errs} "
                  f"(bounds 1e-4 PAM / 1e-3 CAM), two calls bit-equal; "
                  f"{layout}")
            continue
        ms = device_ms(lambda: da.dual_attention_backward(*args))
        call_ms = time_ms(lambda: da.dual_attention_backward(*args), 200)
        plain_ms = time_ms(lambda: da.dual_attention_backward_ref(x, *args),
                           20)
        lib_in = (x, *args[:6])
        lib_both_ms = device_ms(lambda: _library_grads(*lib_in, *args[6:]))
        lib_fwd_ms = device_ms(lambda: _attention_library(*lib_in))
        lib_ms = lib_both_ms - lib_fwd_ms
        nbytes, flops = _backward_work(b, c, d)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / FP32_FLOPS * 1e3
        t_tc = 3 * flops / TF32_TC_FLOPS * 1e3
        print(f"[3] dual_attention_bwd {tag}: max error / scale {errs} "
              f"(bounds 1e-4 PAM / 1e-3 CAM), two calls bit-equal; kernel "
              f"{ms:.4f} ms (graph of 200), {call_ms:.4f} ms issued one by "
              f"one, plain {plain_ms:.4f} ms, library {lib_ms:.4f} ms "
              f"(graphs: autograd forward + backward {lib_both_ms:.4f} less "
              f"forward {lib_fwd_ms:.4f}); bound {max(t_bytes, t_ops):.5f} "
              f"ms ({'bytes' if t_bytes >= t_ops else 'operations'}: "
              f"{nbytes / 1e6:.2f} MB, {flops / 1e9:.3f} GFLOP of f32 FMA at "
              f"67 TFLOP/s); in 3xTF32 on the tensor cores "
              f"{max(t_bytes, t_tc):.5f} ms (3 x {flops / 1e9:.3f} GFLOP at "
              f"495 TFLOP/s {t_tc:.5f} ms, bytes {t_bytes:.5f} ms); "
              f"{layout}")
        if b == PERCEPTION_BATCH:
            entry = dict(
                name="dual_attention_bwd", route="cuda",
                source="cadre_tpu_torch/csrc/dual_attention_bwd.cu",
                replaces="none: XLA autodiff of cadre_tpu/ops/"
                         "dual_attention.py:22-58 (pam_apply, cam_apply)",
                max_abs_err=max(float((g - w_).abs().max())
                                for g, w_ in zip(got, want)),
                max_rel_err=worst, ms=ms, plain_ms=plain_ms,
                bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bound_ms_3xtf32=max(t_bytes, t_tc),
                library_ms=lib_ms, call_ms=call_ms,
                cluster_blocks=size_fn(c), smem_bytes=smem_fn(p, c, d),
                active_clusters=active,
                shapes=f"B={b} P={p} C={c} Cqk={d} f32")
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
    return entry


def phase_kernels():
    import torch

    device = torch.device("cuda")
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    return {"paint": check_paint(gen, device),
            "dual_attention": check_dual_attention(gen, device),
            "dual_attention_bwd": check_dual_attention_backward(gen, device)}


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

    t0 = time.perf_counter()
    (carry, steer, throttle, next_values, m), launches = _counted(
        lambda: rollout(carry))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0

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
          f", checksum {float(m.checksum):.6f}; launches {launches}")

    for b in (N_ENVS, 256):
        reps = -(-b // N_ENVS)
        x = preprocess_obs(carry.obs["rgb"].repeat(reps, 1, 1, 1)[:b],
                           carry.obs["route_fig"].repeat(reps, 1, 1)[:b])
        x = x.to(torch.bfloat16)
        with torch.no_grad():
            ms = time_ms(lambda: agent.encoder.latent(x), 10)
        print(f"[4] encoder bf16 B={b}: {ms:.3f} ms, "
              f"{b / ms * 1e3:.1f} frames/s")

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
    (carry, m), launches = _counted(lambda: iteration(opt, carry))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()

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
          f"{float(m.episodes_done):.0f}; launches {launches}")

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


def update_agreement():
    """One fused PPO update (E=2, M=2) of small f32 banks on the card and
    on the CPU, from the same weights, buffers and permutations: LossAux
    within 1e-5 relative, every updated tensor within 1% of the largest
    change the CPU update made to it."""
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
        init = {s: PolicyBank(4, a, f).state_dict()
                for s, a in (("steer", 33), ("throttle", 3))}
    out = {}
    for dev in ("cpu", "cuda"):
        def tensor(x):
            return torch.as_tensor(x, dtype=torch.int64 if x.dtype.kind
                                   == "i" else torch.float32, device=dev)

        banks = {}
        for s, a in (("steer", 33), ("throttle", 3)):
            banks[s] = PolicyBank(4, a, f).to(dev)
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
    for key, c in p_c.items():
        before = init[key[0]][key[1]]
        change = float((c - before).abs().max())
        require(change > 0, f"update cuda vs cpu: {key} did not move")
        worst = max(worst, float((p_g[key] - c).abs().max()) / change)
    require(worst <= 0.01, f"update cuda vs cpu: a tensor {worst:.3g} of "
            f"its largest change from the CPU's > 0.01")
    print(f"[5] cuda vs cpu, one fused update (f={f}, T={t}, N={n}, E="
          f"{epochs}, M={mbs}): LossAux {aux_err:.3g} relative (bound "
          f"1e-5); parameters at most {worst:.3g} of each tensor's largest "
          f"change (bound 0.01)")


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
    returns the launch counts of the 20 repeated-batch steps."""
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
    return launches


def perception_cpu_agreement(batch):
    """One train step of a small f32 model on the card and on the CPU
    from the same weights, batch (4 frames) and dropout masks, at the
    schedule's peak rate. Losses within 1e-4 relative. Gradients against
    the CPU's own float64 gradient: each tensor on the card within
    max(1e-3 of its scale, 3x the CPU f32 gradient's own distance) (f32
    rounding of this h*w-scaled loss moves some tensors by percents).
    Parameters: within 1% of the largest change on the CPU, at every
    element whose float64 gradient (with weight decay) is ten times above
    that tensor's f32 rounding noise; below it Adam's first step takes the
    rounding's sign."""
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
    runs = {}
    for dev in ("cpu", "cuda", "cpu64"):
        trainer = PerceptionTrainer(cfg, tp, steps_per_epoch=1, seed=4,
                                    device="cuda" if dev == "cuda"
                                    else "cpu")
        trainer.step = 1                    # lr(1) = tp.lr: the peak
        m = type(masks)(*(t.to(trainer.device) for t in masks))
        init = {n: p.detach().cpu().double().clone()
                for n, p in trainer.model.named_parameters()}
        if dev == "cpu64":
            trainer.model.double()
            tb = {k: v.double() if v.is_floating_point() else v
                  for k, v in trainer._to_device(small).items()}
            total, _ = trainer._losses(trainer._apply(tb, m), tb)
            total.backward()
            loss = float(total.detach())
        else:
            loss = trainer.train_step(small, masks=m)["total"]
        named = dict(trainer.model.named_parameters())
        runs[dev] = (loss, init,
                     {n: p.grad.detach().cpu().double() for n, p in
                      named.items()},
                     {n: p.detach().cpu().double() for n, p in named.items()})
    (l_c, init, g_c, p_c), (l_g, _, g_g, p_g), (_, _, g64, _) = (
        runs["cpu"], runs["cuda"], runs["cpu64"])
    rel = abs(l_g - l_c) / abs(l_c)
    require(rel <= 1e-4, f"perception step cuda vs cpu: loss {l_g} vs {l_c}")
    largest = max(float(g.abs().max()) for g in g64.values())
    wd = tp.weight_decay
    worst_g, worst_p, checked = 0.0, 0.0, 0
    for n, exact in g64.items():
        scale = max(float(exact.abs().max()), 1e-6 * largest)
        noise = float((g_c[n] - exact).abs().max())
        err = float((g_g[n] - exact).abs().max())
        bound = max(1e-3 * scale, 3.0 * noise)
        require(err <= bound, f"perception step cuda vs cpu: grad {n} "
                f"{err:.3g} from float64 (cpu f32: {noise:.3g}, scale "
                f"{scale:.3g})")
        worst_g = max(worst_g, err / bound)
        change = float((p_c[n] - init[n]).abs().max())
        require(change > 0 and bool((p_g[n] != init[n]).any()),
                f"perception step: {n} did not move")
        firm = (exact + wd * init[n]).abs() > 10.0 * noise
        checked += int(firm.sum())
        if firm.any():
            d = float((p_g[n] - p_c[n])[firm].abs().max())
            require(d <= 0.01 * change, f"perception step cuda vs cpu: "
                    f"{n} {d:.3g} > 1% of its largest change {change:.3g}")
            worst_p = max(worst_p, d / change)
    total = sum(g.numel() for g in g64.values())
    print(f"[8c] one train step, small f32 model, B=4, cuda vs cpu: loss "
          f"{rel:.3g} relative (bound 1e-4); each gradient's distance from "
          f"the cpu's float64 one at most {worst_g:.3g} of its bound "
          f"(max(1e-3 of its scale, 3x the cpu f32's distance)); "
          f"parameters within {worst_p:.3g} of each "
          f"tensor's largest change at the {checked} of {total} elements "
          f"whose gradient is firm (bound 0.01)")


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
    checkpoint, whose latent must equal the trainer's bit for bit."""
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
        got = agent.encoder.latent(x)
    trainer.model.train()
    torch.cuda.synchronize()
    require(torch.equal(got, want), f"agent latent differs from the "
            f"trainer's by {float((got - want).abs().max()):.3g}")
    print(f"[8e] python -m cadre_tpu_torch.main --env jax --danet-checkpoint "
          f"{os.path.relpath(ckpt, root)} --num-envs {N_ENVS} --num-steps "
          f"{T_STEPS} --iterations 1: exit 0 in {seconds:.1f} s; the agent's "
          f"f32 latent of {x.shape[0]} frames equals the trainer's bit for "
          f"bit")


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
    the `train` episode."""
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
    return launches, single


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


# ------------------------------------------- kernel times of checkouts

def _timing_inputs(device):
    """The inputs both kernels are timed on, by case: paint on the main
    path's fig and rgb tables of one env step at N_ENVS and on random
    tables of the same row counts; dual attention at every shape and type
    of ATTENTION_SHAPES. Made from fixed seeds."""
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
    for b, c, d in ATTENTION_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            tag = f"dual_attention B={b} C={c} {str(dtype).split('.')[-1]}"
            cases[tag] = ("dual_attention",
                          _attention_inputs(b, c, d, dtype, gen, device))
    for b, c, d in BACKWARD_SHAPES:
        cases[f"dual_attention_bwd B={b} C={c} float32"] = (
            "dual_attention_bwd", _backward_inputs(b, c, d, gen, device)[0])
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
        print(f"[t] {case:34s} {figs}")
    def per_step(run, kind, how):
        return sum(run["times"][f"paint {kind} {n}"][how]
                   for n in ("fig", "rgb"))

    for kind in ("main", "random"):
        figs = "  ".join(f"{per_step(r, kind, 'graph_ms'):.4f} / "
                         f"{per_step(r, kind, 'one_by_one_ms'):.4f}"
                         for r in runs)
        print(f"[t] {'paint ' + kind + ' per env step':34s} {figs}")
    print(json.dumps({"runs": runs}))
    return 0


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
    if argv[:1] == ["--kernel-times"] and len(argv) > 1:
        try:
            return compare_kernel_times(argv[1:])
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
        perception_launches = phase_perception()
        host_launches, single_launches = phase_host_env()
    except PhaseError as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        return 1
    for name, entry in kernels.items():
        entry["launches"] = launches[name]
        entry["launches_eval"] = eval_launches[name]
        entry["launches_perception"] = perception_launches[name]
        entry["launches_host"] = host_launches[name]
        entry["launches_host_single"] = single_launches[name]
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
