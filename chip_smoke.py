#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (cadre_tpu_torch) on one NVIDIA GPU and check it.

Usage, from the root of the checkout, on a machine with a CUDA GPU and nvcc:

    python3 chip_smoke.py

Phases, each of which must pass:
  1. the card, its power limit, and the torch / CUDA / nvcc versions;
  2. build of every hand-written kernel from cadre_tpu_torch/csrc/;
  3. each kernel against its plain PyTorch version on the card, at the
     shapes of the main path, with timings against its bound;
  4. the main path: a bf16 CoPM agent at production width drives 32 device
     envs for a 20-step rollout, with every kernel's launch count read
     around that one run;
  5. the CUDA path against the CPU path of the same port on a small input.

It prints one JSON line of kernel figures, the card's name and power limit,
and, last, {"ok": true, "device": {...}}. It exits non-zero, printing no
result, without a CUDA GPU or without the package beside it.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

# H100 SXM peaks (NVIDIA data sheet, dense): bytes/s of HBM3, FLOP/s of
# fp32 outside the tensor cores and of bf16 in the tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
BF16_TC_FLOPS = 989e12

N_ENVS = 32
T_STEPS = 20
# bf16 kernel vs plain: both round the same f32 sums, in another order, so
# an attention weight or the residual may land one bf16 step apart; bound
# the difference in bf16 units in the last place of max(|plain|, |x|).
BF16_ULP_BOUND = 4.0


class PhaseError(RuntimeError):
    pass


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseError(msg)


def time_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device milliseconds of `fn()` over `iters` calls (CUDA events)."""
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


def _paint_ops(table, h, w):
    """fp32 operations of one paint call: 6 per (pixel, disk row), 4 per
    (pixel, rect row)."""
    disks = float((table[..., 0] > 0.5).sum())
    rects = float(table.shape[0] * table.shape[1]) - disks
    return h * w * (6.0 * disks + 4.0 * rects)


def check_paint(gen, device):
    import torch

    from cadre_tpu_torch.ops import paint

    cases = {
        # route figure 256 x 144 x 1 from 103 disk rows of the ribbon width
        "fig": (256, 144, 1, 0, 103, 56.25),
        # camera 144 x 256 x 3 from 108 rect rows and 32 disk rows
        "rgb": (144, 256, 3, 108, 32, None),
    }
    fig = {}
    for name, (h, w, c, n_rect, n_disk, r2) in cases.items():
        base = 255.0 * torch.rand(N_ENVS, h, w, c, generator=gen,
                                  device=device)
        table = _paint_tables(N_ENVS, h, w, n_rect, n_disk, r2, gen, device)
        out = paint.paint_shapes(base, table)
        ref = paint.paint_shapes_ref(base, table)
        torch.cuda.synchronize()
        changed = int((ref != base).any(-1).sum())
        diff = int((out != ref).sum())
        require(changed > 0, f"paint {name}: the tables painted nothing")
        require(diff == 0, f"paint {name}: {diff} values differ from plain")
        ms = time_ms(lambda: paint.paint_shapes(base, table), 50)
        plain_ms = time_ms(lambda: paint.paint_shapes_ref(base, table), 3, 1)
        nbytes = 2 * base.numel() * 4 + table.numel() * 4
        ops = _paint_ops(table, h, w)
        fig[name] = dict(ms=ms, plain_ms=plain_ms, bytes=nbytes, ops=ops,
                         err=float((out - ref).abs().max()))
        print(f"[3] paint {name}: N={N_ENVS} {h}x{w}x{c}, "
              f"{table.shape[1]} rows: bit-equal to plain ({changed} px "
              f"painted); kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, "
              f"{nbytes / 1e6:.2f} MB, {ops / 1e9:.3f} GFLOP")
    nbytes = sum(f["bytes"] for f in fig.values())
    ops = sum(f["ops"] for f in fig.values())
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_FLOPS * 1e3
    return dict(
        name="paint", route="cuda", source="cadre_tpu_torch/csrc/paint.cu",
        replaces="cadre_tpu/ops/paint.py:111 (_paint_pallas)",
        max_abs_err=max(f["err"] for f in fig.values()),
        ms=sum(f["ms"] for f in fig.values()),
        plain_ms=sum(f["plain_ms"] for f in fig.values()),
        bound_ms=max(t_bytes, t_ops),
        bound_by="bytes" if t_bytes >= t_ops else "operations",
        library_ms=None,
        shapes=f"one env step at N={N_ENVS}: fig 256x144x1 (103 rows) + "
               f"rgb 144x256x3 (140 rows)")


def _attention_inputs(b, dtype, gen, device):
    import torch

    h, w, c, d = 5, 8, 128, 16

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


def check_dual_attention(gen, device):
    import torch

    from cadre_tpu_torch.ops import dual_attention as da

    main = None
    for b in (32, 256):
        for dtype in (torch.float32, torch.bfloat16):
            args = _attention_inputs(b, dtype, gen, device)
            op, oc = da.fused_dual_attention(*args)
            rp = da.pam_apply(*args[:5])
            rc = da.cam_apply(args[5], args[6])
            torch.cuda.synchronize()
            err_p = float((op.float() - rp.float()).abs().max())
            err_c = float((oc.float() - rc.float()).abs().max())
            tag = f"B={b} {str(dtype).split('.')[-1]}"
            if dtype == torch.float32:
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
            ms = time_ms(lambda: da.fused_dual_attention(*args), 50)
            plain_ms = time_ms(lambda: (da.pam_apply(*args[:5]),
                                        da.cam_apply(args[5], args[6])), 20)
            lib_ms = time_ms(lambda: _attention_library(*args), 20)
            p, c, d = 40, 128, 16
            elem = 2 if dtype == torch.bfloat16 else 4
            nbytes = b * (5 * p * c + 2 * p * d) * elem + 8
            flops = b * 2.0 * (p * p * d + p * p * c + 2 * p * c * c)
            peak = BF16_TC_FLOPS if dtype == torch.bfloat16 else FP32_FLOPS
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = flops / peak * 1e3
            print(f"[3] dual_attention {tag}: max|err| PAM {err_p:.3g} CAM "
                  f"{err_c:.3g} ({tol}); kernel {ms:.4f} ms, plain "
                  f"{plain_ms:.4f} ms, library {lib_ms:.4f} ms, bound "
                  f"{max(t_bytes, t_ops):.5f} ms")
            if b == 32 and dtype == torch.bfloat16:
                main = dict(
                    name="dual_attention", route="cuda",
                    source="cadre_tpu_torch/csrc/dual_attention.cu",
                    replaces="cadre_tpu/ops/pallas_dual_attention.py:63 "
                             "(dual_attention_pallas)",
                    max_abs_err=max(err_p, err_c), ms=ms, plain_ms=plain_ms,
                    bound_ms=max(t_bytes, t_ops),
                    bound_by="bytes" if t_bytes >= t_ops else "operations",
                    library_ms=lib_ms,
                    shapes=f"B={b} P=40 C=128 Cqk=16 bf16")
    return main


def phase_kernels():
    import torch

    device = torch.device("cuda")
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    return {"paint": check_paint(gen, device),
            "dual_attention": check_dual_attention(gen, device)}


# ---------------------------------------------------------------- phase 4

def _finite(name, t):
    import torch

    require(bool(torch.isfinite(t.float()).all()), f"{name} is not finite")


def phase_slice():
    """The main path at production width; returns the launch counts of
    the one counted rollout."""
    import torch

    from cadre_tpu_torch.configs.agent_config import RolloutConfig
    from cadre_tpu_torch.configs.danet_config import danet_params
    from cadre_tpu_torch.envs.torch_env import DrivingEnv, make_route_bank
    from cadre_tpu_torch.ops import dual_attention, paint
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

    paint.launches = 0
    dual_attention.launches = 0
    t0 = time.perf_counter()
    carry, steer, throttle, next_values, m = rollout(carry)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {"paint": paint.launches,
                "dual_attention": dual_attention.launches}

    require(launches["paint"] >= 2 * T_STEPS,
            f"paint launched {launches['paint']} < {2 * T_STEPS} times")
    require(launches["dual_attention"] >= T_STEPS + 1,
            f"dual_attention launched {launches['dual_attention']} < "
            f"{T_STEPS + 1} times")
    f = agent.obs_dim
    require(tuple(steer.obs.shape) == (T_STEPS + 1, N_ENVS, 8, f),
            f"steer buffer obs {tuple(steer.obs.shape)}")
    for sig, buf in (("steer", steer), ("throttle", throttle)):
        for name, t in buf._asdict().items():
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
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        carry = short(carry)[0]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # device-side events only (kernels, copies): the aten ops that launch
    # them carry the same time again
    cuda = torch.autograd.DeviceType.CUDA
    rows = [e for e in prof.key_averages() if e.device_type == cuda]
    busy_us = sum(e.self_device_time_total for e in rows)
    kernels = sum(e.count for e in rows)
    print(f"[4] profile of {prof_steps} steps: wall {wall * 1e3:.1f} ms, "
          f"device busy {busy_us / 1e3:.1f} ms "
          f"({100.0 * (1 - busy_us / 1e6 / wall):.1f}% idle), "
          f"{kernels} device ops, {kernels / prof_steps:.0f} per step")
    rows.sort(key=lambda e: -e.self_device_time_total)
    for e in rows[:12]:
        print(f"[4]   {e.self_device_time_total / 1e3:9.3f} ms "
              f"{e.count:6d}x {e.key[:80]}")
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
        return StepDraws(ResetDraws(*(t.to(gpu) for t in d.reset)),
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


# ---------------------------------------------------------------- main

def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA GPU", file=sys.stderr)
        return 2
    try:
        import cadre_tpu_torch  # noqa: F401
    except ImportError as exc:
        print(f"chip_smoke: the port is not beside this script: {exc}",
              file=sys.stderr)
        return 2
    try:
        card = phase_card()
        phase_build()
        kernels = phase_kernels()
        launches = phase_slice()
        phase_cpu_agreement()
    except PhaseError as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        return 1
    for name, entry in kernels.items():
        entry["launches"] = launches[name]
    print(json.dumps({"kernels": list(kernels.values())}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
