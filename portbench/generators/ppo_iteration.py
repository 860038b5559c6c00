"""Traffic of the PPO device iteration (stage 2): `make_device_iteration`'s
`iteration(agent.opt, carry)` as `train_device` drives it, on N device
envs for T steps, then the fused update of its N x T rows.

Set-up builds the agent (the benchmark's weights, the encoder in the
configuration's dtype), the route bank and env as `main --env jax` sizes
them, and the iteration, then runs the iteration once through the same
call while recording what its public calls return (the agent's `encode`
and `act_from_hist`, the env's `step`): the warm-up, and the run the
reference follows. The window starts iterations until its seconds have
passed and finishes the one in flight, each timed to the read of its
checksum.

The reference (`check`) follows that first iteration from what the
program's env produced: the canvases K1 painted for a seeded sample of
envs, repainted from K1's own inputs (reference/paint.py); the latent of
the sample at every step from their frames (reference/danet.py), the
feature windows, the banks' log-probs and values of the program's
actions, the bootstrap, GAE and the first minibatch steps of the update
with the program's permutation draw (reference/banks.py); then it
compares (numbers below)."""
from __future__ import annotations

import time
from contextlib import nullcontext
from typing import Dict, List

import numpy as np
import torch

from portbench.core import kernels, roofline, window
from portbench.core.hooks import Patches
from portbench.core.weights import make_weights, shapes_of
from portbench.reference import banks as rb
from portbench.reference import paint as rp
from portbench.reference.danet import Net, inputs
from portbench.reference.precision import Rounding, exact_f32

SIGNALS = ("steer", "throttle")
CHECK_STEPS = 3           # minibatch steps of the first update followed


def optimizer_gradient(opt, agent) -> Dict:
    """The gradient each bank tensor's Adam step took at step 1, from the
    optimizer's state after it: m_1 = (1 - beta1) g_1 (zero where the
    state has none)."""
    beta1 = opt.param_groups[0]["betas"][0]
    out = {}
    for sig in SIGNALS:
        for name, p in getattr(agent, sig).named_parameters():
            m = opt.state.get(p, {}).get("exp_avg")
            out[(sig, name)] = torch.zeros_like(p) if m is None else \
                m.detach() / (1.0 - beta1)
    return out


def seeds(seed: int) -> Dict[str, int]:
    s = np.random.SeedSequence(seed).generate_state(6)
    return dict(program=int(s[0]) % (2 ** 31), encoder=int(s[1]),
                steer=int(s[2]), throttle=int(s[3]), sample=int(s[4]))


class Recorder:
    """What the first iteration's public calls returned."""

    def __init__(self, sample: torch.Tensor):
        self.sample = sample
        self.feats: List[torch.Tensor] = []
        self.frames: List[tuple] = []
        self.paints: List[tuple] = []
        self.acts: List[dict] = []
        self.steps: List[dict] = []
        self.losses: List[torch.Tensor] = []
        self.grad1: Dict = {}
        self.after: Dict = {}

    def install(self, patches: Patches, agent, env) -> None:
        idx = self.sample
        n = env.num_envs

        def encode(fn):
            def wrapped(obs):
                f = fn(obs)
                self.feats.append(f.detach().clone())
                self.frames.append(tuple(obs[k][idx].clone() for k in
                                         ("rgb", "route_fig",
                                          "measurements")))
                return f
            return wrapped

        def act(fn):
            def wrapped(feat_hist, commands, hidden, gs, gt):
                s, t, h = fn(feat_hist, commands, hidden, gs, gt)
                self.acts.append(dict(
                    command=commands.clone(),
                    **{f"{sig}_{k}": getattr(o, k).clone()
                       for sig, o in zip(SIGNALS, (s, t))
                       for k in ("action", "log_prob", "value")}))
                return s, t, h
            return wrapped

        def step(fn):
            def wrapped(state, controls, draws=None):
                state, out = fn(state, controls, draws)
                self.steps.append(dict(
                    reward=out.rewards.clone(),
                    action_done=out.action_done.clone(),
                    done=out.done.clone(), command=out.command.clone()))
                return state, out
            return wrapped

        def paint(fn):
            def wrapped(base, shapes):
                out = fn(base, shapes)
                if base.shape[0] == n:
                    self.paints.append((base[idx], shapes[idx], out[idx]))
                return out
            return wrapped

        def update(fn):
            def wrapped(steer, throttle, opt, s_mb, t_mb, *rest, **kw):
                aux = fn(steer, throttle, opt, s_mb, t_mb, *rest, **kw)
                k = len(self.losses)
                if k < CHECK_STEPS:
                    self.losses.append(torch.stack(list(aux)).detach()
                                       .double().cpu())
                if k == 0:
                    self.grad1 = optimizer_gradient(opt, agent)
                if k == CHECK_STEPS - 1:
                    self.after = {sig: {n: t.detach().clone() for n, t in
                                        getattr(agent, sig)
                                        .state_dict().items()}
                                  for sig in SIGNALS}
                return aux
            return wrapped

        from cadre_tpu_torch.ops import paint as paint_op
        from cadre_tpu_torch.rl import fused_update

        patches.wrap(agent, "encode", encode)
        patches.wrap(agent, "act_from_hist", act)
        patches.wrap(env, "step", step)
        patches.wrap(paint_op, "paint_shapes", paint)
        patches.wrap(fused_update, "update_step", update)


class Run:
    def __init__(self, ctx):
        self.ctx = ctx
        self.cfg, self.tr = ctx.config, ctx.traffic
        self.dev = torch.device(ctx.device)
        self.seeds = seeds(ctx.seed)

    def sync(self):
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    # ------------------------------------------------------------- set-up

    def setup(self, parts: Dict[str, float]) -> None:
        clock = time.perf_counter
        t = clock()
        from cadre_tpu_torch.configs.agent_config import (
            AgentConfig, RolloutConfig, TrainConfig)
        from cadre_tpu_torch.configs.danet_config import danet_params
        from cadre_tpu_torch.envs.torch_env import (
            DrivingEnv, EnvConfig, make_route_bank)
        from cadre_tpu_torch.models.danet import DANet
        from cadre_tpu_torch.rl.agent import CadreAgent
        from cadre_tpu_torch.rl.device_rollout import make_device_iteration
        parts["imports"] = clock() - t
        t = clock()
        if self.dev.type == "cuda":
            from cadre_tpu_torch.ops import _build
            _build.build()
        parts["kernels"] = clock() - t

        t = clock()
        tr, s, dev = self.tr, self.seeds, self.dev
        danet_cfg = danet_params(**self.cfg["danet"])
        self.ctx.check_sizes(danet_cfg)
        with torch.device("meta"):
            encoder = DANet(danet_cfg, latent_only=True)
        self.enc_w = make_weights(shapes_of(encoder), s["encoder"], dev)
        # built on the device: the weights are the benchmark's in any case
        with torch.device(dev):
            agent = CadreAgent.create(
                danet_cfg, AgentConfig(**self.cfg.get("agent", {})),
                seed=s["program"], device=dev, encoder_state=self.enc_w,
                bf16_encoder=self.cfg["encoder_dtype"] == "bfloat16")
        ppo = self.cfg["ppo"]
        for k in ("clip", "clip_coeff", "value_coeff", "ent_coeff", "lr",
                  "max_grad_norm"):
            if getattr(agent.ppo_cfg, k) != ppo[k]:
                raise ValueError(f"the program's PPO {k} is "
                                 f"{getattr(agent.ppo_cfg, k)}, the "
                                 f"configuration's {ppo[k]}")
        self.bank_w = {}
        for sig in SIGNALS:
            bank = getattr(agent, sig)
            self.bank_w[sig] = make_weights(shapes_of(bank), s[sig], dev)
            bank.load_state_dict(self.bank_w[sig])
        self.sync()
        parts["weights"] = clock() - t

        t = clock()
        n = tr["num_envs"]
        bank = make_route_bank(tr["routes_per_env"] * n, seed=s["program"],
                               device=dev)
        env = DrivingEnv(bank, num_envs=n, seed=s["program"],
                         config=EnvConfig(**tr.get("env", {})), device=dev)
        self.sync()
        parts["route_bank"] = clock() - t

        t = clock()
        rollout_cfg = RolloutConfig(num_steps=tr["num_steps"],
                                    seq_length=tr["seq_length"],
                                    mini_batch_num=tr["mini_batch_num"],
                                    feature_dims=agent.obs_dim)
        train_cfg = TrainConfig(ppo_epoch=tr["ppo_epoch"])
        if (rollout_cfg.gamma, rollout_cfg.tau) != (ppo["gamma"], ppo["tau"]):
            raise ValueError("the program's gamma and tau differ from the "
                             "configuration's")
        iteration, init_carry = make_device_iteration(
            agent, env, rollout_cfg, train_cfg, seed=s["program"])
        gen = torch.Generator().manual_seed(s["sample"])
        sample = torch.randperm(n, generator=gen)[:tr["check_envs"]]
        self.rec = Recorder(sample.to(dev))
        patches = Patches()
        self.rec.install(patches, agent, env)
        try:
            carry = init_carry()
            carry, m = iteration(agent.opt, carry)
            float(m.checksum)
        finally:
            patches.undo()
        if len(self.rec.losses) < CHECK_STEPS:
            raise RuntimeError("the first update made fewer than "
                               f"{CHECK_STEPS} minibatch steps through "
                               "rl.fused_update.update_step")
        parts["warmup"] = clock() - t
        self.agent, self.env, self.carry = agent, env, carry
        self.iteration = iteration
        self.obs_dim = agent.obs_dim

    # ------------------------------------------------------------- window

    def window(self, seconds: float, tracer) -> Dict[str, float]:
        its: List[dict] = []
        self.calls: Dict[str, List[tuple]] = {}
        patches = Patches()

        def run_one():
            traced = tracer.on and tracer.summary is None and len(its) == 1
            if traced:
                kernels.install(patches, self.calls)
                kernels.method_ranges(patches, self.agent,
                                      {"encode": "encode",
                                       "act_from_hist": "act"})
                kernels.method_ranges(patches, self.env, {"step": "env"})
            t0 = time.perf_counter()
            try:
                with tracer.part(self.sync) if traced else nullcontext():
                    self.carry, m = self.iteration(self.agent.opt,
                                                   self.carry)
                    float(m.checksum)
            finally:
                patches.undo()
            its.append(dict(seconds=time.perf_counter() - t0,
                            rollout=m.rollout_seconds, traced=traced))

        self.sync()
        count, _, seconds_run = window.whole_iterations(
            run_one, seconds, time.perf_counter)
        tr = self.tr
        steps = count * tr["num_envs"] * tr["num_steps"]
        self.its = its
        return {"ppo_env_steps_per_s": window.rate(steps, seconds_run),
                "_window_s": seconds_run, "_attempted": count}

    def observations(self, tracer) -> dict:
        tr = self.tr
        sizes = self.ctx.sizes
        plain = [i for i in self.its if not i["traced"]] or self.its
        flops = roofline.ppo_iteration_flops(
            sizes, tr["num_envs"], tr["num_steps"], tr["seq_length"],
            self.obs_dim, sizes["policy_hidden"],
            (sizes["steer_outputs"], sizes["throttle_outputs"]),
            tr["ppo_epoch"], tr["mini_batch_num"])
        return dict(kind="ppo", trace=tracer.summary, calls=self.calls,
                    plain_iterations=plain,
                    flops_per_iteration=flops, num_steps=tr["num_steps"])

    def release(self) -> None:
        del self.agent, self.env, self.carry, self.iteration
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    # ----------------------------------------------------------- checking

    def simulate(self, lat_step: str, bank_step: str) -> dict:
        """The first iteration computed by the reference at the given
        precision steps, on the program's env outputs."""
        tr, rec, sizes = self.tr, self.rec, self.ctx.sizes
        n, t_steps, seq = tr["num_envs"], tr["num_steps"], tr["seq_length"]
        banks = sizes["commands"]
        r_bank = Rounding(bank_step)
        net = Net(self.enc_w, sizes, Rounding(lat_step), train=False)
        out = dict(feats=[], painted=[rp.paint(base, table)
                                      for base, table, _ in rec.paints])
        with torch.no_grad():
            for rgb, fig, meas in rec.frames:
                x, _ = inputs(rgb, fig)
                z = net.latent(x)
                out["feats"].append(torch.cat([z, meas.float().repeat(1, 6)],
                                              dim=-1))
            feats = rec.feats
            fh = feats[0][None].expand(seq, n, -1)
            done_prev = torch.zeros(n, dtype=torch.bool, device=self.dev)
            windows = []
            lp = {sig: [] for sig in SIGNALS}
            val = {sig: [] for sig in SIGNALS}
            for t in range(t_steps):
                new = feats[t + 1]
                fh = torch.where(done_prev[None, :, None],
                                 new[None].expand(seq, n, -1),
                                 torch.cat([fh[1:], new[None]], dim=0))
                windows.append(fh)
                cmd = rec.acts[t]["command"]
                for sig in SIGNALS:
                    logits, v = rb.evaluate(self.bank_w[sig], fh, cmd,
                                            r_bank, banks)
                    lp[sig].append(rb.log_prob(
                        logits, rec.acts[t][f"{sig}_action"]))
                    val[sig].append(v)
                done_prev = rec.steps[t]["done"]
            new = feats[t_steps + 1]
            fh = torch.where(done_prev[None, :, None],
                             new[None].expand(seq, n, -1),
                             torch.cat([fh[1:], new[None]], dim=0))
            live = 1.0 - done_prev.float()
            boot = rec.steps[t_steps - 1]["command"]
            next_v = {sig: rb.evaluate(self.bank_w[sig], fh, boot, r_bank,
                                       banks)[1] * live for sig in SIGNALS}
        out["log_prob"] = {s: torch.stack(v) for s, v in lp.items()}
        out["value"] = {s: torch.stack(v) for s, v in val.items()}
        obs = torch.stack(windows)                       # [T, seq, N, F]
        out.update(self._update(obs, out["log_prob"], out["value"], next_v,
                                r_bank, banks))
        return out

    def _update(self, obs, old_lp, old_v, next_v, r, banks) -> dict:
        tr, rec = self.tr, self.rec
        n, t_steps = tr["num_envs"], tr["num_steps"]
        epochs, mbn = tr["ppo_epoch"], tr["mini_batch_num"]
        ppo = self.ctx.config["ppo"]
        rows = n * t_steps
        reward = torch.stack([s["reward"] for s in rec.steps])   # [T, N, 2]
        adone = torch.stack([s["action_done"] for s in rec.steps])
        action = {sig: torch.stack([a[f"{sig}_action"] for a in rec.acts])
                  for sig in SIGNALS}
        command = torch.stack([a["command"] for a in rec.acts])
        data = {}
        for col, sig in enumerate(SIGNALS):
            ret, adv = rb.gae(reward[..., col], old_v[sig],
                              1.0 - adone[..., col].float(), next_v[sig],
                              ppo["gamma"], ppo["tau"])
            data[sig] = dict(returns=ret.reshape(-1),
                             advantage=rb.standardise(adv).reshape(-1),
                             old_log_prob=old_lp[sig].reshape(-1),
                             old_value=old_v[sig].reshape(-1),
                             action=action[sig].reshape(-1),
                             command=command.reshape(-1))
        gen = torch.Generator(device=self.dev)
        gen.manual_seed(int(np.random.SeedSequence(
            [self.seeds["program"], 1]).generate_state(1)[0]))
        eff = min(mbn, rows)
        size = rows // eff
        perms = {sig: torch.stack([torch.randperm(rows, generator=gen,
                                                  device=self.dev)
                                   for _ in range(epochs)]
                                  )[:, :size * eff].reshape(epochs * eff,
                                                            size)
                 for sig in SIGNALS}
        params = {sig: {k: v.clone().requires_grad_(True)
                        for k, v in self.bank_w[sig].items()}
                  for sig in SIGNALS}
        flat = [p for sig in SIGNALS for p in params[sig].values()]
        opt = rb.Adam(flat, lr=ppo["lr"])
        chunk = tr["check_chunk"]
        losses = []
        first_grad = None
        for j in range(CHECK_STEPS):
            grads = [torch.zeros_like(p) for p in flat]
            terms = torch.zeros(3, dtype=torch.float64, device=self.dev)
            for a in range(0, size, chunk):
                parts = []
                for sig in SIGNALS:
                    idx = perms[sig][j, a:a + chunk]
                    t_i, e_i = idx // n, idx % n
                    mb = {k: v[idx] for k, v in data[sig].items()}
                    mb["obs"] = obs[t_i, :, e_i].transpose(0, 1)
                    with torch.enable_grad():
                        parts.append(rb.signal_loss_sum(
                            params[sig], mb, r, banks, ppo["clip"]))
                with torch.enable_grad():
                    vl = (parts[0][0] + parts[1][0]) * ppo["value_coeff"]
                    al = (parts[0][1] + parts[1][1]) * ppo["clip_coeff"]
                    el = (parts[0][2] + parts[1][2]) * ppo["ent_coeff"]
                    loss = (vl + al - el) / size
                    g = torch.autograd.grad(loss, flat, allow_unused=True)
                for acc, gi in zip(grads, g):
                    if gi is not None:
                        acc.add_(gi)
                terms += torch.stack([vl, al, el]).detach().double() / size
            norm = torch.sqrt(sum((g * g).sum() for g in grads))
            if norm >= ppo["max_grad_norm"]:
                grads = [g / norm * ppo["max_grad_norm"] for g in grads]
            if first_grad is None:
                first_grad = [g.clone() for g in grads]
            opt.step([p.data for p in flat], grads)
            losses.append(terms)
        keys = [(sig, k) for sig in SIGNALS for k in params[sig]]
        return dict(losses=torch.stack(losses).cpu(),
                    after={sig: {k: params[sig][k].detach()
                                 for k in params[sig]} for sig in SIGNALS},
                    grad1=dict(zip(keys, first_grad)))

    def program_outputs(self) -> dict:
        rec = self.rec
        idx = rec.sample
        return dict(
            painted=[out for _, _, out in rec.paints],
            feats=[f[idx] for f in rec.feats],
            log_prob={sig: torch.stack([a[f"{sig}_log_prob"]
                                        for a in rec.acts])
                      for sig in SIGNALS},
            value={sig: torch.stack([a[f"{sig}_value"] for a in rec.acts])
                   for sig in SIGNALS},
            losses=torch.stack(rec.losses), grad1=rec.grad1,
            after=rec.after)

    def compare(self, got: dict, ref: dict) -> Dict[str, float]:
        """The numbers that decide `correct`:
        paint: the canvas values (pixels x channels) of the sampled envs,
          over every K1 call of the first iteration, that differ from the
          plain painter's on the same base and table (exact);
        latent: the worst step's relative RMS gap of the sampled envs'
          features (latent ++ measurements) to the reference's;
        logp: the widest gap of a log-prob of a taken action;
        value: the widest gap of a value, over the largest |value|;
        loss: the update's first minibatch step's widest gap of its three
          loss terms (value, policy, entropy), over the sum of their
          magnitudes; `loss_later`, the same of steps 2 and 3, is read
          and not compared (PERF.md: Adam's first step moves each element
          by lr * sign(g), so elements whose gradient is nought to
          rounding move apart and the later losses swing from seed to
          seed);
        grad: the worst bank leaf's gap of the norm of the gradient the
          optimizer took at step 1, over the larger of its own and the
          median leaf's reference norm;
        change: the same of each leaf's change over the 3 steps.
        A leaf is one command's bank of one tensor; leaves whose step-1
        reference gradient is under a thousandth of the median leaf's are
        left out of both."""
        if len(got["painted"]) != len(ref["painted"]) or not ref["painted"]:
            raise RuntimeError("the first iteration made no K1 call at the "
                               "envs' batch")
        paint = sum(int((g != r).sum())
                    for g, r in zip(got["painted"], ref["painted"]))
        latent = max(float((g.float() - r).norm() / r.norm())
                     for g, r in zip(got["feats"], ref["feats"]))
        logp = max(float((got["log_prob"][s] - ref["log_prob"][s]).abs()
                         .max()) for s in SIGNALS)
        value = max(float((got["value"][s] - ref["value"][s]).abs().max()
                          / ref["value"][s].abs().max()) for s in SIGNALS)
        gl, rl = got["losses"].double(), ref["losses"].double()
        step = (gl - rl).abs().amax(1) / rl.abs().sum(1)
        grad, change = leaf_gaps(self.bank_w, got, ref)
        return dict(paint=paint, latent=latent, logp=logp, value=value,
                    loss=float(step[0]), loss_later=float(step[1:].max()),
                    grad=grad, change=change)

    def check(self, control: bool = False) -> Dict[str, float]:
        steps = self.ctx.config["control_steps"] if control else \
            {"encoder": "f32", "banks": "f32"}
        with exact_f32():
            ref = self.simulate("f32", "f32")
            got = self.simulate(steps["encoder"], steps["banks"]) \
                if control else self.program_outputs()
        return self.compare(got, ref)


def leaf_gaps(initial, got, ref):
    """(grad, change): the worst leaf (one command bank of one tensor) of
    |norm(got) - norm(ref)| / max(norm(ref), the median leaf's norm(ref)),
    for the step-1 gradient and for the change from `initial`."""
    rows = []
    for sig in initial:
        for k, w0 in initial[sig].items():
            for b in range(w0.shape[0]):
                g_ref = float(ref["grad1"][(sig, k)][b].norm())
                g_got = float(got["grad1"][(sig, k)][b].norm())
                d_got = float((got["after"][sig][k][b] - w0[b]).norm())
                d_ref = float((ref["after"][sig][k][b] - w0[b]).norm())
                rows.append((g_ref, g_got, d_got, d_ref))
    # a bank whose command no row had has a gradient of exactly 0 and no
    # change on either side; the median is over the leaves that have one
    med_g = float(np.median([r[0] for r in rows if r[0] > 0]))
    kept = [r for r in rows if r[0] >= 1e-3 * med_g]
    med_gk = float(np.median([r[0] for r in kept]))
    med_d = float(np.median([r[3] for r in kept]))
    grad = max(abs(g - gr) / max(gr, med_gk) for gr, g, _, _ in kept)
    change = max(abs(dg - dr) / max(dr, med_d) for _, _, dg, dr in kept)
    return grad, change


def split_time(summary) -> float:
    """Host time that ends the traced iteration's rollout: the end of its
    last latent (the bootstrap's)."""
    return summary.last_end("encode")


def _breakdown(self, summary) -> dict:
    t = split_time(summary)
    return {"device_ops": summary.top_device_ops(
                ["k2", "paint", "encode", "act", "env"],
                after=(t, "update"), rest="rollout"),
            "idle_gaps": summary.idle_gaps()}


Run.breakdown = _breakdown
