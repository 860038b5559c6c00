"""Traffic of CoPM pretraining (stage 1): `PerceptionTrainer.train_step(
batch, sync=False)` fed through `DevicePrefetcher`, as
`PerceptionTrainer.solve` drives it, on synthetic frames and targets in
the packed format the port's loader yields.

The pool of distinct batches is made on the device from the seed and
kept in host memory; the feed cycles through it. Set-up builds the
trainer on the benchmark's weights and runs its first steps through the
same feed and call, keeping the optimizer's first moments after step 1
and the weights after step 3: the warm-up, and the run the reference
follows. The window issues steps until its seconds have passed, records
a CUDA event on the trainer's stream after each (no sync), and ends at a
sync; the losses are read once, at its end.

The reference (`check`) redoes those first steps from the same weights
and batches: the forward in train mode with the dropout keep masks drawn
as the trainer draws them (from a generator seeded as its own), the
loss, the gradients by autograd and Adam with L2 decay on the same
learning-rate schedule (reference/danet.py, reference/banks.Adam)."""
from __future__ import annotations

import math
import threading
import time
from typing import Dict, List

import numpy as np
import torch

from portbench.core import kernels, roofline, window
from portbench.core.hooks import Patches
from portbench.core.weights import make_weights, shapes_of
from portbench.reference.banks import Adam
from portbench.reference.danet import KEEP, Net, inputs, total_loss
from portbench.reference.precision import Rounding, exact_f32


def seeds(seed: int) -> Dict[str, int]:
    s = np.random.SeedSequence(seed).generate_state(4)
    return dict(program=int(s[0]) % (2 ** 31), weights=int(s[1]),
                data=int(s[2]))


def make_pool(n_batches: int, b: int, h: int, w: int, classes: int,
              lights: int, seed: int, device) -> List[Dict[str, np.ndarray]]:
    """Distinct packed batches (rgb_u8, route_u8, camera_seg and the f32
    and i32 labels), drawn on the device, kept on the host."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    n = n_batches * b

    def ints(hi, shape, dtype):
        return torch.randint(0, hi, shape, generator=g, device=device,
                             dtype=dtype)

    def unif(lo, hi, shape):
        return lo + (hi - lo) * torch.rand(shape, generator=g, device=device)

    cols = {
        "rgb_u8": ints(256, (n, h, w, 3), torch.uint8),
        "route_u8": ints(256, (n, w, h), torch.uint8),
        "camera_seg": ints(classes, (n, h, w), torch.uint8),
        "dis": unif(-3.0, 3.0, (n,)), "theta": unif(-1.0, 1.0, (n,)),
        "speed": unif(0.0, 10.0, (n, 1)),
        "target_speed": unif(0.0, 10.0, (n,)),
        "steer": unif(-1.0, 1.0, (n,)), "throttle": unif(0.0, 1.0, (n,)),
        "command": ints(4, (n,), torch.int32),
        "light_state": ints(lights, (n,), torch.int32),
        "light_dist": unif(0.0, 50.0, (n,)),
    }
    host = {k: v.cpu().numpy() for k, v in cols.items()}
    return [{k: v[i * b:(i + 1) * b] for k, v in host.items()}
            for i in range(n_batches)]


def inverse_frequency(counts: np.ndarray) -> np.ndarray:
    """The loader's class weights: total / count, scaled to a max of 1."""
    total = counts.sum()
    w = np.where(counts > 0, total / np.maximum(counts, 1), 0.0)
    return (w / max(w.max(), 1e-9)).astype(np.float32)


def warmup_cosine(step: int, lr: float, warmup: int, decay: int) -> float:
    """optax.warmup_cosine_decay_schedule(0, lr, warmup, decay, 0)."""
    if step < warmup:
        return lr * step / warmup
    t = min(step - warmup, decay - warmup)
    return lr * 0.5 * (1.0 + math.cos(math.pi * t / (decay - warmup)))


class Feed:
    """The pool, cycled until stopped."""

    def __init__(self, pool):
        self.pool = pool
        self.stop = threading.Event()

    def __iter__(self):
        i = 0
        while not self.stop.is_set():
            yield self.pool[i % len(self.pool)]
            i += 1


class Run:
    def __init__(self, ctx):
        self.ctx = ctx
        self.cfg, self.tr = ctx.config, ctx.traffic
        self.dev = torch.device(ctx.device)
        self.seeds = seeds(ctx.seed)

    def sync(self):
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def setup(self, parts: Dict[str, float]) -> None:
        clock = time.perf_counter
        t = clock()
        from cadre_tpu_torch.configs.danet_config import (
            PerceptionTrainParams, danet_params)
        from cadre_tpu_torch.models.danet import DANet
        from cadre_tpu_torch.perception.trainer import PerceptionTrainer
        from cadre_tpu_torch.rl.pipeline import DevicePrefetcher
        parts["imports"] = clock() - t
        t = clock()
        if self.dev.type == "cuda":
            from cadre_tpu_torch.ops import _build
            _build.build()
        parts["kernels"] = clock() - t

        t = clock()
        tr, s, dev, sizes = self.tr, self.seeds, self.dev, self.ctx.sizes
        cfg = danet_params(**self.cfg["danet"])
        self.ctx.check_sizes(cfg)
        with torch.device("meta"):
            skeleton = DANet(cfg)
        self.w0 = make_weights(shapes_of(skeleton), s["weights"], dev)
        b = tr["batch_size"]
        self.pool = make_pool(tr["pool_batches"], b, sizes["image_height"],
                              sizes["image_width"],
                              sizes["camera_output_channel"],
                              sizes["light_classes_num"], s["data"], dev)
        seg = np.bincount(np.concatenate(
            [p["camera_seg"].ravel() for p in self.pool]),
            minlength=sizes["camera_output_channel"])
        light = np.bincount(np.concatenate(
            [p["light_state"] for p in self.pool]).astype(np.int64),
            minlength=sizes["light_classes_num"])
        self.seg_w, self.light_w = inverse_frequency(seg), \
            inverse_frequency(light)
        self.tp = PerceptionTrainParams(**tr["train"])
        self.sync()
        parts["weights_and_data"] = clock() - t

        t = clock()
        # built on the device: the weights are the benchmark's in any case
        with torch.device(dev):
            trainer = PerceptionTrainer(
                cfg, self.tp, steps_per_epoch=tr["pool_batches"],
                seed=s["program"], seg_class_weight=self.seg_w,
                light_class_weight=self.light_w, device=dev,
                state_dict=self.w0)
        self.feed = Feed(self.pool)
        self.prefetch = DevicePrefetcher(self.feed, dev)
        first: List[Dict[str, torch.Tensor]] = []
        self.out1: Dict[str, torch.Tensor] = {}

        def keep_outputs(module, args, out):
            # step 1's forward outputs, on the host, out of the peak
            self.out1 = {k: v.detach().to("cpu", copy=True)
                         for k, v in out.items()}

        hook = trainer.model.register_forward_hook(keep_outputs)
        for i, batch in enumerate(self.prefetch):
            first.append(trainer.train_step(batch, sync=False))
            if i == 0:
                hook.remove()
                self.g1 = self._first_grads(trainer)
            if i == tr["check_steps"] - 1:
                break
        # the snapshots wait on the host, out of the window's memory peak
        self.after = {k: v.detach().to("cpu", copy=True) for k, v in
                      trainer.model.named_parameters()}
        self.w0 = {k: v.cpu() for k, v in self.w0.items()}
        self.first_losses = torch.stack([l["total"] for l in first]) \
            .double().cpu()
        parts["warmup"] = clock() - t
        self.trainer = trainer

    def _first_grads(self, trainer) -> Dict[str, torch.Tensor]:
        """The gradient the optimizer took at step 1 (decay included),
        from its first moment: m_1 = (1 - beta1) g_1."""
        beta1 = self.tp.betas[0]
        out = {}
        for name, p in trainer.model.named_parameters():
            m = trainer.opt.state.get(p, {}).get("exp_avg")
            out[name] = torch.zeros_like(p) if m is None else \
                m.detach() / (1.0 - beta1)
        return {k: v.cpu() for k, v in out.items()}

    # ------------------------------------------------------------- window

    def window(self, seconds: float, tracer) -> Dict[str, float]:
        trainer, b = self.trainer, self.tr["batch_size"]
        cuda = self.dev.type == "cuda"
        self.calls: Dict[str, List[tuple]] = {}
        patches = Patches()
        trace_at = (self.tr["trace_after"],
                    self.tr["trace_after"] + self.tr["trace_steps"])
        marks, losses = [], []

        def mark():
            if cuda:
                e = torch.cuda.Event(enable_timing=True)
                e.record()
                marks.append(e)
            else:
                marks.append(time.perf_counter())

        self.sync()
        t0 = time.perf_counter()
        mark()
        steps = 0
        part = None
        traced_marks = None
        for batch in self.prefetch:
            if tracer.on and steps == trace_at[0] and tracer.summary is None:
                kernels.install(patches, self.calls)
                part = tracer.part(self.sync)
                part.__enter__()
                traced_marks = (len(marks) - 1, None)
            losses.append(trainer.train_step(batch, sync=False)["total"])
            mark()
            steps += 1
            if part is not None and steps == trace_at[1]:
                part.__exit__(None, None, None)
                patches.undo()
                part = None
                traced_marks = (traced_marks[0], len(marks) - 1)
            if time.perf_counter() - t0 >= seconds and part is None:
                break
        self.sync()
        t1 = time.perf_counter()
        self.stop_feed()
        float(torch.stack(losses).sum())        # the losses, read once
        if cuda:
            ms = [a.elapsed_time(b_) for a, b_ in zip(marks, marks[1:])]
        else:
            ms = [1e3 * d for d in window.intervals(marks)]
        if traced_marks is not None:
            lo, hi = traced_marks
            plain = ms[:lo] + ms[hi:]
        else:
            plain = ms
        self.step_ms, self.plain_ms = ms, plain
        self.traced_steps = self.tr["trace_steps"] if traced_marks else 0
        return {"pretrain_frames_per_s": window.rate(steps * b, t1 - t0),
                "pretrain_step_ms_p95": window.percentile(ms, 95.0),
                "_window_s": t1 - t0, "_attempted": steps}

    def stop_feed(self) -> None:
        """End the feeding thread: stop the pool and take what it put."""
        self.feed.stop.set()
        for _ in self.prefetch:
            pass

    def observations(self, tracer) -> dict:
        sizes, b = self.ctx.sizes, self.tr["batch_size"]
        return dict(kind="pretrain", trace=tracer.summary, calls=self.calls,
                    step_ms=self.plain_ms, traced_steps=self.traced_steps,
                    flops_per_step=roofline.pretrain_step_flops(sizes, b))

    def release(self) -> None:
        del self.trainer, self.prefetch
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    # ----------------------------------------------------------- checking

    def simulate(self, step: str) -> dict:
        """The first steps computed by the reference at a precision step."""
        tr, sizes, dev = self.tr, self.ctx.sizes, self.dev
        self.w0 = {k: v.to(dev) for k, v in self.w0.items()}
        r = Rounding(step)
        params = {k: v.clone().requires_grad_(True) for k, v in
                  self.w0.items() if k in self.after}
        names = list(params)
        flat = [params[k] for k in names]
        tp = self.tp
        opt = Adam(flat, lr=tp.lr, betas=tuple(tp.betas), eps=1e-8,
                   weight_decay=tp.weight_decay)
        gen = torch.Generator(device=dev)
        gen.manual_seed(self.seeds["program"])
        seg_w = torch.as_tensor(self.seg_w, device=dev)
        light_w = torch.as_tensor(self.light_w, device=dev)
        head = sizes["backbone_channels"] // 4
        z = sizes["z_dims"]
        warmup = max(1, tp.warmup_epochs * tr["pool_batches"])
        decay = max(warmup + 1, tp.max_epochs * tr["pool_batches"])
        losses, grad1, pure1, out1 = [], None, None, None
        for i in range(tr["check_steps"]):
            raw = {k: torch.as_tensor(v, device=dev)
                   for k, v in self.pool[i % len(self.pool)].items()}
            b = raw["rgb_u8"].shape[0]
            masks = tuple(torch.rand(*shape, generator=gen, device=dev) < KEEP
                          for shape in ((b, head), (b, z, z), (b, z, z)))
            x, route = inputs(raw["rgb_u8"], raw["route_u8"])
            batch = dict(raw, route_fig=route)
            w = dict(self.w0, **params)
            with torch.enable_grad():
                out = Net(w, sizes, r, train=True).forward(
                    x, raw["speed"], masks)
                loss = total_loss(out, batch, seg_w, light_w,
                                  tp.w_light_state)
                grads = torch.autograd.grad(loss, flat, allow_unused=True)
            grads = [torch.zeros_like(p) if g is None else g
                     for p, g in zip(flat, grads)]
            lr = warmup_cosine(i, tp.lr, warmup, decay)
            seen = opt.step([p.data for p in flat], grads, lr=lr)
            if i == 0:
                grad1 = dict(zip(names, seen))
                pure1 = dict(zip(names, grads))
                out1 = {k: v.detach() for k, v in out.items()}
            losses.append(float(loss.detach()))
        return dict(losses=torch.tensor(losses, dtype=torch.float64),
                    grad1=grad1, pure1=pure1, out1=out1,
                    after={k: params[k].detach() for k in names})

    def program_outputs(self) -> dict:
        dev = self.dev
        return dict(losses=self.first_losses,
                    out1={k: v.to(dev) for k, v in self.out1.items()},
                    grad1={k: v.to(dev) for k, v in self.g1.items()},
                    after={k: v.to(dev) for k, v in self.after.items()})

    def compare(self, got: dict, ref: dict) -> Dict[str, float]:
        """The numbers that decide `correct`:
        output: step 1's forward outputs (seg logits, route, light-state
          logits, steer, throttle), the widest relative RMS gap of one of
          them (1 where the program's has other rows);
        loss: the widest relative gap of the first steps' losses;
        grad: the worst leaf's gap of the norm of the step-1 gradient as
          the optimizer took it, over the larger of its own and the
          median leaf's reference norm;
        change: the same of each leaf's change over the first steps.
        Leaves whose step-1 reference gradient (decay left out) is under
        a thousandth of the median leaf's are left out of both."""
        loss = float(((got["losses"] - ref["losses"]).abs()
                      / ref["losses"].abs()).max())
        pure = {k: float(v.norm()) for k, v in ref["pure1"].items()}
        med = float(np.median([v for v in pure.values() if v > 0]))
        kept = [k for k, v in pure.items() if v >= 1e-3 * med]

        def worst(get, ref_norms):
            med_r = float(np.median([ref_norms[k] for k in kept]))
            return max(abs(get(k) - ref_norms[k]) / max(ref_norms[k], med_r)
                       for k in kept)

        g_ref = {k: float(ref["grad1"][k].norm()) for k in kept}
        grad = worst(lambda k: float(got["grad1"][k].norm()), g_ref)
        d_ref = {k: float((ref["after"][k] - self.w0[k]).norm())
                 for k in kept}
        change = worst(lambda k: float((got["after"][k] - self.w0[k])
                                       .norm()), d_ref)
        output = max(
            float((got["out1"][k].float() - v).norm() / v.norm())
            if got["out1"][k].shape == v.shape else 1.0
            for k, v in ref["out1"].items())
        return dict(output=output, loss=loss, grad=grad, change=change)

    def check(self, control: bool = False) -> Dict[str, float]:
        step = self.ctx.config["control_steps"]["trainer"] if control \
            else None
        with exact_f32():
            ref = self.simulate("f32")
            got = self.simulate(step) if control else self.program_outputs()
        return self.compare(got, ref)


def _breakdown(self, summary) -> dict:
    return {"device_ops": summary.top_device_ops(["k2", "k3"], rest="step"),
            "idle_gaps": summary.idle_gaps()}


Run.breakdown = _breakdown
