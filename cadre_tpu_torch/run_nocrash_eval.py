"""The reference's NoCrash eval protocol on the device env of the port:
`python -m cadre_tpu_torch.run_nocrash_eval`.

The JAX package's scripts/run_nocrash_eval.py. Protocol
(config_files/eval_agent_config.py:51-84, eval.py:12-64):
  - train on the four NoCrash Town01 train-route XMLs (`--train-routes`)
    with background traffic, through the device iteration
    (`rl.device_rollout.make_device_iteration`: render, encode, act, step
    and the fused PPO update on the device), a snapshot every
    `--snap-every` iterations (`snap_<N>.pt` in --workdir, the port's
    format; `--warm-start` resumes from the newest one);
  - evaluate an ensemble of the last K snapshots (`--eval-members`) over
    the eval route XMLs of each town (`--eval-routes TOWN=XML`), one
    episode per route (the sequential RouteIndexer protocol), once per
    NoCrash traffic tier (`--tiers`), with `rl.device_eval`;
  - write eval_completion_ratio_<town>_<tier>.csv per town and tier and
    one JSON artifact (`--out`) with the JAX script's keys.

The XML routes are traced over the approximate town road grids
(envs/town_maps.py), so that they turn at the towns' junctions. Traffic is
spawned along the route: the tiers' town-wide amounts are mapped to
on-route density at the JAX script's calibration. The route XMLs are the
reference's (`nocrash_route/` of its checkout, relative to the working
directory by default); `town_maps.write_lane_routes` writes XMLs of the
same form. It runs on the GPU unless given `--device cpu`; `--small` takes
the small encoder.
"""
from __future__ import annotations

import argparse
import csv
import glob
import json
import os
import re
import time

import numpy as np

REF = "nocrash_route"
TRAIN_XMLS = [
    f"{REF}/Nocrash_follow_lane_turn_route.xml",
    f"{REF}/Nocrash_right_turn_route.xml",
    f"{REF}/Nocrash_left_turn_route.xml",
    f"{REF}/Nocrash_straight_turn_route.xml",
]
EVAL_XMLS = {
    "Town01": f"{REF}/eval_routes/Nocrash_Town01.xml",
    "Town02": f"{REF}/eval_routes/Nocrash_Town02.xml",
}

# NoCrash traffic tiers (Codevilla et al. 2019), town-wide [vehicles,
# walkers]; the reference's one eval config, amount=[20,50]
# (eval_agent_config.py:80), is Town01 "regular". [20,50] town-wide maps to
# 3 vehicles + 6 walkers along a ~400 m route, applied to every tier.
NOCRASH_TIERS = {
    "Town01": {"empty": (0, 0), "regular": (20, 50), "dense": (100, 250)},
    "Town02": {"empty": (0, 0), "regular": (15, 50), "dense": (70, 150)},
}
VEH_ONROUTE_FRAC, WALK_ONROUTE_FRAC = 3 / 20, 6 / 50


def _onroute(amount):
    veh, walk = amount
    return (round(veh * VEH_ONROUTE_FRAC), round(walk * WALK_ONROUTE_FRAC))


def _sha256(path):
    if not path or not os.path.exists(path):
        return None
    import hashlib

    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _git_rev():
    import subprocess

    try:
        return subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"],
            cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
            capture_output=True, text=True, timeout=10,
        ).stdout.strip() or None
    except (OSError, subprocess.SubprocessError):
        return None


def _traced_routes(xmls, map_name: str):
    from cadre_tpu_torch.envs.route_parser import parse_routes_file
    from cadre_tpu_torch.envs.town_maps import town_map, trace_dense_route

    tmap = town_map(map_name)
    dense = []
    for path in xmls:
        for cfg in parse_routes_file(path):
            kp = np.asarray([w.xy for w in cfg.trajectory])
            dense.append(trace_dense_route(tmap, kp))
    return dense


def _eval_routes(pairs):
    """['TOWN=XML', ...] -> {town: xml}, towns of NOCRASH_TIERS only."""
    out = {}
    for pair in pairs:
        town, sep, xml = pair.partition("=")
        if not sep or town not in NOCRASH_TIERS:
            raise ValueError(f"--eval-routes takes TOWN=XML with TOWN one "
                             f"of {sorted(NOCRASH_TIERS)}, not {pair!r}")
        out[town] = xml
    return out


def run(args) -> dict:
    from cadre_tpu_torch.configs.agent_config import (
        RolloutConfig,
        TrainConfig,
    )
    from cadre_tpu_torch.configs.danet_config import danet_params
    from cadre_tpu_torch.envs.torch_env import (
        ERROR_CODES,
        DrivingEnv,
        EnvConfig,
        make_route_bank,
    )
    from cadre_tpu_torch.rl.agent import CadreAgent, Ensemble
    from cadre_tpu_torch.rl.device_eval import evaluate_ensemble
    from cadre_tpu_torch.rl.device_rollout import make_device_iteration

    eval_xmls = _eval_routes(args.eval_routes)
    tiers = [t.strip() for t in args.tiers.split(",") if t.strip()]
    danet_cfg = danet_params() if not args.small else danet_params(
        da_feature_channel=64, inter_att_dims=48, z_dims=32)
    encoder_state = None
    if args.encoder:
        from cadre_tpu_torch.utils.checkpoint import load_danet_checkpoint

        encoder_state = load_danet_checkpoint(args.encoder, danet_cfg)
    agent = CadreAgent.create(danet_cfg, seed=args.seed, bf16_encoder=True,
                              device=args.device,
                              encoder_state=encoder_state)
    dev = agent.device
    out_path = args.out or os.path.join(args.workdir, "nocrash_eval.json")

    os.makedirs(args.workdir, exist_ok=True)
    rows = []
    train_wall = None
    snaps = sorted(glob.glob(os.path.join(args.workdir, "snap_*.pt")))
    if not args.eval_only or not snaps:
        # ---- training on the Town01 train-route XMLs ----
        train_dense = _traced_routes(args.train_routes, "Town01")
        bank = make_route_bank(len(train_dense), seed=args.seed,
                               dense_routes=train_dense, device=dev)
        env_cfg = EnvConfig(n_vehicles=8, n_walkers=0, priority_routes=True)
        env = DrivingEnv(bank, num_envs=args.num_envs, config=env_cfg,
                         device=dev)
        snap_offset = 0
        if args.warm_start and snaps:
            # continuation run: resume the policy from the newest snapshot
            # and number new snapshots on from it, so that the ensemble
            # eval picks up the latest members
            agent.load_snapshot(snaps[-1])
            snap_offset = int(re.search(r"snap_(\d+)",
                                        snaps[-1]).group(1))
            print(f"warm-start from {snaps[-1]} "
                  f"(snap offset {snap_offset})", flush=True)
        iteration, init_carry = make_device_iteration(
            agent, env, RolloutConfig(num_steps=args.steps), TrainConfig(),
            seed=args.seed + 1 + snap_offset)
        carry = init_carry()
        steps_per_iter = args.steps * args.num_envs
        t0 = time.time()
        for i in range(args.iterations):
            ti = time.perf_counter()
            carry, m = iteration(agent.opt, carry)
            float(m.checksum)                   # waits for the device
            dt = time.perf_counter() - ti
            eps = float(m.episodes_done)
            rows.append(dict(
                iteration=i, env_steps=(i + 1) * steps_per_iter,
                env_steps_per_sec=round(steps_per_iter / dt, 1),
                episodes_done=eps,
                mean_completion=round(
                    float(m.completion_sum) / max(eps, 1.0), 4),
                error_hist={ERROR_CODES[c]: int(v) for c, v in
                            enumerate(m.error_hist.cpu().numpy()) if v}))
            if (i + 1) % 25 == 0 or i == 0:
                print(f"iter {i}: {rows[-1]['env_steps_per_sec']:.0f} "
                      f"steps/s, completion "
                      f"{rows[-1]['mean_completion']:.2%}", flush=True)
            if (i + 1) % args.snap_every == 0:
                path = os.path.join(args.workdir,
                                    f"snap_{snap_offset + i + 1:05d}.pt")
                agent.save_snapshot(path)
                snaps.append(path)
        train_wall = time.time() - t0

    # ---- ensemble eval over the NoCrash eval routes, one pass per
    # traffic tier ----
    members = snaps[-args.eval_members:]
    ensemble = Ensemble.load(agent, members)
    towns = {}
    for town, xml in eval_xmls.items():
        eval_bank = make_route_bank(25, seed=args.seed + 1000,
                                    routes_file=xml, map_name=town,
                                    device=dev)
        n_routes = int(eval_bank.route_len.shape[0])
        towns[town] = {}
        for tier in tiers:
            amount = NOCRASH_TIERS[town][tier]
            n_veh, n_walk = _onroute(amount)
            # sequential RouteIndexer protocol: env i pinned to route i,
            # one episode per eval route (route_indexer.py:6-41)
            eval_env = DrivingEnv(
                eval_bank, num_envs=n_routes,
                config=EnvConfig(training=False, n_vehicles=n_veh,
                                 n_walkers=n_walk, priority_routes=False),
                device=dev)
            episodes = evaluate_ensemble(agent, eval_env, ensemble,
                                         max_steps=args.eval_steps,
                                         seed=args.seed + 7,
                                         route_ids=list(range(n_routes)))
            csv_path = os.path.join(
                args.workdir, f"eval_completion_ratio_{town}_{tier}.csv")
            with open(csv_path, "w", newline="") as f:
                w = csv.writer(f)
                for e in episodes:
                    w.writerow([e.get("route_id", ""),
                                round(e["completion"], 4)])

            def mean(k):
                return round(float(np.mean([e[k] for e in episodes])), 4) \
                    if episodes else None

            errs = {}
            for e in episodes:
                errs[e["error"]] = errs.get(e["error"], 0) + 1
            towns[town][tier] = dict(
                routes=n_routes, episodes=len(episodes),
                amount_town_wide=list(amount),
                n_vehicles_onroute=n_veh, n_walkers_onroute=n_walk,
                mean_completion=mean("completion"),
                mean_driving_score=mean("driving_score"),
                errors=errs, rows=episodes, csv=csv_path)
            print(f"{town}/{tier}: completion "
                  f"{towns[town][tier]['mean_completion']}, driving score "
                  f"{towns[town][tier]['mean_driving_score']}, "
                  f"errors {errs}", flush=True)

    artifact = dict(
        experiment=("NoCrash eval protocol on the device env of the port: "
                    "trained on the Town01 train-route XMLs, ensemble of "
                    f"last {len(members)} snapshots over the eval route "
                    "XMLs traced on the approximate town grids"),
        protocol=dict(
            train_routes=list(args.train_routes), eval_routes=eval_xmls,
            ensemble_members=len(members),
            reference=("config_files/eval_agent_config.py:51-84, "
                       "eval.py:12-64"),
            geometry=("2-keypoint XML routes traced over road grids "
                      "clustered from the reference's on-road scenario "
                      "points (envs/town_maps.py)"),
            traffic=dict(
                tiers={t: {k: dict(town_wide=list(v),
                                   onroute=list(_onroute(v)))
                           for k, v in NOCRASH_TIERS[t].items()
                           if k in tiers} for t in eval_xmls},
                note=("NoCrash empty/regular/dense town-wide amounts "
                      "mapped to on-route density ([20,50] -> 3 veh + 6 "
                      "walkers); train [150,0] -> 8 vehicles"))),
        config=dict(iterations=args.iterations, num_envs=args.num_envs,
                    steps=args.steps, encoder=args.encoder,
                    encoder_sha256=_sha256(args.encoder),
                    code_rev=_git_rev(),
                    tiers=tiers,
                    seed=args.seed, warm_start=bool(args.warm_start),
                    total_env_steps=args.iterations * args.steps
                    * args.num_envs),
        train=dict(wall_s=round(train_wall, 1) if train_wall else None,
                   rows=[r for j, r in enumerate(rows)
                         if j % 5 == 4 or j == len(rows) - 1]),
        eval=towns)
    with open(out_path, "w") as f:
        json.dump(artifact, f, indent=1)
    print("WROTE", out_path, flush=True)
    return artifact


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="NoCrash train + ensemble eval on the device env")
    p.add_argument("--iterations", type=int, default=800)
    p.add_argument("--num-envs", type=int, default=32)
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--snap-every", type=int, default=100)
    p.add_argument("--eval-members", type=int, default=8)
    p.add_argument("--eval-steps", type=int, default=8000)
    p.add_argument("--encoder", default=None,
                   help="trained encoder (.pt or .msgpack) to freeze in "
                        "the agent")
    p.add_argument("--eval-only", action="store_true")
    p.add_argument("--tiers", default="empty,regular,dense",
                   help="comma list of NoCrash traffic tiers to evaluate")
    p.add_argument("--warm-start", action="store_true",
                   help="resume training from the newest workdir snapshot "
                        "(continuation runs past the base budget)")
    p.add_argument("--train-routes", nargs="+", default=TRAIN_XMLS,
                   help="Town01 train-route XMLs")
    p.add_argument("--eval-routes", nargs="+",
                   default=[f"{t}={x}" for t, x in EVAL_XMLS.items()],
                   help="TOWN=XML eval routes per town (Town01, Town02)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--workdir", default="result/nocrash")
    p.add_argument("--out", default=None,
                   help="the JSON artifact (default: "
                        "<workdir>/nocrash_eval.json)")
    p.add_argument("--small", action="store_true",
                   help="small encoder (fast CPU runs)")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    return run(parse_args(argv))


if __name__ == "__main__":
    main()
