"""The port's data-parallel training against the JAX package's 2-device
mesh, on the CPU.

The port's ranks are gloo processes spawned over a FileStore in the
test's tmp_path (`parallel.dryrun.run_ranks`, every group with a
timeout); their work is in tests/torch_port_ranks.py. The JAX side runs
cadre_tpu's functions on `make_mesh(2)` of the conftest's virtual CPU
devices. Every input is made with numpy from a seed and handed to both.
World-1 cases run in this process over a one-rank FileStore group.
Tolerances are stated per test.
"""
import concurrent.futures
import os
import subprocess
import sys

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from cadre_tpu.configs.agent_config import RolloutConfig as JaxRolloutConfig
from cadre_tpu.configs.danet_config import PerceptionTrainParams as JaxTP
from cadre_tpu.configs.danet_config import danet_params as jax_danet_params
from cadre_tpu.models.danet import DANet as JaxDANet
from cadre_tpu.models.danet import create_danet
from cadre_tpu.parallel import mesh as jmesh
from cadre_tpu.parallel import perception_step as jps
from cadre_tpu.parallel import train_step as jts
from cadre_tpu.rl import fused_update as jfu
from cadre_tpu.rl import ppo as jppo
from cadre_tpu_torch.configs.danet_config import danet_params
from cadre_tpu_torch.parallel import multihost
from cadre_tpu_torch.parallel.dryrun import dryrun_multigpu, run_ranks
from cadre_tpu_torch.parallel.mesh import close_mesh, make_mesh
from cadre_tpu_torch.utils.convert import danet_from_flax, policy_from_flax
import torch_port_ranks as ranks
from test_torch_port_hostenv import _random_variables
from test_torch_port_perception import _ZERO_GRADIENT, jax_dropout
from test_torch_port_slice import few_torch_threads  # noqa: F401 (autouse)
from test_torch_port_update import (
    F,
    N,
    OUTPUTS,
    SEQ,
    T,
    _bank_weights,
    _buffer_arrays,
    _jax_buffer,
    _jax_perms,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the DANet of the perception step: the CLI's small widths at 64x96
PERCEPTION = dict(da_feature_channel=64, inter_att_dims=48, z_dims=32,
                  image_height=64, image_width=96, feat_h=2, feat_w=3)
B_PERCEPTION = 4                     # global frames per step: 2 per rank


def _minibatch(seed, n_out, rows=8):
    rng = np.random.RandomState(seed)
    return dict(
        obs_seq=rng.standard_normal((SEQ, rows, F)).astype(np.float32),
        action=rng.randint(0, n_out, rows),
        old_value=(0.1 * rng.standard_normal(rows)).astype(np.float32),
        returns=rng.standard_normal(rows).astype(np.float32),
        mask=(rng.rand(rows) > 0.2).astype(np.float32),
        old_log_prob=(-np.abs(rng.standard_normal(rows)) - 0.5).astype(
            np.float32),
        advantage=rng.standard_normal(rows).astype(np.float32),
        hidden=(0.5 * rng.standard_normal((rows, F)).astype(np.float32),
                0.5 * rng.standard_normal((rows, F)).astype(np.float32)),
        command=rng.randint(0, 4, rows))


def _jax_mb(a):
    from cadre_tpu.rl.rollout import Minibatch

    return Minibatch(**{k: (tuple(jnp.asarray(x) for x in v)
                            if k == "hidden" else jnp.asarray(v))
                        for k, v in a.items()})


def _fused_inputs():
    arrays = {s: _buffer_arrays(50 + i, a)
              for i, (s, a) in enumerate(OUTPUTS.items())}
    nv = np.random.RandomState(6).standard_normal((2, N)).astype(np.float32)
    return arrays, nv


def _shard_perms(key, epochs, mini_batch_num, world=2):
    """The per-device row permutations of JAX's sharded fused update:
    device d folds its index into the key (fused_update.py:59-60)."""
    return [tuple(p.numpy() for p in _jax_perms(
        jax.random.fold_in(key, d), epochs, T * N // world, mini_batch_num))
        for d in range(world)]


def _bn_inputs():
    rng = np.random.RandomState(11)
    return (rng.standard_normal((4, 3, 5, 6)) * 2.0 + 1.0,
            rng.uniform(0.5, 1.5, 3), 0.1 * rng.standard_normal(3),
            rng.standard_normal((4, 3, 5, 6)))


@pytest.fixture(scope="module")
def perception_inputs():
    jcfg = jax_danet_params(**PERCEPTION)
    vnp = _random_variables(
        lambda: create_danet(jcfg, jax.random.PRNGKey(0), train=True)[1],
        np.random.RandomState(12))
    rng = np.random.RandomState(13)
    b, h, w = B_PERCEPTION, 64, 96
    batches = []
    for _ in range(2):
        rgb = rng.uniform(0, 1, (b, h, w, 3))
        route = (rng.rand(b, h, w, 1) > 0.8).astype(np.float64)
        batches.append({
            "x": np.concatenate([rgb, route], -1), "camera_rgb": rgb,
            "camera_seg": rng.randint(0, 8, (b, h, w)).astype(np.int32),
            "route_fig": route, "speed": rng.uniform(0, 8, (b, 1)),
            "target_speed": rng.uniform(0, 8, b),
            "steer": rng.uniform(-1, 1, b), "throttle": rng.uniform(0, 1, b),
            "command": rng.randint(0, 4, b).astype(np.int32),
            "light_state": rng.randint(0, 4, b).astype(np.int32),
            "light_dist": rng.uniform(0, 30, b)})
    z = PERCEPTION["z_dims"]
    half = b // 2
    masks = [rng.rand(half, 1, 1, 128) < 0.9, rng.rand(half, z, z) < 0.9,
             rng.rand(half, z, z) < 0.9]
    weights = (rng.uniform(0.1, 1, 8).astype(np.float32),
               rng.uniform(0.1, 1, 4).astype(np.float32))
    return jcfg, vnp, batches, masks, weights


@pytest.fixture(scope="module")
def two_ranks(perception_inputs, tmp_path_factory):
    """(every two-rank case's results, in one spawned group of two gloo
    ranks; the JAX references), the references computed while the ranks
    run."""
    _, pnp = _bank_weights()
    arrays, nv = _fused_inputs()
    mbs = (_minibatch(1, OUTPUTS["steer"]), _minibatch(2, OUTPUTS["throttle"]))
    _, vnp, batches, masks, weights = perception_inputs
    inputs = dict(
        distributed_update=(pnp, OUTPUTS, F, mbs),
        sharded_fused=(pnp, OUTPUTS, F, arrays, nv, 1, 1, None),
        sharded_fused_perms=(pnp, OUTPUTS, F, arrays, nv, 2, 2,
                             _shard_perms(jax.random.PRNGKey(4), 2, 2)),
        batch_norm=_bn_inputs(),
        perception_steps=(PERCEPTION, vnp, batches, masks, weights),
        train_loops=(5,),
        mesh_refusal=())
    store = str(tmp_path_factory.mktemp("ranks"))
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        future = pool.submit(run_ranks, ranks.cases, 2, (inputs,),
                             store_dir=store)
        refs = dict(distributed_update=_jax_distributed_update(mbs),
                    sharded_fused=_jax_sharded_fused(1, 1,
                                                     jax.random.PRNGKey(4)),
                    sharded_fused_perms=_jax_sharded_fused(
                        2, 2, jax.random.PRNGKey(4)),
                    batch_norm=_jax_batch_norm(),
                    perception_steps=_jax_perception_steps(
                        perception_inputs))
        return future.result(), refs


def _assert_state_close(ours, ref, rtol, atol):
    for s in ours:
        for k, v in ours[s].items():
            np.testing.assert_allclose(v, ref[s][k], rtol=rtol, atol=atol,
                                       err_msg=f"{s} {k}")


def _jax_state(params):
    return {s: {k: v.numpy() for k, v in policy_from_flax(
        jax.tree.map(np.asarray, params[s])).items()} for s in params}


def _ranks_equal(results, case):
    a, b = (r[case]["state"] for r in results)
    for s in a:
        for k in a[s]:
            np.testing.assert_array_equal(a[s][k], b[s][k], err_msg=k)


# ------------------------------------------------------- the PPO updates

def _jax_distributed_update(mbs):
    defs, pnp = _bank_weights()
    mesh = jmesh.make_mesh(2)
    cfg = jppo.PPOConfig()
    params = jax.tree.map(jnp.asarray, pnp)
    return jts.make_distributed_update(
        defs["steer"], defs["throttle"], cfg, mesh)(
        params, jppo.make_optimizer(cfg).init(params),
        *(jts.shard_minibatch(mesh, _jax_mb(m)) for m in mbs))


def test_distributed_update_matches_jax(two_ranks):
    """make_distributed_update (gradients SUMMED over the ranks, then
    clipped and Adam-stepped) on each rank's half of an 8-row minibatch,
    against the JAX version on the same shards of make_mesh(2): every
    parameter within rtol 2e-4 / atol 1e-5 (tests/test_parallel.py's
    tolerance), the losses too, and equal on both ranks."""
    results, refs = two_ranks
    ref_params, _, ref_aux = refs["distributed_update"]
    _ranks_equal(results, "distributed_update")
    got = results[0]["distributed_update"]
    _assert_state_close(got["state"], _jax_state(ref_params), 2e-4, 1e-5)
    np.testing.assert_allclose(got["aux"], [float(x) for x in ref_aux],
                               rtol=2e-4, atol=1e-5)


def _jax_sharded_fused(epochs, mini_batch_num, key):
    defs, pnp = _bank_weights()
    arrays, nv = _fused_inputs()
    from jax.sharding import NamedSharding, PartitionSpec as P

    mesh = jmesh.make_mesh(2)
    cfg = jppo.PPOConfig(ppo_epoch=epochs, num_steps=T, seq_length=SEQ)
    rcfg = JaxRolloutConfig(num_steps=T, mini_batch_num=mini_batch_num,
                            seq_length=SEQ, feature_dims=F)
    params = jax.tree.map(jnp.asarray, pnp)
    repl = NamedSharding(mesh, P())

    def put_buf(tree):
        return jax.tree.map(lambda x: jax.device_put(
            x, NamedSharding(mesh, P(None, "data"))
            if getattr(x, "ndim", 0) >= 2 else repl), tree)

    fn = jfu.make_fused_iteration_update(defs["steer"], defs["throttle"],
                                         cfg, rcfg, mesh=mesh)
    return fn(jax.device_put(params, repl),
              jax.device_put(jppo.make_optimizer(cfg).init(params), repl),
              put_buf(_jax_buffer(arrays["steer"])),
              put_buf(_jax_buffer(arrays["throttle"])),
              tuple(jax.device_put(jnp.asarray(v),
                                   NamedSharding(mesh, P("data")))
                    for v in nv),
              jax.device_put(key, repl))


def test_sharded_fused_update_one_minibatch_matches_jax(two_ranks):
    """The sharded fused update at one minibatch per epoch, E=1, each rank
    on its 2 of 4 envs with its own permutation (order-free at one
    minibatch): against JAX's sharded update on make_mesh(2), the identity
    of tests/test_fused_update.py:69-117 (rtol 2e-4, atol 2e-5); equal on
    both ranks."""
    results, refs = two_ranks
    ref_params, _, ref_aux = refs["sharded_fused"]
    _ranks_equal(results, "sharded_fused")
    got = results[0]["sharded_fused"]
    _assert_state_close(got["state"], _jax_state(ref_params), 2e-4, 2e-5)
    np.testing.assert_allclose(got["aux"], [float(x) for x in ref_aux],
                               rtol=2e-4, atol=2e-5)


def test_sharded_fused_update_with_shard_permutations_matches_jax(two_ranks):
    """E=2, M=2: each rank given the row permutations JAX's device draws
    from the key with its index folded in; global advantage moments,
    gradients MEAN-reduced per minibatch step. Losses within 1e-4
    relative, every tensor within 1% of the largest change JAX made to
    it; equal on both ranks."""
    results, refs = two_ranks
    ref_params, _, ref_aux = refs["sharded_fused_perms"]
    _ranks_equal(results, "sharded_fused_perms")
    got = results[0]["sharded_fused_perms"]
    np.testing.assert_allclose(got["aux"], [float(x) for x in ref_aux],
                               rtol=1e-4)
    _, pnp = _bank_weights()
    ref = _jax_state(ref_params)
    for s in got["state"]:
        before = policy_from_flax(pnp[s])
        for k, v in got["state"][s].items():
            change = float(np.abs(ref[s][k] - before[k].numpy()).max())
            assert change > 0, (s, k)
            assert float(np.abs(v - ref[s][k]).max()) <= 0.01 * change, \
                (s, k)


# ------------------------------------------------------- BatchNorm, DANet

def _jax_batch_norm():
    """flax's cross-replica BatchNorm on make_mesh(2), float64: (y NCHW,
    the updated batch_stats)."""
    x, w, b, _ = _bn_inputs()
    mesh = jmesh.make_mesh(2)
    from jax.sharding import PartitionSpec as P

    bn = nn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5,
                      axis_name="data")
    with jax.enable_x64(True):
        variables = {"params": {"scale": jnp.asarray(w),
                                "bias": jnp.asarray(b)},
                     "batch_stats": {"mean": jnp.zeros(3),
                                     "var": jnp.ones(3)}}

        def apply(v, xs):
            y, upd = bn.apply(v, xs, mutable=["batch_stats"])
            return y, upd["batch_stats"]

        y, stats = jax.jit(jax.shard_map(
            apply, mesh=mesh, in_specs=(P(), P("data")),
            out_specs=(P("data"), P()), check_vma=False))(
            variables, jnp.asarray(x.transpose(0, 2, 3, 1)))
        return (np.asarray(y).transpose(0, 3, 1, 2),
                jax.tree.map(np.asarray, stats))


def test_cross_replica_batch_norm_matches_flax(two_ranks):
    """The cross-replica BatchNorm2d of each rank's 2 of 4 rows in
    float64: outputs and running statistics equal flax's
    nn.BatchNorm(axis_name='data') under shard_map (1e-12 of scale), and
    the input, weight and bias gradients of sum(y * g) equal autograd of
    the whole batch on one process (the weight's and bias's summed over
    the ranks)."""
    results, refs = two_ranks
    y, stats = refs["batch_norm"]
    whole = ranks.batch_norm(None, *_bn_inputs())
    for r, res in enumerate(results):
        got = res["batch_norm"]
        rows = slice(2 * r, 2 * r + 2)
        np.testing.assert_allclose(got["y"], y[rows], rtol=0,
                                   atol=1e-12 * np.abs(y).max())
        np.testing.assert_allclose(got["mean"], stats["mean"], rtol=1e-12)
        np.testing.assert_allclose(got["var"], stats["var"], rtol=1e-12)
        np.testing.assert_allclose(got["dx"], whole["dx"][rows], rtol=0,
                                   atol=1e-12 * np.abs(whole["dx"]).max())
    for k in ("dweight", "dbias"):
        np.testing.assert_allclose(
            sum(res["batch_norm"][k] for res in results), whole[k],
            rtol=1e-12)


def _jax_perception_steps(perception_inputs):
    """Two steps of JAX's make_distributed_perception_trainer on
    make_mesh(2) in float64 (its init replaced by the variables, its
    dropout draws by the masks): each step's losses and the final
    variables as a port state_dict."""
    jcfg, vnp, batches, masks, weights = perception_inputs
    f64 = jax.tree.map(lambda a: np.asarray(a, np.float64)
                       if np.asarray(a).dtype == np.float32 else a, vnp)
    mesh = jmesh.make_mesh(2)
    with pytest.MonkeyPatch.context() as mp, jax.enable_x64(True), \
            jax_dropout(mp, masks):
        variables = jax.tree.map(jnp.asarray, f64)
        mp.setattr(jps, "create_danet",
                   lambda cfg, rng, train=False, axis_name=None: (
                       JaxDANet(params_cfg=cfg, axis_name=axis_name),
                       variables))
        state, update, shard = jps.make_distributed_perception_trainer(
            jcfg, JaxTP(max_epochs=2), 2, jax.random.PRNGKey(0), mesh,
            seg_class_weight=weights[0], light_class_weight=weights[1])
        losses = []
        for step, batch in enumerate(batches):
            state, out = update(state, shard(batch), jax.random.PRNGKey(step))
            losses.append({k: float(v) for k, v in out.items()})
        final = danet_from_flax(
            {"params": jax.tree.map(np.asarray, state["params"]),
             "batch_stats": jax.tree.map(np.asarray, state["batch_stats"])},
            danet_params(**PERCEPTION))
    return losses, final


def test_distributed_perception_steps_match_jax(two_ranks, perception_inputs):
    """Two distributed perception steps of a small DANet (64x96) in
    float64, 2 frames per rank, the same dropout masks on every rank
    (JAX's replicated key): each step's mean-reduced losses within 1e-5
    relative of JAX's make_distributed_perception_trainer on
    make_mesh(2); every parameter and BatchNorm statistic within 1% of
    the largest change JAX made to its tensor (the biases whose gradient
    is zero in exact arithmetic within twice it), equal on both ranks."""
    results, refs = two_ranks
    want, final = refs["perception_steps"]
    init = danet_from_flax(perception_inputs[1], danet_params(**PERCEPTION))
    a, b = (r["perception_steps"] for r in results)
    for k in a["state"]:
        np.testing.assert_array_equal(a["state"][k], b["state"][k],
                                      err_msg=k)
    for step, (got, ref) in enumerate(zip(a["losses"], want)):
        assert set(got) == set(ref)
        for k in ref:
            np.testing.assert_allclose(got[k], ref[k], rtol=1e-5,
                                       err_msg=f"step {step} {k}")
    moved = 0
    for k, got in a["state"].items():
        ref = final[k].double().numpy()
        change = float(np.abs(ref - init[k].double().numpy()).max())
        bound = 2.0 if k in _ZERO_GRADIENT else 0.01
        assert float(np.abs(got - ref).max()) <= bound * change, k
        moved += change > 0
    assert moved == len(a["state"])


# ------------------------------------------------------- the loops, mesh

def test_two_rank_train_vec_keeps_equal_banks(two_ranks):
    """One train_vec iteration on two fake envs per rank, rank 1 starting
    from other banks: the broadcast and the summed gradients leave the
    banks bit-equal on both ranks, and the loss finite."""
    a, b = (r["train_loops"] for r in two_ranks[0])
    np.testing.assert_array_equal(a["banks"], b["banks"])
    assert np.isfinite(a["value_loss"])


def test_make_mesh_refuses_more_ranks_than_the_world(two_ranks):
    assert all("requested 4 devices, have 2 ranks" in r["mesh_refusal"]
               for r in two_ranks[0])


def test_dryrun_multigpu_runs():
    """The twin of dryrun_multichip on two ranks: the distributed update,
    a perception step and a device iteration, each finite, the banks
    equal on both ranks."""
    out = dryrun_multigpu(2)
    assert len(out) == 2


def test_initialize_multihost_is_a_no_op_alone(monkeypatch):
    for name in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(name, raising=False)
    assert not dist.is_initialized()
    assert multihost.initialize_multihost(device="cpu") is False
    assert not dist.is_initialized()
    assert multihost.is_chief()


# ------------------------------------------------------- world size 1

@pytest.fixture
def world_of_one(monkeypatch):
    for name in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(name, raising=False)
    mesh = make_mesh(device="cpu")
    yield mesh
    close_mesh()
    assert not dist.is_initialized()


def test_world_of_one_equals_the_plain_paths(world_of_one,
                                             perception_inputs):
    """At world size 1 (`make_mesh` alone: a one-rank FileStore group)
    every reduction is the identity: the distributed update, the sharded
    fused update with injected permutations and two distributed
    perception steps (float64, whose trainer keeps the plain BatchNorm)
    equal the plain paths exactly; the cross-replica BatchNorm, forced
    on, equals the plain one within 1e-12 of scale (E[x^2] - E[x]^2
    rounds otherwise)."""
    mesh = world_of_one
    assert (mesh.rank, mesh.world) == (0, 1)
    _, pnp = _bank_weights()
    mbs = (_minibatch(1, OUTPUTS["steer"]), _minibatch(2, OUTPUTS["throttle"]))
    got = ranks.distributed_update(mesh, pnp, OUTPUTS, F, mbs)
    want = ranks.plain_update(pnp, OUTPUTS, F, mbs)
    assert got["aux"] == want["aux"]
    _assert_state_close(got["state"], want["state"], 0, 0)

    arrays, nv = _fused_inputs()
    perms = _shard_perms(jax.random.PRNGKey(4), 2, 2, world=1)
    got = ranks.sharded_fused(mesh, pnp, OUTPUTS, F, arrays, nv, 2, 2, perms)
    want = ranks.plain_fused(pnp, OUTPUTS, F, arrays, nv, 2, 2, perms[0])
    assert got["aux"] == want["aux"]
    _assert_state_close(got["state"], want["state"], 0, 0)

    bn_in = _bn_inputs()
    got, want = ranks.batch_norm(mesh, *bn_in), ranks.batch_norm(None, *bn_in)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0,
                                   atol=1e-12 * np.abs(want[k]).max())

    _, vnp, batches, masks, weights = perception_inputs
    whole = [m.repeat(2, axis=0) for m in masks]      # 4 frames on 1 rank
    got = ranks.perception_steps(mesh, PERCEPTION, vnp, batches, whole,
                                 weights)
    want = ranks.perception_steps(None, PERCEPTION, vnp, batches, whole,
                                  weights)
    assert got["losses"] == want["losses"]
    for k, w in want["state"].items():
        np.testing.assert_array_equal(got["state"][k], w, err_msg=k)


# ------------------------------------------------------- the CLIs

def _shards(out, n_shards=2, frames=8, seed=0):
    """Tiny shards in the loader's .npz format."""
    rng = np.random.RandomState(seed)
    os.makedirs(out, exist_ok=True)
    for i in range(n_shards):
        np.savez_compressed(
            os.path.join(out, f"shard_{i:05d}.npz"),
            camera_rgb=rng.randint(0, 256, (frames, 144, 256, 3), np.uint8),
            camera_seg=rng.randint(0, 8, (frames, 144, 256)).astype(np.uint8),
            route_fig=(rng.rand(frames, 256, 144) > 0.9).astype(np.uint8)
            * 255, speed=rng.uniform(0, 8, frames),
            target_speed=np.full(frames, 7.0),
            steer=rng.uniform(-0.5, 0.5, frames),
            throttle=rng.uniform(0, 1, frames),
            command=rng.randint(0, 4, frames),
            light_state=rng.randint(0, 4, frames),
            light_dist=rng.uniform(-1, 30, frames))
    return out


def test_cli_mesh_under_torchrun(tmp_path):
    """`main --mesh data` under `torchrun --standalone --nproc-per-node
    2` (gloo on the CPU): two ranks of one fake env each train one
    iteration; rank 0 alone logs the save and writes the snapshot."""
    work = tmp_path / "wd"
    env = dict(os.environ, OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "cadre_tpu_torch.main", "--mesh",
         "data", "--env", "fake", "--num-envs", "2", "--num-steps", "3",
         "--iterations", "1", "--small", "--device", "cpu", "--work-dir",
         str(work)], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=240)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.count("saved ") == 1, out.stdout
    assert os.path.exists(work / "models" / "ppo_model_0.pt")


def test_cli_mesh_world_of_one_in_process(tmp_path):
    """`main --env jax --mesh data` and `train_perception --mesh` alone
    (a world of 1) in this process: each trains, writes its checkpoint
    and leaves no process group behind; --batch-size must divide by the
    world."""
    from cadre_tpu_torch import main, train_perception

    path = main.main(["--env", "jax", "--mesh", "data", "--num-envs", "2",
                      "--num-steps", "3", "--iterations", "1", "--small",
                      "--device", "cpu", "--work-dir", str(tmp_path / "j")])
    assert os.path.exists(path) and not dist.is_initialized()
    data = _shards(str(tmp_path / "shards"))
    ckpt = train_perception.main([
        "--data-dir", data, "--mesh", "--mesh-devices", "1", "--small",
        "--device", "cpu", "--epochs", "1", "--batch-size", "4",
        "--holdout", "--work-dir", str(tmp_path / "p")])
    assert os.path.exists(ckpt) and not dist.is_initialized()
    assert torch.load(ckpt, weights_only=True)["config"]["model_name"] == \
        "danet"
