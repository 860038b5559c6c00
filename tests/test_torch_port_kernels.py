"""The port's kernel modules against the JAX package, on the CPU.

On a CPU tensor `paint_shapes` and `fused_dual_attention` run their plain
versions, which are what the CUDA kernels are held to on the card
(chip_smoke.py). Here those plain versions are held to the JAX functions,
including the Pallas kernels in interpret mode, on the same numpy inputs.
Tolerances: paint bit-exact (the JAX tests assert equality); dual
attention f32 atol 2e-4 (PAM) and 2e-3 (CAM), those of
tests/test_pallas_kernels.py.
"""
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cadre_tpu.ops import dual_attention as jda
from cadre_tpu.ops import paint as jpaint
from cadre_tpu.ops.pallas_dual_attention import dual_attention_pallas
from cadre_tpu_torch.ops import dual_attention as tda
from cadre_tpu_torch.ops import paint as tpaint

REPO = Path(__file__).resolve().parents[1]


def _random_table(seed, s=24, h=144, w=256):
    """Interleaved rect/disk rows, a third masked (test_pallas_kernels)."""
    rng = np.random.RandomState(seed)
    u0 = rng.uniform(-10, w, s)
    rows_r = jpaint.rect_rows(u0, u0 + rng.uniform(0, 40, s),
                              rng.uniform(-10, h, s), rng.uniform(0, h + 10, s),
                              rng.uniform(0, 255, (s, 3)), rng.rand(s) > 0.3)
    rows_d = jpaint.disk_rows(rng.uniform(0, w, s), rng.uniform(0, h, s),
                              rng.uniform(1, 300, s), rng.uniform(0, 255, (s, 3)),
                              rng.rand(s) > 0.3)
    return np.array(jnp.concatenate([rows_r, rows_d]).reshape(2, s, 8)
                      .swapaxes(0, 1).reshape(2 * s, 8))


@pytest.mark.parametrize("channels", [1, 3])
def test_paint_plain_bit_equal_to_jax(channels):
    table = _random_table(1)
    base = np.full((144, 256, channels), 11.0, np.float32)
    xla = np.asarray(jpaint._paint_xla(jnp.asarray(base), jnp.asarray(table)))
    pallas = np.asarray(jpaint._paint_pallas(
        jnp.asarray(base), jnp.asarray(table), interpret=True))
    ours = tpaint.paint_shapes(torch.from_numpy(base)[None],
                               torch.from_numpy(table)[None])[0].numpy()
    assert (ours == xla).all() and (ours == pallas).all()
    assert (ours != 11.0).sum() > 0


def test_paint_plain_batched_bit_equal_to_jax():
    tables = np.stack([_random_table(i) for i in range(4)])
    base = np.random.RandomState(7).uniform(0, 255, (4, 72, 128, 3)) \
        .astype(np.float32)
    ours = tpaint.paint_shapes(torch.from_numpy(base),
                               torch.from_numpy(tables)).numpy()
    for i in range(4):
        ref = np.asarray(jpaint._paint_xla(jnp.asarray(base[i]),
                                           jnp.asarray(tables[i])))
        assert (ours[i] == ref).all()


def test_paint_rows_match_jax_rows():
    rng = np.random.RandomState(3)
    a, b, c, d = (rng.uniform(0, 100, 10).astype(np.float32) for _ in range(4))
    col = rng.uniform(0, 255, (10, 3)).astype(np.float32)
    valid = rng.rand(10) > 0.5
    t = lambda x: torch.from_numpy(np.asarray(x))  # noqa: E731
    np.testing.assert_array_equal(
        tpaint.rect_rows(t(a), t(b), t(c), t(d), t(col), t(valid)).numpy(),
        np.asarray(jpaint.rect_rows(a, b, c, d, col, valid)))
    np.testing.assert_array_equal(
        tpaint.disk_rows(t(a), t(b), t(c), t(col), t(valid)).numpy(),
        np.asarray(jpaint.disk_rows(a, b, c, col, valid)))


def test_paint_order_last_writer_wins():
    one = torch.ones(1, dtype=torch.bool)
    r1 = tpaint.disk_rows(torch.tensor([64.0]), torch.tensor([36.0]),
                          torch.tensor([900.0]), torch.tensor([10.0] * 3), one)
    r2 = tpaint.disk_rows(torch.tensor([64.0]), torch.tensor([36.0]),
                          torch.tensor([100.0]), torch.tensor([250.0] * 3), one)
    img = tpaint.paint_shapes(torch.zeros(1, 72, 128, 3),
                              torch.cat([r1, r2])[None])[0]
    assert float(img[36, 64, 0]) == 250.0
    assert float(img[36, 64 + 15, 0]) == 10.0


def _attention_inputs(batch):
    rng = np.random.RandomState(batch)
    b, h, w, c = batch, 5, 8, 128
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return (f(b, h, w, c), f(b, h, w, c // 8), f(b, h, w, c // 8),
            f(b, h, w, c), np.full((1,), 0.5, np.float32), f(b, h, w, c),
            np.full((1,), 0.3, np.float32))


@pytest.mark.parametrize("batch", [3, 8])
def test_dual_attention_plain_matches_jax(batch):
    args = _attention_inputs(batch)
    ours_p, ours_c = tda.fused_dual_attention(*map(torch.from_numpy, args))
    jargs = list(map(jnp.asarray, args))
    ref_p = jda.pam_apply(*jargs[:5])
    ref_c = jda.cam_apply(jargs[5], jargs[6])
    np.testing.assert_allclose(ours_p.numpy(), np.asarray(ref_p), atol=2e-4)
    np.testing.assert_allclose(ours_c.numpy(), np.asarray(ref_c), atol=2e-3)
    if batch == 3:     # the Pallas kernel in interpret mode (slow on CPU)
        pal_p, pal_c = dual_attention_pallas(*jargs, interpret=True)
        np.testing.assert_allclose(ours_p.numpy(), np.asarray(pal_p),
                                   atol=2e-4)
        np.testing.assert_allclose(ours_c.numpy(), np.asarray(pal_c),
                                   atol=2e-3)


def test_dual_attention_plain_bf16_matches_jax():
    """bf16 in: both round the attention and the branch output to bf16;
    the sums run in another order, so allow two bf16 steps."""
    args = _attention_inputs(4)
    tb = [torch.from_numpy(a).to(torch.bfloat16) for a in args]
    ours_p, ours_c = tda.fused_dual_attention(*tb)
    jb = [jnp.asarray(a, jnp.bfloat16) for a in args]
    ref_p = np.asarray(jda.pam_apply(*jb[:5]), np.float32)
    ref_c = np.asarray(jda.cam_apply(jb[5], jb[6]), np.float32)
    for ours, ref in ((ours_p, ref_p), (ours_c, ref_c)):
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(ref), 1e-30))) - 7)
        err = np.abs(ours.float().numpy() - ref)
        assert (err <= 2 * ulp + 1e-6).mean() > 0.999


def test_cuda_entry_points_raise_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the CUDA path runs instead")
    from cadre_tpu_torch.configs.danet_config import danet_params
    from cadre_tpu_torch.envs.torch_env import DrivingEnv, make_route_bank
    from cadre_tpu_torch.rl.agent import CadreAgent
    from cadre_tpu_torch.utils.device import resolve_device

    small = danet_params(da_feature_channel=32, inter_att_dims=24, z_dims=16)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        CadreAgent.create(small)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        make_route_bank(2, seed=0)
    bank = make_route_bank(2, seed=0, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        DrivingEnv(bank, 2)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        resolve_device("cuda:0")


def test_port_imports_no_jax():
    """Every module of the port and chip_smoke.py, imported in a fresh
    process, pull in neither JAX nor the JAX package."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import cadre_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, "
        "'cadre_tpu_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'cadre_tpu')]\n"
        "assert len(names) >= 15, names\n"
        "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
