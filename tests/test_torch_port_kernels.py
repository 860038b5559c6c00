"""The port's kernel modules against the JAX package, on the CPU.

On a CPU tensor `paint_shapes` and `fused_dual_attention` run their plain
versions, which are what the CUDA kernels are held to on the card
(chip_smoke.py). Here those plain versions are held to the JAX functions,
including the Pallas kernels in interpret mode, on the same numpy inputs.
Tolerances: paint bit-exact (the JAX tests assert equality); dual
attention f32 atol 2e-4 (PAM) and 2e-3 (CAM), those of
tests/test_pallas_kernels.py.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from test_torch_port_slice import few_torch_threads  # noqa: F401 (autouse)
from cadre_tpu.envs import jax_env
from cadre_tpu.ops import dual_attention as jda
from cadre_tpu.ops import paint as jpaint
from cadre_tpu.ops.pallas_dual_attention import dual_attention_pallas
from cadre_tpu_torch.envs import torch_env
from cadre_tpu_torch.ops import _build
from cadre_tpu_torch.ops import dual_attention as tda
from cadre_tpu_torch.ops import paint as tpaint
from cadre_tpu_torch.utils.convert import (
    env_state_from_numpy,
    route_bank_from_numpy,
)

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


EDGE_CASES = ("disk_borders", "rect_borders", "masked", "long")
EDGE_CANVASES = {"fig": (256, 144, 1), "rgb": (144, 256, 3)}


@pytest.mark.parametrize("canvas", list(EDGE_CANVASES))
@pytest.mark.parametrize("case", EDGE_CASES)
def test_paint_plain_bit_equal_to_jax_on_tile_edge_tables(case, canvas):
    """The tables that chip_smoke.py holds the kernel's per-tile cull to
    (edges on tile borders, exact squares, masked rows, a table longer
    than one cull chunk): the plain version equals the JAX scan and the
    interpret-mode Pallas kernel bit for bit."""
    h, w, c = EDGE_CANVASES[canvas]
    tables = chip_smoke.paint_edge_tables(h, w)
    assert set(tables) == set(EDGE_CASES)
    table = tables[case]
    base = np.random.RandomState(1).uniform(0, 255, (h, w, c)) \
        .astype(np.float32)
    xla = np.asarray(jpaint._paint_xla(jnp.asarray(base), jnp.asarray(table)))
    pallas = np.asarray(jpaint._paint_pallas(
        jnp.asarray(base), jnp.asarray(table), interpret=True))
    ours = tpaint.paint_shapes(torch.from_numpy(base)[None],
                               torch.from_numpy(table)[None])[0].numpy()
    assert (ours == xla).all() and (ours == pallas).all()
    assert (ours != base).any()
    if case == "long":
        assert len(table) >= 600


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


def _attention_inputs(batch, c=128):
    rng = np.random.RandomState(batch)
    b, h, w = batch, 5, 8
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


@pytest.mark.parametrize("batch", [2, 5])
def test_dual_attention_plain_matches_jax_small_head(batch):
    """The small head of chip_smoke.py's phase 5 (C=32, Cqk=4)."""
    args = _attention_inputs(batch, c=32)
    assert args[1].shape[-1] == 4
    ours_p, ours_c = tda.fused_dual_attention(*map(torch.from_numpy, args))
    jargs = list(map(jnp.asarray, args))
    np.testing.assert_allclose(ours_p.numpy(),
                               np.asarray(jda.pam_apply(*jargs[:5])),
                               atol=2e-4)
    np.testing.assert_allclose(ours_c.numpy(),
                               np.asarray(jda.cam_apply(jargs[5], jargs[6])),
                               atol=2e-3)


@pytest.mark.parametrize("p, c, d", [(40, 48, 16), (40, 544, 16),
                                     (0, 128, 16), (40, 128, 65),
                                     (40, 16, 2)])
def test_dual_attention_kernel_refuses_shapes_it_does_not_take(p, c, d):
    """The CUDA wrapper raises on such a shape before any launch (C not a
    multiple of 32, C > 512, no positions, Cqk > 64, C < 32; any P >= 1 is
    taken); it never falls back to the plain version."""
    x = torch.zeros(1, 1, p, c)
    qk = torch.zeros(1, 1, p, d)
    g = torch.ones(1)
    with pytest.raises(ValueError, match="the kernel takes"):
        tda._dual_attention_cuda(x, qk, qk, x, g, x, g)


def test_dual_attention_gamma_passes_through_or_converts():
    """A gamma already of the input type and device goes to the kernel as
    it is (no copy per call); any other is converted to one such value."""
    g = torch.tensor([0.5])
    assert tda._gamma(g, torch.float32, g.device) is g
    scalar = torch.tensor(0.25, dtype=torch.float64)
    out = tda._gamma(scalar, torch.bfloat16, g.device)
    assert out.dtype == torch.bfloat16 and tuple(out.shape) == (1,)
    assert float(out) == 0.25


def test_paint_kernel_refuses_what_it_does_not_take():
    base = torch.zeros(1, 8, 8, 4)
    with pytest.raises(ValueError, match="channels"):
        tpaint._paint_cuda(base, torch.zeros(1, 2, 8))
    with pytest.raises(ValueError, match="rows"):
        tpaint._paint_cuda(base[..., :3],
                           torch.zeros(1, tpaint.MAX_ROWS + 1, 8))
    # the kernel keeps the table (32 B a row) and 32 B of counters in the
    # 48 KB of shared memory a block has without opting in
    assert 32 * tpaint.MAX_ROWS + 32 <= 48 * 1024 < 32 * tpaint.MAX_ROWS + 64


def test_paint_edge_tables_follow_the_kernels_tile(tmp_path, monkeypatch):
    """The tile whose borders chip_smoke.py's edge tables aim at is read
    from csrc/paint.cu: change kTileW / kTileH there and the disks move to
    the new borders."""
    tw, th = tpaint.kernel_tile()
    assert tw > 0 and th > 0
    text = (_build.CSRC / "paint.cu").read_text()
    (tmp_path / "paint.cu").write_text(
        text.replace(f"kTileW = {tw};", "kTileW = 24;")
        .replace(f"kTileH = {th};", "kTileH = 6;"))
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    tpaint.kernel_tile.cache_clear()
    try:
        assert tpaint.kernel_tile() == (24, 6)
        h, w = 144, 256
        disks = chip_smoke.paint_edge_tables(h, w)["disk_borders"]
    finally:
        monkeypatch.undo()
        tpaint.kernel_tile.cache_clear()
    for centre, tile, edge in ((disks[:, 1], 24, w), (disks[:, 2], 6, h)):
        border = np.round(centre)
        off = np.minimum(border % tile, tile - border % tile)
        assert ((off <= 1) | (np.abs(border - edge) <= 1)).all()
        assert (np.abs(border % (2 * tile) - tile) <= 1).any()
    assert tpaint.kernel_tile() == (tw, th)


def test_build_hash_follows_sources_headers_and_flags(tmp_path):
    """A library is named after what it is built from: the hash moves with
    the text of its .cu, of any .cuh and with the flags, and not with
    another .cu or a file's times."""
    (tmp_path / "a.cu").write_text("kernel a")
    (tmp_path / "b.cu").write_text("kernel b")
    (tmp_path / "common.cuh").write_text("header")
    flags = ("-O3",)
    h0 = _build.source_hash("a", tmp_path, flags)
    assert len(h0) == 12 and h0 != _build.source_hash("b", tmp_path, flags)
    (tmp_path / "b.cu").write_text("kernel b, edited")
    os.utime(tmp_path / "a.cu", (1, 1))
    assert _build.source_hash("a", tmp_path, flags) == h0
    (tmp_path / "a.cu").write_text("kernel a, edited")
    h1 = _build.source_hash("a", tmp_path, flags)
    assert h1 != h0
    (tmp_path / "common.cuh").write_text("header, edited")
    h2 = _build.source_hash("a", tmp_path, flags)
    assert h2 != h1
    (tmp_path / "extra.cuh").write_text("")
    h3 = _build.source_hash("a", tmp_path, flags)
    assert h3 != h2
    assert _build.source_hash("a", tmp_path, ("-O2",)) != h3
    assert _build.source_hash("a", tmp_path, flags) == h3
    lib = _build.lib_path("paint")
    assert lib.name == f"libpaint-{_build.source_hash('paint')}.so"
    assert lib.parent == _build.BUILD_DIR


def test_render_tables_paint_the_jax_renderers_images(monkeypatch):
    """`_fig_table`/`_rgb_table` through `paint_shapes_ref` give the images
    that the JAX renderers paint before their noise, on the env of
    tests/test_torch_port_slice.py (images equal but for at most 0.5% of
    values at shape boundaries, the tolerance of that file), and the
    port's renderers paint exactly these tables."""
    n = 4
    cfg = jax_env.JaxEnvConfig()
    jbank = jax_env.make_route_bank(3, seed=0)
    jstate, _ = jax_env.JaxDrivingEnv(jbank, n, cfg).reset(
        jax.random.PRNGKey(5))
    painted = []
    real_paint = jax_env.paint.paint_shapes
    monkeypatch.setattr(jax_env.paint, "paint_shapes", lambda base, rows: (
        painted.append((base.shape, rows.shape, real_paint(base, rows)))
        or painted[-1][2]))
    ref = {"fig": [], "rgb": []}
    for i in range(n):
        one = jax.tree.map(lambda t: t[i], jstate)
        scal = jax_env._scalars(cfg, jbank, one)
        jax_env._render_rgb(cfg, jbank, one, jax.random.PRNGKey(0))
        jax_env._render_fig(cfg, jbank, one, scal)
        ref["rgb"].append(painted[-2])
        ref["fig"].append(painted[-1])

    bank = route_bank_from_numpy({k: np.asarray(v)
                                  for k, v in jbank._asdict().items()})
    state = env_state_from_numpy({k: np.asarray(v)
                                  for k, v in jstate._asdict().items()})
    tcfg = torch_env.EnvConfig()
    scal = torch_env._scalars(tcfg, bank, state)
    tables = {"fig": torch_env._fig_table(tcfg, bank, state, scal),
              "rgb": torch_env._rgb_table(tcfg, bank, state)}
    for name, (base, rows) in tables.items():
        img = tpaint.paint_shapes_ref(base, rows).numpy()
        for i, (base_shape, rows_shape, jimg) in enumerate(ref[name]):
            assert tuple(base.shape[1:]) == tuple(base_shape)
            assert tuple(rows.shape[1:]) == tuple(rows_shape)
            share = float((np.abs(img[i] - np.asarray(jimg)) > 1e-3).mean())
            assert share <= 0.005, f"{name} env {i}: {share:.4%} differ"
    fig = torch_env._render_fig(tcfg, bank, state, scal)
    assert torch.equal(fig, tpaint.paint_shapes_ref(*tables["fig"])[..., 0])


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
    process, pull in neither JAX, flax, optax, msgpack, tabulate, pygame,
    the JAX package nor `carla` (the CARLA env imports it when an env is
    made)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import cadre_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, "
        "'cadre_tpu_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'msgpack', 'tabulate', "
        "'pygame', 'cadre_tpu', 'carla')]\n"
        "assert len(names) >= 15, names\n"
        "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
