"""The dual-attention backward kernel's algebra against the JAX package.

`dual_attention_backward_blocked` spells out what the CUDA backward
(`cadre_tpu_torch/csrc/dual_attention_bwd.cu`) computes, in its order: CAM
split into ranks of 32 Gram rows, each rank's partial of dx_cam summed in
rank order, one gamma share per block. Here it is held to `jax.vjp` of the
JAX `pam_apply` / `cam_apply` at every cluster size the kernel launches
(C = 32, 64, 96, 128: 1-4 CAM ranks) and at P = 40 (the trainer's 5x8),
P = 49 (7x7: K not a multiple of 8) and P = 64 (8x8, the most the kernel
takes), with odd and full-width Cqk. In f32 within 1e-4 of each gradient's
largest magnitude (sums in other orders), in float64 within 1e-9 (the
JAX functions accumulate their einsums in f32 by `preferred_element_type`;
for the float64 reference that type is widened to float64 while they are
traced, so that both sides compute the algebra in float64). Its
3xTF32 mode (each operand split into hi, rounded to tf32, and lo = a -
hi, truncated to tf32 by the tensor cores; lo*lo dropped; as the kernel
forms every product) stays within the tolerance `chip_smoke.py` holds the
kernel to on the card, `BWD_TOL`.
"""
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import BWD_TOL
from test_torch_port_slice import few_torch_threads  # noqa: F401 (autouse)
from cadre_tpu.ops import dual_attention as jda
from cadre_tpu_torch.ops import dual_attention as tda

# (C, H, W, Cqk): four cluster sizes, three position counts
CASES = [(c, h, w, d)
         for c in (32, 64, 96, 128)
         for h, w, d in ((5, 8, c // 8), (7, 7, c // 8 + 1), (8, 8, c // 4))]
IDS = [f"C{c}-P{h * w}-D{d}" for c, h, w, d in CASES]
NAMES = ("dx_pam", "dq", "dk", "dv", "dgamma_pam", "dx_cam", "dgamma_cam")
_JAX = {}


@jax.jit
def _jax_grads(args, dy):
    _, vjp = jax.vjp(lambda *a: (jda.pam_apply(*a[:5]),
                                 jda.cam_apply(a[5], a[6])), *args)
    return vjp(dy)


def _inputs(case, dtype):
    """(x_pam, q, k, v, gamma_pam, x_cam, gamma_cam) and (dy_pam, dy_cam)
    as numpy arrays of `dtype`, non-zero gammas, from a seed per case."""
    c, h, w, d = case
    rng = np.random.RandomState(100 + CASES.index(case))
    f = lambda *s: rng.standard_normal(s).astype(dtype)  # noqa: E731
    b = 2
    return ([f(b, h, w, c), f(b, h, w, d), f(b, h, w, d), f(b, h, w, c),
             np.full((1,), 0.7, dtype), f(b, h, w, c),
             np.full((1,), -0.4, dtype)], [f(b, h, w, c), f(b, h, w, c)])


def _want(case, dtype):
    """jax.vjp of the JAX functions on `_inputs(case, dtype)`, once."""
    key = (case, np.dtype(dtype).name)
    if key not in _JAX:
        args, dy = _inputs(case, dtype)
        wide = dtype == np.float64
        einsum = jnp.einsum

        def einsum64(*a, preferred_element_type=None, **kw):
            return einsum(*a, preferred_element_type=jnp.float64, **kw)

        with jax.enable_x64(wide), mock.patch.object(
                jda.jnp, "einsum", einsum64 if wide else einsum):
            out = _jax_grads([jnp.asarray(a) for a in args],
                             tuple(jnp.asarray(t) for t in dy))
            _JAX[key] = [np.asarray(o) for o in out]
    return _JAX[key]


def _blocked(case, dtype, products):
    args, (dy_p, dy_c) = _inputs(case, dtype)
    t = [torch.from_numpy(a) for a in args]
    return tda.dual_attention_backward_blocked(
        *t[1:], torch.from_numpy(dy_p), torch.from_numpy(dy_c),
        products=products)


def _rel_errors(got, want):
    out = {}
    for name, g, w in zip(NAMES, got, want):
        assert tuple(g.shape) == w.shape, name
        scale = float(np.abs(w).max())
        assert scale > 0, f"{name} is zero: the gammas must be non-zero"
        out[name] = float(np.abs(g.numpy() - w).max()) / scale
    return out


@pytest.mark.parametrize("dtype, tol", [(np.float32, 1e-4),
                                        (np.float64, 1e-9)],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_blocked_backward_matches_jax_vjp(case, dtype, tol):
    """Every gradient of the blocked algebra, f32 products, within `tol`
    of its largest magnitude of jax.vjp's in the same dtype."""
    rel = _rel_errors(_blocked(case, dtype, "f32"), _want(case, dtype))
    assert max(rel.values()) <= tol, rel


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_blocked_backward_in_3xtf32_stays_within_bwd_tol(case):
    """f32 inputs with every product formed in 3xTF32 against jax.vjp in
    f32: within chip_smoke.BWD_TOL (1e-4 PAM, 1e-3 CAM of each gradient's
    largest magnitude), the bound the kernel is held to on the card."""
    rel = _rel_errors(_blocked(case, np.float32, "3xtf32"),
                      _want(case, np.float32))
    for name, tol in BWD_TOL.items():
        assert rel[name] <= tol, (name, rel)


def test_tf32_split_rounds_hi_to_nearest_and_truncates_lo():
    """`_tf32` is cvt.rna.tf32.f32 (10 mantissa bits, to nearest, ties away
    from zero) or, with rna=False, the tensor cores' truncation; hi +
    trunc(a - hi) carries a to within 2^-21 of its size, and `_matmul`'s
    3xTF32 product is as close to the f64 product as f32, where plain TF32
    is not."""
    one = 1.0
    a = torch.tensor([one + 2.0 ** -11, -(one + 2.0 ** -11),
                      one + 2.0 ** -12, one + 3 * 2.0 ** -11, 0.0],
                     dtype=torch.float32)
    want = torch.tensor([one + 2.0 ** -10, -(one + 2.0 ** -10), one,
                         one + 2.0 ** -9, 0.0], dtype=torch.float32)
    assert torch.equal(tda._tf32(a), want)
    trunc = torch.tensor([one, -one, one, one + 2.0 ** -10, 0.0])
    assert torch.equal(tda._tf32(a, rna=False), trunc)
    rng = np.random.RandomState(5)
    x = torch.from_numpy(rng.standard_normal((64, 48)).astype(np.float32))
    y = torch.from_numpy(rng.standard_normal((48, 32)).astype(np.float32))
    hi = tda._tf32(x)
    lo = tda._tf32(x - hi, rna=False)
    assert float(((hi + lo) - x).abs().max()) <= 2.0 ** -21 * float(
        x.abs().max())
    exact = x.double() @ y.double()
    err3 = float((tda._matmul(x, y, "3xtf32").double() - exact).abs().max())
    err32 = float(((x @ y).double() - exact).abs().max())
    err1 = float((hi.double() @ tda._tf32(y).double() - exact).abs().max())
    assert err3 <= 4 * err32 < err1
