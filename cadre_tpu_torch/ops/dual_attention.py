"""Position (PAM) and channel (CAM) attention of the DANet head.

  PAM: att = softmax_k(q k^T) over the H*W positions;  y = gamma * (att v) + x
  CAM: E = x^T x over positions; att = softmax_j(rowmax(E) - E);
       y = gamma * (x att^T) + x

`pam_apply` / `cam_apply` are the plain versions, with the JAX package's
rounding: products accumulate in f32, the attention matrix is rounded to the
input type before it is applied, and the branch output is rounded to the
input type before the gamma residual. `fused_dual_attention` computes both
branches with the hand-written kernel (`csrc/dual_attention.cu`: several
blocks per batch row, bf16 products on the tensor cores) for CUDA tensors
and with the plain versions, under ordinary autograd, for CPU tensors. The
kernel adds the residual in f32 and rounds once, as the TPU kernel did, so
in bf16 the two differ by about one unit in the last place.

On CUDA tensors that need a gradient, `fused_dual_attention` is the
autograd function `DualAttention`: its forward is that kernel and its
backward the hand-written backward kernel (`csrc/dual_attention_bwd.cu`,
f32, a thread-block cluster per batch row, products in 3xTF32 on the
tensor cores; `dual_attention_backward`). The JAX package has no backward
kernel: its gradient is XLA's autodiff of the plain functions, which
`dual_attention_backward_ref` (autograd through pam_apply / cam_apply) is
here. `dual_attention_backward_blocked` spells out the kernel's algebra in
its order, for the tests. A call in another type that needs a gradient raises: a kernel never
returns outputs detached from inputs that require one.
All tensors are NHWC: x, v [B, H, W, C]; q, k [B, H, W, Cqk].
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from cadre_tpu_torch.ops import _build

launches = 0              # forward kernel launches (fused_dual_attention)
backward_launches = 0     # backward kernel launches (dual_attention_backward)

_ENTRY = {torch.float32: "dual_attention_f32",
          torch.bfloat16: "dual_attention_bf16"}
_BWD_ENTRY = {torch.float32: "dual_attention_bwd_f32"}
_MAX_P, _MAX_C, _MAX_D = 64, 128, 32    # what the kernels take (with C % 32)


def pam_apply(x, q, k, v, gamma) -> torch.Tensor:
    b, h, w, c = x.shape
    p = h * w
    qf = q.reshape(b, p, -1).float()
    kf = k.reshape(b, p, -1).float()
    vf = v.reshape(b, p, c)
    energy = torch.einsum("bpc,bqc->bpq", qf, kf)
    att = torch.softmax(energy, dim=-1).to(vf.dtype)
    out = torch.einsum("bpq,bqc->bpc", att.float(), vf.float())
    out = out.reshape(b, h, w, c).to(x.dtype)
    return gamma * out + x


def cam_apply(x, gamma) -> torch.Tensor:
    b, h, w, c = x.shape
    xf = x.reshape(b, h * w, c)
    x32 = xf.float()
    energy = torch.einsum("bpc,bpd->bcd", x32, x32)
    energy_new = energy.amax(dim=-1, keepdim=True) - energy
    att = torch.softmax(energy_new, dim=-1).to(xf.dtype)
    out = torch.einsum("bcd,bpd->bpc", att.float(), x32)
    out = out.reshape(b, h, w, c).to(x.dtype)
    return gamma * out + x


def _check_shape(p: int, c: int, d: int) -> None:
    """Raise unless the kernel takes P positions, C channels, D = Cqk."""
    if not (1 <= p <= _MAX_P and 32 <= c <= _MAX_C and c % 32 == 0
            and 1 <= d <= _MAX_D):
        raise ValueError(f"dual_attention: the kernel takes 1 <= P <= "
                         f"{_MAX_P}, C a multiple of 32 up to {_MAX_C} and "
                         f"1 <= Cqk <= {_MAX_D}; got P={p}, C={c}, Cqk={d}")


@functools.lru_cache(maxsize=None)
def _entry(dtype: torch.dtype):
    """The kernel's C entry for `dtype`, loaded and typed once."""
    fn = getattr(_build.load("dual_attention"), _ENTRY[dtype])
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _gamma(g: torch.Tensor, dtype: torch.dtype, device) -> torch.Tensor:
    """A one-value gamma of `dtype` on `device`: `g` itself when it is one
    already (its data pointer is then that value), else a converted copy."""
    if g.dtype == dtype and g.device == device:
        return g
    return g.reshape(1).to(device=device, dtype=dtype)


def _dual_attention_cuda(x_pam, q, k, v, gamma_pam, x_cam, gamma_cam):
    global launches
    b, h, w, c = x_pam.shape
    p, d = h * w, q.shape[-1]
    dtype = x_pam.dtype
    if dtype not in _ENTRY:
        raise TypeError(f"dual_attention: unsupported dtype {dtype}")
    tensors = (x_pam, q, k, v, x_cam)
    if any(t.dtype != dtype or t.device != x_pam.device for t in tensors):
        raise TypeError("dual_attention: inputs differ in dtype or device")
    if (tuple(v.shape) != (b, h, w, c) or tuple(x_cam.shape) != (b, h, w, c)
            or tuple(q.shape) != (b, h, w, d)
            or tuple(k.shape) != (b, h, w, d)):
        raise ValueError("dual_attention: shapes disagree")
    if gamma_pam.numel() != 1 or gamma_cam.numel() != 1:
        raise ValueError("dual_attention: gammas must hold one value")
    _check_shape(p, c, d)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("dual_attention: inputs must be contiguous")
    if any(t.data_ptr() % 16 for t in (x_pam, v, x_cam)):
        raise ValueError("dual_attention: x and v must be 16-byte aligned")
    # the kernel reads each gamma in the input type and widens it to f32:
    # the value the plain version multiplies by
    gp = _gamma(gamma_pam, dtype, x_pam.device)
    gc = _gamma(gamma_cam, dtype, x_pam.device)
    out_p = torch.empty_like(x_pam)
    out_c = torch.empty_like(x_cam)
    if b == 0:
        return out_p, out_c
    fn = _entry(dtype)
    stream = _build.cuda_stream(x_pam)
    _build.check(fn(x_pam.data_ptr(), q.data_ptr(), k.data_ptr(), v.data_ptr(),
                    gp.data_ptr(), x_cam.data_ptr(), gc.data_ptr(),
                    out_p.data_ptr(), out_c.data_ptr(), b, p, c, d, stream),
                 "dual_attention")
    launches += 1
    return out_p, out_c


@functools.lru_cache(maxsize=None)
def _bwd_entry(dtype: torch.dtype):
    """The backward kernel's C entry for `dtype`, loaded and typed once."""
    fn = getattr(_build.load("dual_attention_bwd"), _BWD_ENTRY[dtype])
    fn.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 4 + \
        [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def dual_attention_backward(q, k, v, gamma_pam, x_cam, gamma_cam, dy_pam,
                            dy_cam):
    """Gradients of (PAM(x_pam), CAM(x_cam)) given the upstream gradients,
    by the backward kernel (CUDA tensors, f32): (dx_pam, dq, dk, dv,
    dgamma_pam, dx_cam, dgamma_cam), each gamma's gradient shaped and typed
    as the gamma. x_pam is not an input: its gradient is dy_pam. The
    attention matrices are recomputed from the inputs, not saved. One
    launch: per batch row a cluster of C / 32 CAM blocks, each owning 32
    rows of the C x C Gram and exchanging its share of dx_cam through
    distributed shared memory, and one PAM block; every product in 3xTF32
    on the tensor cores (as accurate as f32 at these shapes;
    `dual_attention_backward_blocked` is the same algebra on the CPU).
    Each gamma's gradient is a sum over B * P * C terms, taken in a fixed
    order (per block in the kernel, one share per block, then the shares
    summed here over a fixed axis), so two calls on the same inputs give
    bit-equal outputs."""
    global backward_launches
    dtype = x_cam.dtype
    if dtype not in _BWD_ENTRY:
        raise TypeError(f"dual_attention: no backward kernel for {dtype}; "
                        "train in float32")
    b, h, w, c = x_cam.shape
    p, d = h * w, q.shape[-1]
    dy_pam, dy_cam = dy_pam.contiguous(), dy_cam.contiguous()
    tensors = (q, k, v, x_cam, dy_pam, dy_cam)
    if any(t.dtype != dtype or t.device != x_cam.device for t in tensors):
        raise TypeError("dual_attention backward: inputs differ in dtype "
                        "or device")
    if (tuple(v.shape) != (b, h, w, c) or tuple(dy_pam.shape) != (b, h, w, c)
            or tuple(dy_cam.shape) != (b, h, w, c)
            or tuple(q.shape) != (b, h, w, d)
            or tuple(k.shape) != (b, h, w, d)):
        raise ValueError("dual_attention backward: shapes disagree")
    _check_shape(p, c, d)
    if not all(t.is_contiguous() for t in (q, k, v, x_cam)):
        raise ValueError("dual_attention backward: inputs must be contiguous")
    if any(t.data_ptr() % 16 for t in (v, x_cam, dy_pam, dy_cam)):
        raise ValueError("dual_attention backward: v, x_cam and the upstream "
                         "gradients must be 16-byte aligned")
    gp = _gamma(gamma_pam, dtype, x_cam.device)
    gc = _gamma(gamma_cam, dtype, x_cam.device)
    dq, dk = torch.empty_like(q), torch.empty_like(k)
    dv, dx_cam = torch.empty_like(v), torch.empty_like(x_cam)
    # one share per block, C / 32 per batch row in each row of part: row
    # 0 the PAM block's of dgamma_pam (padded with zeros), row 1 the CAM
    # ranks' of dgamma_cam; one reduction over the last axis sums both
    part = torch.empty(2, b * (c // 32), dtype=torch.float32,
                       device=x_cam.device)
    if b:
        _build.check(_bwd_entry(dtype)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), gp.data_ptr(),
            x_cam.data_ptr(), gc.data_ptr(), dy_pam.data_ptr(),
            dy_cam.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            dx_cam.data_ptr(), part.data_ptr(), b, p, c, d,
            _build.cuda_stream(x_cam)), "dual_attention backward")
        backward_launches += 1
    sums = part.sum(dim=1)
    return (dy_pam, dq, dk, dv,
            sums[0].reshape(gamma_pam.shape).to(gamma_pam.dtype), dx_cam,
            sums[1].reshape(gamma_cam.shape).to(gamma_cam.dtype))


def dual_attention_backward_ref(x_pam, q, k, v, gamma_pam, x_cam, gamma_cam,
                                dy_pam, dy_cam):
    """The plain version of `dual_attention_backward`: autograd through
    pam_apply and cam_apply (the JAX package's gradient is XLA's autodiff
    of the same functions). Same outputs, in the same order."""
    with torch.enable_grad():
        ins = [t.detach().requires_grad_(True)
               for t in (x_pam, q, k, v, gamma_pam, x_cam, gamma_cam)]
        out_p = pam_apply(*ins[:5])
        out_c = cam_apply(ins[5], ins[6])
        return torch.autograd.grad((out_p, out_c), ins, (dy_pam, dy_cam))


def _tf32(t: torch.Tensor, rna: bool = True) -> torch.Tensor:
    """t's float32 values as tf32 (10 mantissa bits), in t's dtype: rounded
    to nearest, ties away from zero (cvt.rna.tf32.f32), or with `rna`
    False truncated, which is what the tensor cores do with the low 13 bits
    of an f32 operand."""
    bits = t.float().view(torch.int32)
    if rna:
        bits = bits + 0x1000
    return (bits & -0x2000).view(torch.float32).to(t.dtype)


def _matmul(a: torch.Tensor, b: torch.Tensor, products: str) -> torch.Tensor:
    """a @ b as the backward kernel's tensor cores form it: with "3xtf32"
    each operand is split into hi, a rounded to tf32, and lo = a - hi,
    which the tensor cores truncate to tf32; the product is lo·hi + hi·lo +
    hi·hi (lo·lo dropped). "f32" is a @ b."""
    if products == "f32":
        return a @ b
    if products != "3xtf32":
        raise ValueError(f"products must be 'f32' or '3xtf32', got {products}")
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32(a - ah, rna=False), _tf32(b - bh, rna=False)
    return al @ bh + ah @ bl + ah @ bh


def dual_attention_backward_blocked(q, k, v, gamma_pam, x_cam, gamma_cam,
                                    dy_pam, dy_cam, products="f32"):
    """The backward kernel's algebra, in its order, on any device and
    dtype: the outputs of `dual_attention_backward`. CAM rank r owns the
    Gram rows I_r = [32 r, 32 r + 32): G_r = x[:, I_r]^T x and
    H_r = dy[:, I_r]^T x, Bm_r and dN_r from their rows, its partial
    T_r = dy[:, I_r] (gc Bm_r) - x[:, I_r] dN_r and its own
    L_r = x dN_r^T; dx_cam[:, I_r] = dy[:, I_r] + (T_0 + T_1 + ...)[:, I_r]
    - L_r, the partials summed in rank order. One share of dgamma_pam (the
    PAM block's) and one of dgamma_cam per rank, per batch row, summed as
    the wrapper sums them ([2, B C / 32], PAM's share padded with zeros).
    `products` is "f32" or "3xtf32" (see `_matmul`).
    Used by the tests only."""
    b, h, w, c = x_cam.shape
    p, d = h * w, q.shape[-1]
    gp = gamma_pam.reshape(()).to(x_cam.dtype)
    gc = gamma_cam.reshape(()).to(x_cam.dtype)

    def mm(a, bb):
        return _matmul(a, bb, products)

    qf, kf = q.reshape(b, p, d), k.reshape(b, p, d)
    vf, dyp = v.reshape(b, p, c), dy_pam.reshape(b, p, c)
    att = torch.softmax(mm(qf, kf.transpose(1, 2)), dim=-1)
    g_pam = mm(dyp, vf.transpose(1, 2))
    share_pam = (att * g_pam).sum(dim=(1, 2))
    da = gp * g_pam
    de = att * (da - (da * att).sum(dim=-1, keepdim=True))
    dv = gp * mm(att.transpose(1, 2), dyp)
    dq = mm(de, kf)
    dk = mm(de.transpose(1, 2), qf)

    x, dy = x_cam.reshape(b, p, c), dy_cam.reshape(b, p, c)
    partials, local, shares = [], [], []
    for r in range(c // 32):
        rows = slice(32 * r, 32 * r + 32)
        xr, dyr = x[:, :, rows], dy[:, :, rows]
        g_r = mm(xr.transpose(1, 2), x)
        h_r = mm(dyr.transpose(1, 2), x)
        bm = torch.softmax(g_r.amax(dim=-1, keepdim=True) - g_r, dim=-1)
        shares.append((bm * h_r).sum(dim=(1, 2)))
        db = gc * h_r
        dn = bm * (db - (db * bm).sum(dim=-1, keepdim=True))
        partials.append(mm(dyr, gc * bm) + mm(-xr, dn))
        local.append(mm(x, dn.transpose(1, 2)))
    total = partials[0]
    for t in partials[1:]:
        total = total + t
    dx = torch.cat([dy[:, :, 32 * r:32 * r + 32]
                    + total[:, :, 32 * r:32 * r + 32] - local[r]
                    for r in range(c // 32)], dim=-1)
    pad = torch.zeros(b, c // 32 - 1, dtype=share_pam.dtype,
                      device=share_pam.device)
    part = torch.stack([torch.cat([share_pam[:, None], pad], dim=1),
                        torch.stack(shares, dim=1)]).reshape(2, -1)
    sums = part.sum(dim=1)
    return (dy_pam, dq.reshape(q.shape), dk.reshape(k.shape),
            dv.reshape(v.shape),
            sums[0].reshape(gamma_pam.shape).to(gamma_pam.dtype),
            dx.reshape(x_cam.shape),
            sums[1].reshape(gamma_cam.shape).to(gamma_cam.dtype))


class DualAttention(torch.autograd.Function):
    """Both branches on CUDA tensors: forward kernel, backward kernel."""

    @staticmethod
    def forward(ctx, x_pam, q, k, v, gamma_pam, x_cam, gamma_cam):
        ctx.save_for_backward(q, k, v, gamma_pam, x_cam, gamma_cam)
        return _dual_attention_cuda(x_pam, q, k, v, gamma_pam, x_cam,
                                    gamma_cam)

    @staticmethod
    def backward(ctx, dy_pam, dy_cam):
        return dual_attention_backward(*ctx.saved_tensors, dy_pam, dy_cam)


def fused_dual_attention(x_pam, q, k, v, gamma_pam, x_cam, gamma_cam
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(PAM(x_pam), CAM(x_cam)): the CUDA kernels for CUDA tensors (through
    `DualAttention` when a gradient is needed, which only f32 has), the
    plain versions for CPU tensors."""
    args = (x_pam, q, k, v, gamma_pam, x_cam, gamma_cam)
    if not x_pam.is_cuda:
        return pam_apply(*args[:5]), cam_apply(x_cam, gamma_cam)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        if x_pam.dtype not in _BWD_ENTRY:
            raise TypeError(f"dual_attention: a gradient is needed, but "
                            f"there is no backward kernel for "
                            f"{x_pam.dtype}; train in float32")
        return DualAttention.apply(*args)
    return _dual_attention_cuda(*args)
