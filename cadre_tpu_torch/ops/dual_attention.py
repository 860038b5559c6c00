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
All tensors are NHWC: x, v [B, H, W, C]; q, k [B, H, W, Cqk]. Both kernels
take every head the JAX package builds, P = H * W up to 256, C a multiple
of 32 up to 512, Cqk up to 64; on CUDA tensors any other shape raises
ValueError before a launch.
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
# what the kernels take (with C % 32): every head the JAX package builds,
# resnet50-152's C = 512, Cqk = 64 and cameras of up to 16 x 16 features
_MAX_P, _MAX_C, _MAX_D = 256, 512, 64
# the backward's first kernel takes P <= 64, C <= 128, Cqk <= 32 (resnet18
# and 34 at 144x256); its wide kernel the rest
_NARROW_P, _NARROW_C, _NARROW_D = 64, 128, 32
_MAX_RANKS = 8            # CAM ranks of a wide cluster: a portable size


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
    """Raise unless the kernels take P positions, C channels, D = Cqk."""
    if not (1 <= p <= _MAX_P and 32 <= c <= _MAX_C and c % 32 == 0
            and 1 <= d <= _MAX_D):
        raise ValueError(f"dual_attention: the kernel takes 1 <= P <= "
                         f"{_MAX_P}, C a multiple of 32 up to {_MAX_C} and "
                         f"1 <= Cqk <= {_MAX_D}; got P={p}, C={c}, Cqk={d}")


def backward_narrow(p: int, c: int, d: int) -> bool:
    """Whether the backward runs its first kernel (else its wide one)."""
    return p <= _NARROW_P and c <= _NARROW_C and d <= _NARROW_D


def backward_cluster_size(p: int, c: int, d: int) -> int:
    """CAM ranks per batch row of the backward (the blocks of a cluster):
    one per 32 Gram rows, and in the wide kernel at most _MAX_RANKS, a
    rank then taking two groups of 32 rows."""
    groups = c // 32
    if backward_narrow(p, c, d) or groups <= _MAX_RANKS:
        return groups
    return (groups + 1) // 2


def smem_bytes(b: int, p: int, c: int, d: int, dtype: torch.dtype) -> int:
    """Dynamic shared memory of one block of the forward kernel launched
    on B rows of this shape (CUDA only: the plan reads the SM count)."""
    fn = _build.load("dual_attention").dual_attention_smem_bytes
    fn.argtypes = [ctypes.c_int] * 5
    fn.restype = ctypes.c_longlong
    return int(fn(b, p, c, d, int(dtype == torch.bfloat16)))


def backward_smem_bytes(p: int, c: int, d: int) -> int:
    """Dynamic shared memory of one block of the backward kernel."""
    fn = _build.load("dual_attention_bwd").dual_attention_bwd_smem_bytes
    fn.argtypes = [ctypes.c_int] * 3
    fn.restype = ctypes.c_longlong
    return int(fn(p, c, d))


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
    fn.argtypes = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 4 + \
        [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def dual_attention_backward(q, k, v, gamma_pam, x_cam, gamma_cam, dy_pam,
                            dy_cam):
    """Gradients of (PAM(x_pam), CAM(x_cam)) given the upstream gradients,
    by the backward kernel (CUDA tensors, f32): (dx_pam, dq, dk, dv,
    dgamma_pam, dx_cam, dgamma_cam), each gamma's gradient shaped and typed
    as the gamma. x_pam is not an input: its gradient is dy_pam. The
    attention matrices are recomputed from the inputs, not saved by the
    forward. One launch: per batch row a cluster of CAM blocks and one PAM
    block, every product in 3xTF32 on the tensor cores (as accurate as f32
    at these shapes; `dual_attention_backward_blocked` is the same algebra
    on the CPU). Up to P = 64, C = 128, Cqk = 32 (`backward_narrow`) the
    C / 32 CAM ranks each own 32 rows of the C x C Gram and exchange their
    shares of dx_cam through distributed shared memory; past that the
    wide kernel's ranks (at most 8: `backward_cluster_size`) exchange
    only each Gram row's softmax statistics and own 32 columns of dx_cam
    each, and its PAM block runs over chunks of 32 queries, then of 32
    keys, through a [B, 2, P, P'] scratch allocated here for the launch.
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
    # one share per block, S per batch row in each row of part: row 0 the
    # PAM block's of dgamma_pam (padded with zeros), row 1 the CAM ranks'
    # of dgamma_cam; one reduction over the last axis sums both
    part = torch.empty(2, b * backward_cluster_size(p, c, d),
                       dtype=torch.float32, device=x_cam.device)
    # the wide kernel's PAM blocks keep A^T and dE^T here between passes
    scratch = (None if backward_narrow(p, c, d) else
               torch.empty(b, 2, p, (p + 3) // 4 * 4, dtype=torch.float32,
                           device=x_cam.device))
    if b:
        _build.check(_bwd_entry(dtype)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), gp.data_ptr(),
            x_cam.data_ptr(), gc.data_ptr(), dy_pam.data_ptr(),
            dy_cam.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            dx_cam.data_ptr(), part.data_ptr(),
            0 if scratch is None else scratch.data_ptr(), b, p, c, d,
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
    dtype: the outputs of `dual_attention_backward`, by the first kernel's
    blocking where it runs (`backward_narrow`), else by the wide one's.
    `products` is "f32" or "3xtf32" (see `_matmul`). Used by the tests
    only."""
    b, h, w, c = x_cam.shape
    p, d = h * w, q.shape[-1]
    gp = gamma_pam.reshape(()).to(x_cam.dtype)
    gc = gamma_cam.reshape(()).to(x_cam.dtype)

    def mm(a, bb):
        return _matmul(a, bb, products)

    args = (q.reshape(b, p, d), k.reshape(b, p, d), v.reshape(b, p, c),
            dy_pam.reshape(b, p, c), x_cam.reshape(b, p, c),
            dy_cam.reshape(b, p, c), gp, gc, mm)
    if backward_narrow(p, c, d):
        dq, dk, dv, dx, part = _blocked_narrow(*args)
    else:
        dq, dk, dv, dx, part = _blocked_wide(*args)
    sums = part.reshape(2, -1).sum(dim=1)
    return (dy_pam, dq.reshape(q.shape), dk.reshape(k.shape),
            dv.reshape(v.shape),
            sums[0].reshape(gamma_pam.shape).to(gamma_pam.dtype),
            dx.reshape(x_cam.shape),
            sums[1].reshape(gamma_cam.shape).to(gamma_cam.dtype))


def _blocked_narrow(qf, kf, vf, dyp, x, dy, gp, gc, mm):
    """The first kernel: one PAM block per row over all P x P scores; CAM
    rank r owns the Gram rows I_r = [32 r, 32 r + 32): G_r = x[:, I_r]^T x
    and H_r = dy[:, I_r]^T x, Bm_r and dN_r from their rows, its partial
    T_r = dy[:, I_r] (gc Bm_r) - x[:, I_r] dN_r and its own
    L_r = x dN_r^T; dx_cam[:, I_r] = dy[:, I_r] + (T_0 + T_1 + ...)[:, I_r]
    - L_r, the partials summed in rank order. One share of dgamma_pam (the
    PAM block's) and one of dgamma_cam per rank, per batch row
    ([2, B, C / 32], PAM's share padded with zeros)."""
    b, p, c = x.shape
    att = torch.softmax(mm(qf, kf.transpose(1, 2)), dim=-1)
    g_pam = mm(dyp, vf.transpose(1, 2))
    share_pam = (att * g_pam).sum(dim=(1, 2))
    da = gp * g_pam
    de = att * (da - (da * att).sum(dim=-1, keepdim=True))
    dv = gp * mm(att.transpose(1, 2), dyp)
    dq = mm(de, kf)
    dk = mm(de.transpose(1, 2), qf)

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
                        torch.stack(shares, dim=1)])
    return dq, dk, dv, dx, part


def _blocked_wide(qf, kf, vf, dyp, x, dy, gp, gc, mm):
    """The wide kernel. PAM, one block per row: per chunk of 32 query rows
    Q, E_Q = q_Q k^T and G_Q = dy_Q v^T over all keys, A_Q = softmax(E_Q),
    dE_Q = A_Q (gp G_Q - rowsum(gp G_Q A_Q)), dq_Q = dE_Q k; then per chunk
    of 32 keys K, dk_K = dE[:, K]^T q and dv_K = gp A[:, K]^T dy. CAM, S
    ranks (`backward_cluster_size`), rank r owning the 32-row groups
    g = r, r + S, ...: per group, over chunks c of 32 columns, each row's
    running min mu of G = x^T x, S = sum exp(mu - G) and
    W = sum H exp(mu - G) (H = dy^T x), rescaled as mu falls; with every
    row's (mu, 1 / S, gc W / S), per chunk M = gc Bm[c, g],
    N = dN[c, g] + dN[g, c]^T and dx_cam[:, g] = dy_g + sum_c (dy_c M -
    x_c N). Shares: the PAM block's sum(A G); each rank's sum of W / S over
    its rows ([2, B, S], PAM's padded with zeros)."""
    b, p, c = x.shape
    chunks = range(0, p, 32)
    kt = kf.transpose(1, 2)
    vt = vf.transpose(1, 2)
    atts, des, dqs = [], [], []
    share_pam = torch.zeros(b, dtype=x.dtype, device=x.device)
    for q0 in chunks:
        att = torch.softmax(mm(qf[:, q0:q0 + 32], kt), dim=-1)
        g_q = mm(dyp[:, q0:q0 + 32], vt)
        share_pam = share_pam + (att * g_q).sum(dim=(1, 2))
        da = gp * g_q
        de = att * (da - (da * att).sum(dim=-1, keepdim=True))
        dqs.append(mm(de, kf))
        atts.append(att)
        des.append(de)
    att_t = torch.cat(atts, dim=1).transpose(1, 2)     # [B, keys, queries]
    de_t = torch.cat(des, dim=1).transpose(1, 2)
    dk = torch.cat([mm(de_t[:, k0:k0 + 32], qf) for k0 in chunks], dim=1)
    dv = gp * torch.cat([mm(att_t[:, k0:k0 + 32], dyp) for k0 in chunks],
                        dim=1)

    groups = c // 32
    ranks = backward_cluster_size(p, c, qf.shape[-1])
    mu = torch.empty(b, c, dtype=x.dtype, device=x.device)
    inv, dot = torch.empty_like(mu), torch.empty_like(mu)
    shares = torch.zeros(b, ranks, dtype=x.dtype, device=x.device)

    def cols(t, g):
        return t[:, :, 32 * g:32 * g + 32]

    for g in range(groups):
        xg, dyg = cols(x, g), cols(dy, g)
        m = torch.full((b, 32), float("inf"), dtype=x.dtype, device=x.device)
        s = torch.zeros_like(m)
        w = torch.zeros_like(m)
        for ci in range(groups):
            xc = cols(x, ci)
            g_gc = mm(xg.transpose(1, 2), xc)
            h_gc = mm(dyg.transpose(1, 2), xc)
            nm = torch.minimum(m, g_gc.amin(dim=-1))
            scale = torch.exp(nm - m)
            e = torch.exp(nm[..., None] - g_gc)
            s = s * scale + e.sum(dim=-1)
            w = w * scale + (e * h_gc).sum(dim=-1)
            m = nm
        rows = slice(32 * g, 32 * g + 32)
        mu[:, rows], inv[:, rows] = m, 1 / s
        dot[:, rows] = gc * w * inv[:, rows]
        shares[:, g % ranks] += (w * inv[:, rows]).sum(dim=-1)
    dxs = []
    for g in range(groups):
        xg, dyg = cols(x, g), cols(dy, g)
        rows = slice(32 * g, 32 * g + 32)
        acc = torch.zeros_like(dyg)
        for ci in range(groups):
            xc, dyc = cols(x, ci), cols(dy, ci)
            crow = slice(32 * ci, 32 * ci + 32)
            g_cg = mm(xc.transpose(1, 2), xg)          # [B, c rows, g cols]
            h_cg = mm(dyc.transpose(1, 2), xg)
            h_gc = mm(dyg.transpose(1, 2), xc)
            bc = torch.exp(mu[:, crow, None] - g_cg) * inv[:, crow, None]
            bg = torch.exp(mu[:, None, rows] - g_cg) * inv[:, None, rows]
            n_cg = bc * (gc * h_cg - dot[:, crow, None])
            n_gc = bg * (gc * h_gc.transpose(1, 2) - dot[:, None, rows])
            acc = acc + mm(dyc, gc * bc)
            acc = acc + mm(-xc, n_cg + n_gc)
        dxs.append(dyg + acc)
    pad = torch.zeros(b, ranks - 1, dtype=x.dtype, device=x.device)
    part = torch.stack([torch.cat([share_pam[:, None], pad], dim=1), shares])
    return (torch.cat(dqs, dim=1), dk, dv, torch.cat(dxs, dim=-1), part)


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
