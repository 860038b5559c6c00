"""Position (PAM) and channel (CAM) attention of the DANet head.

  PAM: att = softmax_k(q k^T) over the H*W positions;  y = gamma * (att v) + x
  CAM: E = x^T x over positions; att = softmax_j(rowmax(E) - E);
       y = gamma * (x att^T) + x

`pam_apply` / `cam_apply` are the plain versions, with the JAX package's
rounding: products accumulate in f32, the attention matrix is rounded to the
input type before it is applied, and the branch output is rounded to the
input type before the gamma residual. `fused_dual_attention` computes both
branches with the hand-written kernel (`csrc/dual_attention.cu`: several
blocks per batch row, products on the tensor cores; past the main path's
heads the positions, queries and keys stream through shared memory in
tiles, so any P; in bf16 the CAM's gram is formed once per symmetric pair
into a [B, C, C] f32 scratch allocated here, `gram_scratch_floats`) for
CUDA tensors and with the plain versions, under ordinary autograd, for
CPU tensors. The kernel adds the residual in f32 and rounds once, as the
TPU kernel did, so in bf16 the two differ by about one unit in the last
place. `dual_attention_blocked` spells out the wide kernel's algebra in
its order, for the tests.

On CUDA tensors that need a gradient, `fused_dual_attention` is the
autograd function `DualAttention`: its forward is that kernel and its
backward the hand-written backward kernel (`csrc/dual_attention_bwd.cu`,
f32, thread-block clusters per batch row, products in 3xTF32 on the
tensor cores; `dual_attention_backward`). The JAX package has no backward
kernel: its gradient is XLA's autodiff of the plain functions, which
`dual_attention_backward_ref` (autograd through pam_apply / cam_apply) is
here. `dual_attention_backward_blocked` spells out the kernel's algebra in
its order, for the tests. A call in another type that needs a gradient raises: a kernel never
returns outputs detached from inputs that require one.
All tensors are NHWC: x, v [B, H, W, C]; q, k [B, H, W, Cqk]. Both kernels
take every head the JAX package builds on any camera: any P = H * W >= 1,
C a multiple of 32 up to 512, Cqk up to 64; on CUDA tensors any other
shape raises ValueError before a launch.
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
# what the kernels take (with C % 32 and any P >= 1): every head the JAX
# package builds, resnet50-152's C = 512 and Cqk = 64 among them
_MAX_C, _MAX_D = 512, 64
# the narrow kernels take P <= 64, C <= 128 (resnet18 and 34 at 144x256),
# the backward's also only Cqk <= 32; the wide kernels the rest
_NARROW_P, _NARROW_C, _NARROW_D = 64, 128, 32
_MAX_PAM_RANKS = 8        # PAM ranks of a row in the wide backward, at most


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
    if not (p >= 1 and 32 <= c <= _MAX_C and c % 32 == 0
            and 1 <= d <= _MAX_D):
        raise ValueError(f"dual_attention: the kernel takes P >= 1, C a "
                         f"multiple of 32 up to {_MAX_C} and 1 <= Cqk <= "
                         f"{_MAX_D}; got P={p}, C={c}, Cqk={d}")


def backward_narrow(p: int, c: int, d: int) -> bool:
    """Whether the backward runs its first kernel (else its wide one)."""
    return p <= _NARROW_P and c <= _NARROW_C and d <= _NARROW_D


def backward_cluster_size(p: int, c: int, d: int) -> int:
    """CAM ranks per batch row of the backward (the blocks of a CAM
    cluster): one per 32 Gram rows (16 at C = 512, a non-portable cluster
    on the card; a card that cannot hold 16 such blocks in one GPC runs 8
    ranks of up to two groups past C = 256, csrc/dual_attention_bwd.cu:
    cam_ranks)."""
    return c // 32


def backward_shares(p: int, c: int, d: int) -> int:
    """Gamma shares per batch row of the backward kernel: its CAM ranks,
    or in the wide kernel the larger of its CAM ranks and the most PAM
    ranks a row can have (_MAX_PAM_RANKS)."""
    if backward_narrow(p, c, d):
        return c // 32
    return max(c // 32, _MAX_PAM_RANKS)


def smem_bytes(b: int, p: int, c: int, d: int, dtype: torch.dtype) -> int:
    """Dynamic shared memory of the largest block of the forward kernel's
    launches on B rows of this shape (CUDA only: the plan reads the
    card)."""
    fn = _build.load("dual_attention").dual_attention_smem_bytes
    fn.argtypes = [ctypes.c_int] * 5
    fn.restype = ctypes.c_longlong
    return int(fn(b, p, c, d, int(dtype == torch.bfloat16)))


def backward_scratch_floats(p: int) -> int:
    """Floats of one batch row's scratch in the wide backward: E and G,
    then A and dE ([P][P'] each, P' = P rounded up to 4)."""
    return 2 * p * ((p + 3) // 4 * 4)


def backward_smem_bytes(p: int, c: int, d: int) -> int:
    """Dynamic shared memory of one block of the backward kernel."""
    fn = _build.load("dual_attention_bwd").dual_attention_bwd_smem_bytes
    fn.argtypes = [ctypes.c_int] * 3
    fn.restype = ctypes.c_longlong
    return int(fn(p, c, d))


def forward_narrow(p: int, c: int) -> bool:
    """Whether the forward runs its narrow kernel (else its wide one)."""
    return p <= _NARROW_P and c <= _NARROW_C


def gram_scratch_floats(p: int, c: int, dtype: torch.dtype) -> int:
    """Floats of one batch row's scratch in the forward: the wide bf16
    kernel's gram launch writes the whole C x C gram there for its apply
    launch; the other kernels need none."""
    if dtype != torch.bfloat16 or forward_narrow(p, c):
        return 0
    return c * c


@functools.lru_cache(maxsize=None)
def _entry(dtype: torch.dtype):
    """The kernel's C entry for `dtype`, loaded and typed once."""
    fn = getattr(_build.load("dual_attention"), _ENTRY[dtype])
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 4 + \
        [ctypes.c_void_p]
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
    # the wide bf16 kernel's gram, written by one launch, read by the next
    n = gram_scratch_floats(p, c, dtype)
    scratch = (torch.empty(b, n, dtype=torch.float32, device=x_pam.device)
               if n else None)
    fn = _entry(dtype)
    stream = _build.cuda_stream(x_pam)
    _build.check(fn(x_pam.data_ptr(), q.data_ptr(), k.data_ptr(), v.data_ptr(),
                    gp.data_ptr(), x_cam.data_ptr(), gc.data_ptr(),
                    out_p.data_ptr(), out_c.data_ptr(),
                    0 if scratch is None else scratch.data_ptr(), b, p, c, d,
                    stream),
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
    forward. Every product in 3xTF32 on the tensor cores (as accurate as
    f32 at these shapes; `dual_attention_backward_blocked` is the same
    algebra on the CPU). Up to P = 64, C = 128, Cqk = 32
    (`backward_narrow`) one launch: a cluster of C / 32 CAM ranks per
    batch row, each owning 32 rows of the C x C Gram and exchanging its
    shares of dx_cam through distributed shared memory, and one PAM block
    per row; past that (any P) two launches side by side (the PAM one on
    a stream of the kernel's own, forked from and joined back to the
    caller's by events): a cluster per batch row of up to 8 PAM ranks
    (`_pam_ranks`) that split the query tiles, then the key tiles, with A
    and dE between them in a scratch allocated here for the call
    (`backward_scratch_floats`); and a cluster per batch row of C / 32 CAM
    ranks
    (`backward_cluster_size`, 16 at C = 512) that exchange only each Gram
    row's softmax statistics and own 32 columns of dx_cam each. Each
    gamma's gradient is a sum over B * P * C terms, taken in a
    fixed order (per block in the kernel, one share per block, then the
    shares summed here over a fixed axis), so two calls on the same inputs
    give bit-equal outputs."""
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
    # S shares per batch row in each row of part: row 0 dgamma_pam's (the
    # first kernel's PAM block's, padded with zeros; the wide kernel's PAM
    # ranks'), row 1 the CAM ranks' of dgamma_cam; one reduction over the
    # last axis sums both
    part = torch.empty(2, b * backward_shares(p, c, d),
                       dtype=torch.float32, device=x_cam.device)
    # the wide kernel's PAM ranks keep E and G, then A and dE, here
    scratch = (None if backward_narrow(p, c, d) else
               torch.empty(b, backward_scratch_floats(p),
                           dtype=torch.float32, device=x_cam.device))
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


# SMs of the card the CPU model stands for: an H100 SXM's 132
_SM_COUNT = 132


def _pam_slots(sm_count: int = _SM_COUNT) -> int:
    """Blocks the wide backward's PAM launch may take: 1.5 an SM, as the
    kernel's `3 * sm_count() / 2` (csrc/dual_attention_bwd.cu: launch);
    198 on an H100 SXM."""
    return 3 * sm_count // 2


def _pam_ranks(p: int, c: int, b: int = 1, slots: int = None) -> int:
    """PAM ranks of a batch row in a wide backward of b rows (a cluster of
    its own): one per query tile, at most _MAX_PAM_RANKS, and no more than
    b rows of them make `slots` blocks (`_pam_slots()` by default;
    csrc/dual_attention_bwd.cu: pam_ranks)."""
    if slots is None:
        slots = _pam_slots()
    sp = min(_MAX_PAM_RANKS, -(-p // _TILE))
    return max(1, min(sp, slots // max(b, 1)))


def _blocked_wide(qf, kf, vf, dyp, x, dy, gp, gc, mm):
    """The wide kernel, every PAM tile of _TILE queries or keys. PAM, Sp
    ranks (`_pam_ranks`) per row: rank r takes query tiles Q = r, r + Sp,
    ...: over the key tiles K, E_QK = q_Q k_K^T and G_QK = dy_Q v_K^T (dy
    and v in slabs of _SLAB channels), and for each of a row's 16 threads
    (two columns of each key tile, where the mma fragments hold them) its
    running max, sum of exp(E - max) and sum of exp(E - max) G, rescaled as
    its max rises; the row's max m, and the threads' sums rescaled to it,
    l and w; D = w / l (sum_j A_ij G_ij); then A_QK = exp(E - m) / l,
    dE_QK = A (gp G - gp D) and dq_Q = sum_K dE_QK k_K; then each key
    tile, dk_K = sum_Q dE_QK^T q_Q and dv_K = gp sum_Q A_QK^T dy_Q (the
    kernel takes a rank's key tiles two at a time; each tile's sum still
    runs over the query tiles in order). CAM, S ranks
    (`backward_cluster_size`), rank r owning the 32-row group g = r: G[g,
    :] = x_g^T x and H[g, :] = dy_g^T x, each
    row's min mu, S = sum exp(mu - G) and W = sum H exp(mu - G); with
    every row's (mu, 1 / S, gc W / S), M = gc Bm[:, g], N = dN[:, g] +
    dN[g, :]^T and dx_cam[:, g] = dy_g + dy M - x N. Shares: each PAM
    rank's sum of D over its rows, each CAM rank's sum of W / S, zeros past
    Sp and S ([2, B, max(S, 8)])."""
    b, p, c = x.shape
    tiles = range(0, p, _TILE)
    ranks = backward_cluster_size(p, c, qf.shape[-1])
    pam_ranks = _pam_ranks(p, c, b)
    kt = kf.transpose(1, 2)

    def g_tile(q0, k0):
        """dy_Q v_K^T, its slabs of _SLAB channels summed in order."""
        acc = None
        for c0 in range(0, c, _SLAB):
            part = mm(dyp[:, q0:q0 + _TILE, c0:c0 + _SLAB],
                      vf[:, k0:k0 + _TILE, c0:c0 + _SLAB].transpose(1, 2))
            acc = part if acc is None else acc + part
        return acc

    att = torch.empty(b, p, p, dtype=x.dtype, device=x.device)
    de = torch.empty_like(att)
    dqs = []
    width = max(ranks, _MAX_PAM_RANKS)
    pam_shares = torch.zeros(b, width, dtype=x.dtype, device=x.device)
    for qi, q0 in enumerate(tiles):
        rows = slice(q0, q0 + _TILE)
        nq = min(_TILE, p - q0)
        # 16 threads a row, thread (n-group, lane t) taking columns 2 j
        # and 2 j + 1 of each key tile (j = 4 n-group + t): its own running
        # max, sum of exp(E - max) and sum of exp(E - max) G
        tm = torch.full((b, nq, 16), float("-inf"), dtype=x.dtype,
                        device=x.device)
        tl = torch.zeros_like(tm)
        tw = torch.zeros_like(tm)
        es, gs = [], []
        for k0 in tiles:
            e = mm(qf[:, rows], kt[:, :, k0:k0 + _TILE])
            g_qk = g_tile(q0, k0)
            nk = e.shape[-1]
            for c2 in range(2):
                cols = torch.arange(c2, _TILE, 2)
                ok = cols < nk
                cols = cols.clamp(max=nk - 1)
                ec, gc2 = e[..., cols], g_qk[..., cols]
                up = (ec > tm) & ok
                scale = torch.exp(tm - ec)
                pe = torch.exp(ec - tm)
                tl = torch.where(up, tl * scale + 1,
                                 torch.where(ok, tl + pe, tl))
                tw = torch.where(up, tw * scale + gc2,
                                 torch.where(ok, tw + pe * gc2, tw))
                tm = torch.where(up, ec, tm)
            es.append(e)
            gs.append(g_qk)
        # the row's max, and the threads' sums rescaled to it
        m = tm.amax(dim=-1)
        f = torch.exp(tm - m[..., None])
        l = (tl * f).sum(dim=-1)
        w = (tw * f).sum(dim=-1)
        dd = w / l
        pam_shares[:, qi % pam_ranks] += dd.sum(dim=-1)
        dq = 0
        for k0, e, g_qk in zip(tiles, es, gs):
            a = torch.exp(e - m[..., None]) / l[..., None]
            d = a * (gp * g_qk - gp * dd[..., None])
            att[:, rows, k0:k0 + _TILE] = a
            de[:, rows, k0:k0 + _TILE] = d
            dq = dq + mm(d, kf[:, k0:k0 + _TILE])
        dqs.append(dq)
    dks, dvs = [], []
    for k0 in tiles:
        keys = slice(k0, k0 + _TILE)
        dk = dv = 0
        for q0 in tiles:
            rows = slice(q0, q0 + _TILE)
            dk = dk + mm(de[:, rows, keys].transpose(1, 2), qf[:, rows])
            dv = dv + mm(att[:, rows, keys].transpose(1, 2), dyp[:, rows])
        dks.append(dk)
        dvs.append(gp * dv)

    groups = c // 32
    mu = torch.empty(b, c, dtype=x.dtype, device=x.device)
    inv, dot = torch.empty_like(mu), torch.empty_like(mu)
    shares = torch.zeros(b, width, dtype=x.dtype, device=x.device)

    def cols(t, c0, width=32):
        return t[:, :, c0:c0 + width]

    for g in range(groups):
        xg, dyg = cols(x, 32 * g), cols(dy, 32 * g)
        g_g = mm(xg.transpose(1, 2), x)                # [B, 32, C]
        h_g = mm(dyg.transpose(1, 2), x)
        m = g_g.amin(dim=-1)
        e = torch.exp(m[..., None] - g_g)
        s = e.sum(dim=-1)
        w = (e * h_g).sum(dim=-1)
        rows = slice(32 * g, 32 * g + 32)
        mu[:, rows], inv[:, rows] = m, 1 / s
        dot[:, rows] = gc * w * inv[:, rows]
        shares[:, g % ranks] += (w * inv[:, rows]).sum(dim=-1)
    dxs = []
    for g in range(groups):
        xg, dyg = cols(x, 32 * g), cols(dy, 32 * g)
        rows = slice(32 * g, 32 * g + 32)
        acc = torch.zeros_like(dyg)
        for c0 in range(0, c, 32):
            xc, dyc = cols(x, c0), cols(dy, c0)
            crow = slice(c0, c0 + 32)
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
    part = torch.stack([pam_shares, shares])
    return (torch.cat(dqs, dim=1), torch.cat(dks, dim=1),
            torch.cat(dvs, dim=1), torch.cat(dxs, dim=-1), part)


# the wide kernels' tiles (csrc/dual_attention_bwd.cu: kTP, kCS;
# csrc/dual_attention.cu: pam_vk, tile_rows, gram_tile)
_TILE, _SLAB = 32, 128


def _value_tile(c: int, dtype: torch.dtype) -> int:
    """Keys of a value tile of the wide forward's PAM: 64 in
    bf16 up to C = 256, else 32 (csrc/dual_attention.cu: pam_vk)."""
    return 64 if dtype == torch.bfloat16 and c <= 256 else 32


def _gram_tile(c: int) -> int:
    """Rows and columns of a tile of the wide bf16 forward's gram launch: 32
    up to C = 128, else 64 (csrc/dual_attention.cu: gram_tile)."""
    return 32 if c <= 128 else 64


def _ordered_products(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b (batched, f32) with each element one chain of multiply-adds
    over the reduction in order, as the bf16 kernel's f32 FMA chains form
    it: a bf16 x bf16 product is exact in f32, so each step rounds once, as
    fmaf does."""
    acc = torch.zeros(*a.shape[:-1], b.shape[-1], dtype=torch.float32,
                      device=a.device)
    for i in range(a.shape[-1]):
        acc = acc + a[..., i:i + 1].float() * b[..., i:i + 1, :].float()
    return acc


def _mirrored_gram(x: torch.Tensor) -> torch.Tensor:
    """x^T x of x [B, P, C] as the bf16 gram launch forms it: each tile
    (i-block, j-block >= i-block) of `_gram_tile` rows and columns one
    ordered chain over the positions (`_ordered_products`), written at (i,
    j) and, off the diagonal, mirrored at (j, i)."""
    b, p, c = x.shape
    ti = _gram_tile(c)
    gram = torch.empty(b, c, c, dtype=torch.float32, device=x.device)
    for i0 in range(0, c, ti):
        for j0 in range(i0, c, ti):
            tile = _ordered_products(x[:, :, i0:i0 + ti].transpose(1, 2),
                                     x[:, :, j0:j0 + ti])
            gram[:, i0:i0 + ti, j0:j0 + ti] = tile
            if j0 != i0:
                gram[:, j0:j0 + ti, i0:i0 + ti] = tile.transpose(1, 2)
    return gram


def _position_tile(p: int, c: int) -> int:
    """Positions of a wide f32 forward CAM tile: all of P up to 64, else 64
    up to C = 128, else 32 (csrc/dual_attention.cu: tile_rows)."""
    if p <= 64:
        return p
    return 64 if c <= 128 else 32


def _warp_softmax_sum(ex: torch.Tensor) -> torch.Tensor:
    """Each row's sum of `ex` (f32, [..., n]) in the order of PyTorch's
    warp softmax on the card, which the kernel follows: lane l adds the
    columns l, l + 32, ... in order, then a butterfly over the 32 lanes
    (offsets 16, 8, 4, 2, 1). Returns [..., 1]."""
    n = ex.shape[-1]
    lanes = torch.zeros(*ex.shape[:-1], 32, dtype=ex.dtype, device=ex.device)
    for k0 in range(0, n, 32):
        part = ex[..., k0:k0 + 32]
        lanes[..., :part.shape[-1]] += part
    idx = torch.arange(32, device=ex.device)
    for o in (16, 8, 4, 2, 1):
        lanes = lanes + lanes[..., idx ^ o]
    return lanes[..., :1]


def dual_attention_blocked(x_pam, q, k, v, gamma_pam, x_cam, gamma_cam,
                           products="f32"):
    """The wide forward kernel's algebra, in its order, on any device: the
    outputs of `fused_dual_attention` (input dtype f32 or bf16). PAM (a
    block per query tile over all C columns): in bf16 the energies q k^T
    formed once as chains of f32 FMAs over d in order (`_ordered_products`)
    and kept, each row's max, then its sum of exp(e - max) in the plain
    version's warp order (`_warp_softmax_sum`); in f32 the energies are the
    plain version's f32 products, and one walk in which each of a row's 16
    threads (keys 4 tx .. 4 tx + 3 of each 64-key tile) keeps its running
    max and sum, then the row's max and the threads' sums rescaled to it;
    att = exp(e - max) / sum rounded to the input type, applied to each
    value tile (`_value_tile`), the tiles' products summed in order. CAM:
    the gram, its row softmax of rowmax - gram rounded to the input type,
    applied to x. The bf16 gram is the gram launch's (`_mirrored_gram`:
    upper-triangle tiles, each element a chain of f32 FMAs in position
    order, mirrored); the f32 gram is summed over the position tiles
    (`_position_tile`), and with `products` "3xtf32" it and both f32
    applies are formed as the kernel's tensor cores form them (see
    `_matmul`; bf16 products are exact in f32). Each residual is added in
    f32 and rounded once. Used by the tests only."""
    dtype = x_pam.dtype
    b, h, w, c = x_pam.shape
    p = h * w
    bf16 = dtype == torch.bfloat16
    mm_ = functools.partial(_matmul, products="f32" if bf16 else products)
    gp = gamma_pam.reshape(()).float()
    gc = gamma_cam.reshape(()).float()
    xf, vf = x_pam.reshape(b, p, c), v.reshape(b, p, c)
    qf, kf = q.reshape(b, p, -1).float(), k.reshape(b, p, -1).float()
    if bf16:
        energy = _ordered_products(qf, kf.transpose(1, 2))
    else:
        energy = torch.einsum("bpd,bqd->bpq", qf, kf)
    kt = _value_tile(c, dtype)
    if bf16:
        row_max = energy.amax(dim=-1, keepdim=True)
        row_sum = _warp_softmax_sum(torch.exp(energy - row_max))
    else:
        # thread tx of a row takes keys 4 tx .. 4 tx + 3 of each 64-key
        # tile, keeping its own running max and sum; then the 16 threads'
        th_max = torch.full((b, p, 16), float("-inf"), device=xf.device)
        th_sum = torch.zeros(b, p, 16, device=xf.device)
        for k in range(p):
            e, g = energy[:, :, k], (k % 64) // 4
            m = th_max[..., g]
            th_sum[..., g] = torch.where(e > m, th_sum[..., g] * torch.exp(m - e)
                                         + 1, th_sum[..., g] + torch.exp(e - m))
            th_max[..., g] = torch.maximum(m, e)
        row_max = th_max.amax(dim=-1, keepdim=True)
        row_sum = (th_sum * torch.exp(th_max - row_max)).sum(
            dim=-1, keepdim=True)
    out_p = 0
    for k0 in range(0, p, kt):
        att = torch.exp(energy[:, :, k0:k0 + kt] - row_max) / row_sum
        out_p = out_p + mm_(att.to(dtype).float(), vf[:, k0:k0 + kt].float())
    y_p = (gp * out_p + xf.float()).to(dtype)
    # CAM
    xc = x_cam.reshape(b, p, c).float()
    if bf16:
        gram = _mirrored_gram(xc)
    else:
        gram = 0
        tp = _position_tile(p, c)
        for p0 in range(0, p, tp):
            xt = xc[:, p0:p0 + tp]
            gram = gram + mm_(xt.transpose(1, 2), xt)
    att = torch.softmax(gram.amax(dim=-1, keepdim=True) - gram, dim=-1)
    att = att.to(dtype).float()
    out_c = mm_(xc, att.transpose(1, 2))
    y_c = (gc * out_c + xc).to(dtype)
    return y_p.reshape(b, h, w, c), y_c.reshape(b, h, w, c)


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
