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
and with the plain versions for CPU tensors. The kernel adds the
residual in f32 and rounds once, as the TPU kernel did, so in bf16 the two
differ by about one unit in the last place.
All tensors are NHWC: x, v [B, H, W, C]; q, k [B, H, W, Cqk].
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from cadre_tpu_torch.ops import _build

launches = 0                       # kernel launches made by fused_dual_attention

_ENTRY = {torch.float32: "dual_attention_f32",
          torch.bfloat16: "dual_attention_bf16"}
_MAX_P, _MAX_C, _MAX_D = 64, 128, 32    # what the kernel takes (with C % 32)


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


def fused_dual_attention(x_pam, q, k, v, gamma_pam, x_cam, gamma_cam
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(PAM(x_pam), CAM(x_cam)): the CUDA kernel for CUDA tensors, the plain
    versions for CPU tensors."""
    if x_pam.is_cuda:
        return _dual_attention_cuda(x_pam, q, k, v, gamma_pam, x_cam,
                                    gamma_cam)
    return pam_apply(x_pam, q, k, v, gamma_pam), cam_apply(x_cam, gamma_cam)
