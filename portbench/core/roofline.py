"""The yardstick of the kernels and of the whole step, frozen here: the
H100's published peaks, the least time of each kernel call from its
shapes (the arithmetic of PERF.md's "Bound ms" column, which chip_smoke.py
phase 3 worked out), and the model FLOPs of a pretraining step and of a
PPO iteration counted from the configuration's shapes."""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

# NVIDIA H100 SXM, data sheet, dense (no sparsity), at the 700 W limit
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12           # outside the tensor cores
TF32_TC_FLOPS = 495e12
BF16_TC_FLOPS = 989e12
MFU_PEAK = BF16_TC_FLOPS     # one fixed peak for every MFU, whatever dtype


def paint_least_s(base_numel: int, table_numel: int) -> float:
    """K1: the canvas read and written and the shape table read, 4 bytes
    an element."""
    return (2 * base_numel * 4 + table_numel * 4) / HBM_BYTES_PER_S


def k2_least_s(b: int, p: int, c: int, d: int, bf16: bool) -> float:
    """K2 (the fused PAM + CAM forward): x, q, k, v read and both outputs
    written; E = q k^T, A v, the symmetric gram (one product a pair) and
    its apply, 2 FLOP a multiply-add, at the tensor-core bf16 rate or the
    f32 rate outside the tensor cores."""
    elem = 2 if bf16 else 4
    nbytes = b * (5 * p * c + 2 * p * d) * elem + 8
    flops = b * 2.0 * (p * p * d + p * p * c + p * c * (c + 1) // 2
                       + p * c * c)
    peak = BF16_TC_FLOPS if bf16 else FP32_FLOPS
    return max(nbytes / HBM_BYTES_PER_S, flops / peak)


def k3_least_s(b: int, p: int, c: int, d: int) -> float:
    """K3 (the backward, f32): q, k, v, x_cam and both upstream gradients
    read, dq, dk, dv, dx_cam and the gamma partials written; E, dy v^T,
    A^T dy, dE k, dE^T q, the symmetric gram, dy^T x, dy Bm, x S."""
    nbytes = b * p * (4 * d + 6 * c) * 4 + 2 * b * 4
    macs = b * (3 * p * p * d + 2 * p * p * c + 3 * p * c * c
                + p * c * (c + 1) // 2)
    return max(nbytes / HBM_BYTES_PER_S, 2.0 * macs / FP32_FLOPS)


def share_pct(least_s: Sequence[float], device_s: Sequence[float]):
    """The calls' least time over their device time, in percent; None
    where nothing was read."""
    total = sum(device_s)
    if not least_s or total <= 0:
        return None
    return 100.0 * sum(least_s) / total


# ------------------------------------------------------------ model FLOPs

_RESNET = {"resnet18": ("basic", (2, 2, 2, 2)),
           "resnet34": ("basic", (3, 4, 6, 3)),
           "resnet50": ("bottleneck", (3, 4, 6, 3)),
           "resnet101": ("bottleneck", (3, 4, 23, 3)),
           "resnet152": ("bottleneck", (3, 8, 36, 3))}


def _conv(cin, cout, k, h, w, stride=1):
    """(FLOPs of one image, output h, w) of a k x k conv, padding k // 2."""
    ho, wo = (h + 2 * (k // 2) - k) // stride + 1, \
        (w + 2 * (k // 2) - k) // stride + 1
    return 2.0 * cin * cout * k * k * ho * wo, ho, wo


def backbone_flops(arch: str, cin: int, h: int, w: int) -> Tuple[float, int,
                                                                   int, int]:
    """Forward FLOPs of one image through the headless ResNet, and its
    output channels, h and w."""
    kind, depths = _RESNET[arch]
    f, h, w = _conv(cin, 64, 7, h, w, 2)
    h, w = (h + 2 - 3) // 2 + 1, (w + 2 - 3) // 2 + 1      # max pool
    inplanes = 64
    expansion = 1 if kind == "basic" else 4
    for stage, (planes, blocks) in enumerate(zip((64, 128, 256, 512),
                                                 depths)):
        for b in range(blocks):
            stride = 2 if (stage > 0 and b == 0) else 1
            out = planes * expansion
            if kind == "basic":
                g1, ho, wo = _conv(inplanes, planes, 3, h, w, stride)
                g2, _, _ = _conv(planes, planes, 3, ho, wo)
                f += g1 + g2
            else:
                g1, _, _ = _conv(inplanes, planes, 1, h, w)
                g2, ho, wo = _conv(planes, planes, 3, h, w, stride)
                g3, _, _ = _conv(planes, out, 1, ho, wo)
                f += g1 + g2 + g3
            if stride != 1 or inplanes != out:
                f += _conv(inplanes, out, 1, h, w, stride)[0]
            inplanes, h, w = out, ho, wo
    return f, inplanes, h, w


def latent_flops(cfg: Dict) -> float:
    """Forward FLOPs of one frame to the PPO latent: backbone, DANetHead
    (conv5a/c, q/k/v, PAM, CAM, conv51/52, conv8), the 1x1 visual and bc
    convs and the six inter-task MLPs with their z x z cross."""
    f, cout, h, w = backbone_flops(cfg["backbone"], cfg["input_channel"],
                                   cfg["image_height"], cfg["image_width"])
    inter, p = cout // 4, h * w
    c = cfg["da_feature_channel"]
    f += 2 * _conv(cout, inter, 3, h, w)[0]                  # conv5a, 5c
    f += 2.0 * p * inter * (2 * (inter // 8) + inter)        # q, k, v
    d = inter // 8
    f += 2.0 * (p * p * d + p * p * inter + p * inter * inter
                + p * inter * inter)                         # PAM + CAM
    f += 2 * _conv(inter, inter, 3, h, w)[0]                 # conv51, 52
    f += 2.0 * p * inter * c                                 # conv8
    f += 2 * 2.0 * p * c * c                                 # visual, bc
    flat, z = c * p, cfg["z_dims"]
    f += 6 * 2.0 * (flat * cfg["inter_att_dims"] + cfg["inter_att_dims"] * z)
    f += 2 * 2 * 2.0 * z * z                                 # two crosses
    return f


def decoder_flops(cfg: Dict) -> float:
    """Forward FLOPs of one frame through the heads of output mode 12 past
    the latent: reverse_feature, the seg and route decoders (transposed
    3x3 convs), the light-state MLP and the bc head."""
    c0, h, w = 512, cfg["feat_h"], cfg["feat_w"]
    z = cfg["z_dims"]
    flat = c0 * h * w
    f = 2.0 * (z * 512 + 512 * flat)
    dims = (512, 256, 128, 64, 32)
    hs, ws = [cfg["image_height"]], [cfg["image_width"]]
    for _ in range(4):
        hs.append(-(-hs[-1] // 2))
        ws.append(-(-ws[-1] // 2))
    hs, ws = hs[::-1], ws[::-1]
    for out_last in (cfg["camera_output_channel"], 1):
        for i in range(5):
            cout = dims[i + 1] if i < 4 else out_last
            # a transposed conv does cin * cout * 9 MACs per input pixel
            hin, win = (h, w) if i == 0 else (hs[i - 1], ws[i - 1])
            f += 2.0 * dims[i] * cout * 9 * hin * win
    f += 2.0 * (flat * 256 + 256 * 64 + 64 * cfg["light_classes_num"])
    f += 2.0 * (z * (z // 2) + (z // 2) * 2 + 64 + 64 * z)
    return f


def pretrain_step_flops(cfg: Dict, batch: int) -> float:
    """Forward and backward (twice the forward) of one training step."""
    return 3.0 * batch * (latent_flops(cfg) + decoder_flops(cfg))


def bank_flops(rows: int, seq: int, feat: int, hid: int, outputs: int
               ) -> float:
    """Forward FLOPs of one signal's own bank over `rows` windows of `seq`
    frames: the LSTM (input and hidden products, 4 gates) and the actor
    and critic MLPs on its last state."""
    lstm = 2.0 * rows * seq * 4 * feat * (feat + feat)
    heads = 2.0 * rows * (feat * hid + hid * hid + hid * outputs
                          + feat * hid + hid * hid + hid)
    return lstm + heads


def ppo_iteration_flops(cfg: Dict, n: int, t: int, seq: int, feat: int,
                        hid: int, outputs: Sequence[int], epochs: int,
                        minibatches: int) -> float:
    """One iteration: T+2 latents of N frames (the reset's or the carry's,
    T steps and the bootstrap; the first comes with the previous
    iteration, so T+1 are counted), T+1 acts of both signals at N, and the
    update's forward and backward (3x) over every minibatch row of each
    epoch. Each sample's own bank is counted, as a plain implementation
    computes it."""
    latent = (t + 1) * n * latent_flops(cfg)
    act = (t + 1) * sum(bank_flops(n, seq, feat, hid, a) for a in outputs)
    rows = (n * t // minibatches) * minibatches * epochs
    update = 3.0 * sum(bank_flops(rows, seq, feat, hid, a) for a in outputs)
    return latent + act + update
