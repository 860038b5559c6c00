"""The U-Net family of the perception zoo (the counterpart of
cadre_tpu.models.unet): `UNet` with plain (`DoubleConv`) or recurrent
residual (`RRCNNBlock`) bodies, with or without `AttentionGate`s on the
skips (U_Net, AttU_Net, R2U_Net, R2AttU_Net), and `NestedUNet` (UNet++).

Public input and output are NHWC [B, H, W, C], as the JAX modules'; the
convolutions run NCHW. Down-sampling is a 2x2 max pool of stride 2
(`max_pool_torch(x, 2, 2, 0)`), up-sampling a nearest 2x resize
(`jax.image.resize(..., "nearest")`, which picks input row o // 2 for
output row o, as `F.interpolate(scale_factor=2)` does). Module names are
the flax names, so flax variables convert by name.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from cadre_tpu_torch.models.torch_compat import BatchNorm2d


def _pool(x):
    return F.max_pool2d(x, 2, 2, 0)


def _upsample(x):
    return F.interpolate(x, scale_factor=2, mode="nearest")


class DoubleConv(nn.Module):
    """(3x3 conv + BatchNorm + ReLU) twice."""

    def __init__(self, in_channels: int, features: int):
        super().__init__()
        self.conv0 = nn.Conv2d(in_channels, features, 3, 1, 1)
        self.bn0 = BatchNorm2d(features)
        self.conv1 = nn.Conv2d(features, features, 3, 1, 1)
        self.bn1 = BatchNorm2d(features)

    def forward(self, x):
        x = torch.relu(self.bn0(self.conv0(x)))
        return torch.relu(self.bn1(self.conv1(x)))


class RecurrentConv(nn.Module):
    """y_0 = relu(bn(conv(x))), then t times y = relu(bn(conv(x + y))),
    one conv and one BatchNorm throughout."""

    def __init__(self, features: int, t: int = 2):
        super().__init__()
        self.t = t
        self.conv = nn.Conv2d(features, features, 3, 1, 1)
        self.bn = BatchNorm2d(features)

    def forward(self, x):
        y = torch.relu(self.bn(self.conv(x)))
        for _ in range(self.t):
            y = torch.relu(self.bn(self.conv(x + y)))
        return y


class RRCNNBlock(nn.Module):
    """A 1x1 projection, then two recurrent convs and a residual."""

    def __init__(self, in_channels: int, features: int, t: int = 2):
        super().__init__()
        self.proj = nn.Conv2d(in_channels, features, 1)
        self.rc1 = RecurrentConv(features, t)
        self.rc2 = RecurrentConv(features, t)

    def forward(self, x):
        x1 = self.proj(x)
        return x1 + self.rc2(self.rc1(x1))


class AttentionGate(nn.Module):
    """x * sigmoid(psi(relu(wg(g) + wx(x)))) with 1x1 convs."""

    def __init__(self, g_channels: int, x_channels: int, inter: int):
        super().__init__()
        self.wg = nn.Conv2d(g_channels, inter, 1)
        self.wx = nn.Conv2d(x_channels, inter, 1)
        self.psi = nn.Conv2d(inter, 1, 1)

    def forward(self, g, x):
        return x * torch.sigmoid(self.psi(torch.relu(self.wg(g)
                                                     + self.wx(x))))


class UNet(nn.Module):
    """`depth` pooled stages of `base * 2**d` features, a bottleneck, and
    as many nearest-upsampled stages, each a 3x3 `upconv`, the (gated)
    skip concatenated first, and a body; a 1x1 conv to `out_channels`."""

    def __init__(self, in_channels: int, out_channels: int = 3,
                 base: int = 64, depth: int = 4, recurrent: bool = False,
                 attention: bool = False):
        super().__init__()
        self.depth, self.attention = depth, attention

        def body(cin, feats):
            return RRCNNBlock(cin, feats) if recurrent \
                else DoubleConv(cin, feats)

        cin = in_channels
        for d in range(depth):
            setattr(self, f"down{d}", body(cin, base * 2 ** d))
            cin = base * 2 ** d
        self.bottleneck = body(cin, base * 2 ** depth)
        for d in reversed(range(depth)):
            feats = base * 2 ** d
            setattr(self, f"upconv{d}", nn.Conv2d(2 * feats, feats, 3, 1, 1))
            if attention:
                setattr(self, f"att{d}", AttentionGate(
                    feats, feats, base * 2 ** max(d - 1, 0)))
            setattr(self, f"up{d}", body(2 * feats, feats))
        self.out = nn.Conv2d(base, out_channels, 1)

    def forward(self, x):
        """x [B, H, W, Cin] (H, W multiples of 2**depth) -> [B, H, W,
        out_channels]."""
        x = x.permute(0, 3, 1, 2)
        skips = []
        for d in range(self.depth):
            x = getattr(self, f"down{d}")(x)
            skips.append(x)
            x = _pool(x)
        x = self.bottleneck(x)
        for d in reversed(range(self.depth)):
            x = getattr(self, f"upconv{d}")(_upsample(x))
            skip = skips[d]
            if self.attention:
                skip = getattr(self, f"att{d}")(x, skip)
            x = getattr(self, f"up{d}")(torch.cat([skip, x], dim=1))
        return self.out(x).permute(0, 2, 3, 1)


class NestedUNet(nn.Module):
    """UNet++: dense skips over four pooled levels of `base * 2**i`
    features, a 1x1 conv to `out_channels` from x03."""

    # node -> (level, the nodes concatenated before the upsampled one);
    # a node with no upsampled input pools the node below it instead
    _NODES = (("x00", 0, ()), ("x10", 1, ()), ("x01", 0, ("x00",)),
              ("x20", 2, ()), ("x11", 1, ("x10",)), ("x02", 0, ("x00", "x01")),
              ("x30", 3, ()), ("x21", 2, ("x20",)), ("x12", 1, ("x10", "x11")),
              ("x03", 0, ("x00", "x01", "x02")))

    def __init__(self, in_channels: int, out_channels: int = 3,
                 base: int = 32):
        super().__init__()
        f = [base * 2 ** i for i in range(5)]
        for name, level, dense in self._NODES:
            if name.endswith("0"):
                cin = in_channels if level == 0 else f[level - 1]
            else:
                cin = len(dense) * f[level] + f[level + 1]
            setattr(self, name, DoubleConv(cin, f[level]))
        self.out = nn.Conv2d(f[0], out_channels, 1)

    def forward(self, x):
        x = x.permute(0, 3, 1, 2)
        nodes = {}
        for name, level, dense in self._NODES:
            i, j = int(name[1]), int(name[2])
            if j == 0:
                h = x if i == 0 else _pool(nodes[f"x{i - 1}0"])
            else:
                h = torch.cat([nodes[n] for n in dense]
                              + [_upsample(nodes[f"x{i + 1}{j - 1}"])], dim=1)
            nodes[name] = getattr(self, name)(h)
        return self.out(nodes["x03"]).permute(0, 2, 3, 1)
