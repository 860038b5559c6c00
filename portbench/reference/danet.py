"""The CoPM encoder-decoder written out plainly from the published
description (DANet: Fu et al., CVPR 2019; ResNet: He et al., CVPR 2016;
CADRE: Zhao et al., AAAI 2022), as functions of a dict of weights named as
the port's checkpoints name them. NCHW throughout; the dual attention as
its equations; BatchNorm from the batch's own biased statistics in train
mode and from running statistics in eval mode; dropout through the keep
masks it is handed. Every convolution and product goes through `r`, the
precision step (reference/precision.py)."""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

W = Dict[str, torch.Tensor]
EPS = 1e-5
SLOPE = 0.01
KEEP = 0.9


class Net:
    """One configuration's forward passes; `cfg` is the configuration
    file's danet dict completed with its published sizes."""

    def __init__(self, w: W, cfg: dict, r, train: bool):
        self.w, self.cfg, self.r, self.train = w, cfg, r, train

    # -------------------------------------------------------- primitives

    def conv(self, x, name, stride=1, pad=None):
        w = self.w[f"{name}.weight"]
        b = self.w.get(f"{name}.bias")
        pad = w.shape[-1] // 2 if pad is None else pad
        r = self.r
        return r(F.conv2d(r(x), r(w), None if b is None else r(b), stride,
                          pad))

    def deconv(self, x, name, opad):
        w, b = self.w[f"{name}.weight"], self.w[f"{name}.bias"]
        r = self.r
        return r(F.conv_transpose2d(r(x), r(w), r(b), 2, 1, opad))

    def linear(self, x, name):
        r = self.r
        return r(F.linear(r(x), r(self.w[f"{name}.weight"]),
                          r(self.w[f"{name}.bias"])))

    def bn(self, x, name):
        g, b = self.w[f"{name}.weight"], self.w[f"{name}.bias"]
        if self.train:
            mean = x.mean(dim=(0, 2, 3), keepdim=True)
            var = ((x - mean) ** 2).mean(dim=(0, 2, 3), keepdim=True)
        else:
            mean = self.w[f"{name}.running_mean"].view(1, -1, 1, 1)
            var = self.w[f"{name}.running_var"].view(1, -1, 1, 1)
        return (x - mean) / torch.sqrt(var + EPS) * g.view(1, -1, 1, 1) \
            + b.view(1, -1, 1, 1)

    # ----------------------------------------------------------- backbone

    def backbone(self, x):
        x = torch.relu(self.bn(self.conv(x, "backbone.conv1", 2, 3),
                               "backbone.bn1"))
        x = F.max_pool2d(x, 3, 2, 1)
        bottleneck = self.cfg["backbone"] in ("resnet50", "resnet101",
                                              "resnet152")
        for stage, blocks in enumerate(self.cfg["depths"]):
            for b in range(blocks):
                p = f"backbone.layer{stage + 1}.{b}"
                stride = 2 if (stage > 0 and b == 0) else 1
                if f"{p}.downsample.0.weight" in self.w:
                    idt = self.bn(self.conv(x, f"{p}.downsample.0", stride,
                                            0), f"{p}.downsample.1")
                else:
                    idt = x
                if bottleneck:
                    y = torch.relu(self.bn(self.conv(x, f"{p}.conv1"),
                                           f"{p}.bn1"))
                    y = torch.relu(self.bn(self.conv(y, f"{p}.conv2", stride),
                                           f"{p}.bn2"))
                    y = self.bn(self.conv(y, f"{p}.conv3"), f"{p}.bn3")
                else:
                    y = torch.relu(self.bn(self.conv(x, f"{p}.conv1", stride),
                                           f"{p}.bn1"))
                    y = self.bn(self.conv(y, f"{p}.conv2"), f"{p}.bn2")
                x = torch.relu(y + idt)
        return x

    # -------------------------------------------------------------- head

    def pam(self, x, gamma):
        """Position attention: energies q_i . k_j over the positions,
        softmax over j, out_i = sum_j a_ij v_j; gamma * out + x."""
        r = self.r
        b, c, h, w = x.shape
        q = self.conv(x, "da_head.sa.query_conv").flatten(2)   # [B, d, P]
        k = self.conv(x, "da_head.sa.key_conv").flatten(2)
        v = self.conv(x, "da_head.sa.value_conv").flatten(2)  # [B, C, P]
        energy = r(torch.bmm(r(q).transpose(1, 2), r(k)))     # [B, P, P]
        att = torch.softmax(energy, dim=-1)
        out = r(torch.bmm(r(v), r(att).transpose(1, 2)))      # [B, C, P]
        return gamma * out.view(b, c, h, w) + x

    def cam(self, x, gamma):
        """Channel attention: the gram of the channels over the positions,
        softmax over (row max - gram), out = att x; gamma * out + x."""
        r = self.r
        b, c, h, w = x.shape
        f = x.flatten(2)                                       # [B, C, P]
        energy = r(torch.bmm(r(f), r(f).transpose(1, 2)))     # [B, C, C]
        energy = energy.amax(dim=-1, keepdim=True) - energy
        att = torch.softmax(energy, dim=-1)
        out = r(torch.bmm(r(att), r(f)))
        return gamma * out.view(b, c, h, w) + x

    def head(self, x, mask: Optional[torch.Tensor]):
        w = self.w
        feat1 = torch.relu(self.bn(self.conv(x, "da_head.conv5a.0"),
                                   "da_head.conv5a.1"))
        feat2 = torch.relu(self.bn(self.conv(x, "da_head.conv5c.0"),
                                   "da_head.conv5c.1"))
        sa = self.pam(feat1, w["da_head.sa.gamma"])
        sc = self.cam(feat2, w["da_head.sc.gamma"])
        sa = torch.relu(self.bn(self.conv(sa, "da_head.conv51.0"),
                                "da_head.conv51.1"))
        sc = torch.relu(self.bn(self.conv(sc, "da_head.conv52.0"),
                                "da_head.conv52.1"))
        feat = sa + sc
        if self.train:
            feat = feat * mask[:, :, None, None].float() / KEEP
        return self.conv(feat, "da_head.conv8.1")

    def mlp(self, x, name):
        return self.linear(F.leaky_relu(self.linear(x, f"{name}.1"), SLOPE),
                           f"{name}.3")

    def cross(self, q, k, v, mask):
        """One-token cross attention of CADRE's inter-task module: z x z
        energies q_i k_j / sqrt(z), softmax over j, out = att v + v."""
        temp = self.cfg["z_dims"] ** 0.5
        att = torch.softmax((q / temp)[:, :, None] * k[:, None, :], dim=-1)
        if self.train:
            att = torch.where(mask, att / KEEP, torch.zeros_like(att))
        return (att * v[:, None, :]).sum(-1) + v

    def streams(self, x, masks):
        """x [B, H, W, Cin] -> (att_visual, att_bc), each [B, z]."""
        da = self.head(self.backbone(x.permute(0, 3, 1, 2)),
                       None if masks is None else masks[0])
        vis = self.conv(da, "visual_conv").flatten(1)
        bc = self.conv(da, "bc_conv").flatten(1)
        p = "inter_task_att"
        vq, vk, vv = (self.mlp(vis, f"{p}.visual_{n}_layer")
                      for n in ("query", "key", "value"))
        bq, bk, bv = (self.mlp(bc, f"{p}.bc_{n}_layer")
                      for n in ("query", "key", "value"))
        m_bc, m_vis = (None, None) if masks is None else masks[1:]
        return self.cross(bq, vk, vv, m_vis), self.cross(vq, bk, bv, m_bc)

    def latent(self, x):
        """The PPO latent: visual ++ bc, [B, 2z] (eval mode)."""
        return torch.cat(self.streams(x, None), dim=-1)

    # ------------------------------------------------------------- heads

    def decoder(self, feat, name, sigmoid):
        cfg = self.cfg
        hs, ws = [cfg["image_height"]], [cfg["image_width"]]
        for _ in range(4):
            hs.append(-(-hs[-1] // 2))
            ws.append(-(-ws[-1] // 2))
        hs, ws = hs[::-1], ws[::-1]
        x, (h, w) = feat, feat.shape[2:]
        for i, idx in enumerate((0, 3, 6, 9, 12)):
            opad = (hs[i] - (2 * h - 1), ws[i] - (2 * w - 1))
            x = self.deconv(x, f"{name}.{idx}", opad)
            if i < 4:
                x = F.leaky_relu(self.bn(x, f"{name}.{idx + 1}"), SLOPE)
            h, w = hs[i], ws[i]
        return torch.sigmoid(x) if sigmoid else x

    def forward(self, x, speed, masks):
        """Output mode 12: camera seg logits and the route [B, H, W, K],
        light-state logits, steer and throttle."""
        cfg = self.cfg
        att_visual, att_bc = self.streams(x, masks)
        feat = self.linear(F.leaky_relu(
            self.linear(att_visual, "visual_branch.reverse_feature.0"),
            SLOPE), "visual_branch.reverse_feature.2")
        feat = feat.view(-1, 512, cfg["feat_h"], cfg["feat_w"])
        out = {
            "camera": self.decoder(feat, "visual_branch.reverse_image",
                                   False).permute(0, 2, 3, 1),
            "route": self.decoder(feat, "visual_branch.reverse_route",
                                  True).permute(0, 2, 3, 1)}
        h = feat.flatten(1)
        for i in (1, 3):
            h = F.leaky_relu(self.linear(
                h, f"visual_branch.reverse_lightState.{i}"), SLOPE)
        out["light_state"] = self.linear(h,
                                         "visual_branch.reverse_lightState.5")
        sp = self.linear(F.leaky_relu(self.linear(
            speed.reshape(-1, 1), "in_bc_speed_fc.1"), SLOPE),
            "in_bc_speed_fc.3")
        bc = self.linear(F.leaky_relu(self.linear(
            att_bc + sp, "bc_branch.bc_model.1"), SLOPE),
            "bc_branch.bc_model.3")
        out["steer"], out["throttle"] = bc[:, 0], bc[:, 1]
        return out


def weighted_ce(logits, labels, weight):
    """Mean NLL weighted by each label's class weight over the sum of
    those weights (torch CrossEntropyLoss(weight=w))."""
    nll = -torch.log_softmax(logits, dim=-1).gather(
        -1, labels.long()[..., None])[..., 0]
    w = weight[labels.long()]
    return (nll * w).sum() / w.sum().clamp_min(1e-12)


def total_loss(out, batch, seg_w, light_w, light_weight):
    """CADRE's output-mode-12 objective: seg CE x h*w + 0.5 route MSE x
    h*w + light_weight light CE + steer MSE + throttle MSE."""
    seg = weighted_ce(out["camera"], batch["camera_seg"], seg_w)
    h, w = batch["camera_seg"].shape[1:3]
    route_t = batch["route_fig"]
    route = ((out["route"] - route_t) ** 2).mean() * (
        route_t.shape[1] * route_t.shape[2] * route_t.shape[3])
    light = weighted_ce(out["light_state"], batch["light_state"], light_w)
    steer = ((out["steer"] - batch["steer"]) ** 2).mean()
    throttle = ((out["throttle"] - batch["throttle"]) ** 2).mean()
    return seg * (h * w) + 0.5 * route + light_weight * light + steer \
        + throttle


def inputs(rgb_u8, route_u8):
    """The model input from the raw frames: rgb / 255 and the route
    raster over its per-frame max, turned to [B, H, W, 1]."""
    rgb = rgb_u8.float() / 255.0
    route = route_u8.float()
    peak = route.amax(dim=(1, 2), keepdim=True)
    route = torch.where(peak > 0, route / peak.clamp_min(1e-6), route)
    route = route.transpose(1, 2)[..., None]
    return torch.cat([rgb, route], dim=-1), route
