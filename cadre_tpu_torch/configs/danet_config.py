"""Perception-encoder configuration: the fields of
cadre_tpu.configs.danet_config.DANetParams that the port's latent path reads,
with the same defaults (the reference's production setup: camera + route
raster input, ResNet18, DANet head 512 -> 128 channels of attention,
InterTaskAtt 'transformer' with inter_att_dims 512 and z_dims 256, so a
512-wide latent)."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class DANetParams:
    backbone: str = "resnet18"
    input_channel: int = 4          # rgb (3) + route raster (1), input mode 9
    da_feature_channel: int = 512
    inter_att_dims: int = 512
    z_dims: int = 256
    att_type: str = "transformer"   # the only InterTaskAtt mode ported
    pred_bc: bool = True            # the bc stream (latent = visual ++ bc)
    # blank the route-raster input plane (camera-route protocol)
    in_route_blank: bool = False
    image_height: int = 144
    image_width: int = 256
    feat_h: int = 5                 # encoder output geometry (stride 32)
    feat_w: int = 8
    # dual attention: "auto" or True call ops.dual_attention's
    # fused_dual_attention (the CUDA kernel on CUDA tensors); False calls
    # the plain versions
    use_fused_attention: object = "auto"

    @property
    def latent_dim(self) -> int:
        """PPO latent width: visual z ++ bc z."""
        return 2 * self.z_dims if self.pred_bc else self.z_dims


def danet_params(**overrides) -> DANetParams:
    return dataclasses.replace(DANetParams(), **overrides)
