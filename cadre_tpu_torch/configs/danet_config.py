"""Perception-encoder configuration: the fields of
cadre_tpu.configs.danet_config.DANetParams and PerceptionTrainParams, with
the same defaults (the reference's production setup: input mode 9, camera
+ route raster + speed for the bc head; output mode 12, camera seg of 8
classes + route reconstruction + traffic-light state + behaviour cloning;
ResNet18, DANet head 512 -> 128 channels of attention, InterTaskAtt
'transformer' with inter_att_dims 512 and z_dims 256, so a 512-wide
latent). The input/output mode tables of the JAX package, and the
decoders only they switch on (left/right camera, lidar, topdown), are not
ported: they belong to the model zoo (ROADMAP.md queue A item 14)."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class DANetParams:
    backbone: str = "resnet18"
    input_channel: int = 4          # rgb (3) + route raster (1), input mode 9
    da_feature_channel: int = 512
    inter_att_dims: int = 512
    z_dims: int = 256
    att_type: str = "transformer"   # 'transformer' | 'position' | 'invaild'
    light_classes_num: int = 4
    camera_output_channel: int = 8  # 8 seg classes (CARLA 0.9.10 reduced set)
    # output mode 12 flags
    pred_camera_seg: bool = True
    pred_route: bool = True
    pred_light_state: bool = True
    pred_light_dist: bool = False
    pred_bc: bool = True           # the bc stream (latent = visual ++ bc)
    # auxiliary head latent -> (dis, theta), supervising the PPO latent with
    # the route geometry at pretraining time, and its loss weight (the seg
    # and route terms are scaled by h*w and c*h*w, so a useful weight is
    # large); off by default, as in the reference
    pred_route_geom: bool = False
    route_geom_weight: float = 1.0
    in_bc_speed: bool = True        # speed feature added to the bc stream
    # blank the route-raster input plane (camera-route protocol)
    in_route_blank: bool = False
    image_height: int = 144
    image_width: int = 256
    feat_h: int = 5                 # encoder output geometry (stride 32)
    feat_w: int = 8
    # dual attention: "auto" or True call ops.dual_attention's
    # fused_dual_attention (the CUDA kernels on CUDA tensors, forward and
    # backward); False calls the plain versions
    use_fused_attention: object = "auto"

    @property
    def latent_dim(self) -> int:
        """PPO latent width: visual z ++ bc z."""
        return 2 * self.z_dims if self.pred_bc else self.z_dims


@dataclasses.dataclass(frozen=True)
class PerceptionTrainParams:
    """Pretraining: Adam with L2 weight decay, a linear warm-up then a
    cosine decay to 0 over max_epochs, and the light-state loss weight
    (the seg, route and bc weights of the JAX dataclass are read nowhere:
    the total loss fixes them at 1, 0.5 and 1)."""

    batch_size: int = 48
    lr: float = 1e-4
    betas: tuple = (0.9, 0.999)
    weight_decay: float = 5e-4
    max_epochs: int = 100
    warmup_epochs: int = 1
    w_light_state: float = 0.1


def danet_params(**overrides) -> DANetParams:
    return dataclasses.replace(DANetParams(), **overrides)
