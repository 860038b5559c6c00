"""Perception-encoder configuration: the fields of
cadre_tpu.configs.danet_config.DANetParams and PerceptionTrainParams, with
the same defaults (the reference's production setup: input mode 9, camera
+ route raster + speed for the bc head; output mode 12, camera seg of 8
classes + route reconstruction + traffic-light state + behaviour cloning;
ResNet18, DANet head 512 -> 128 channels of attention, InterTaskAtt
'transformer' with inter_att_dims 512 and z_dims 256, so a 512-wide
latent), and the reference's input/output mode tables (`INPUT_MODES`,
`OUTPUT_MODES`, `params_for_modes`), which the experiment zoo
(configs/experiments.py) expands into these fields."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class DANetParams:
    net_name: str = "autoencoder"
    model_name: str = "danet"
    backbone: str = "resnet18"
    input_channel: int = 4          # rgb (3) + route raster (1), input mode 9
    da_feature_channel: int = 512
    inter_att_dims: int = 512
    z_dims: int = 256
    att_type: str = "transformer"   # 'transformer' | 'position' | 'invaild'
    light_classes_num: int = 4
    camera_output_channel: int = 8  # 8 seg classes (CARLA 0.9.10 reduced set)
    left_camera_output_channel: int = 3
    right_camera_output_channel: int = 3
    # output mode 12 flags
    pred_camera_seg: bool = True
    pred_left_camera_seg: bool = False
    pred_right_camera_seg: bool = False
    pred_route: bool = True
    pred_light_state: bool = True
    pred_light_dist: bool = False
    pred_lidar: bool = False
    pred_topdown_rgb: bool = False
    pred_topdown_seg: bool = False
    pred_bc: bool = True           # the bc stream (latent = visual ++ bc)
    # auxiliary head latent -> (dis, theta), supervising the PPO latent with
    # the route geometry at pretraining time, and its loss weight (the seg
    # and route terms are scaled by h*w and c*h*w, so a useful weight is
    # large); off by default, as in the reference
    pred_route_geom: bool = False
    route_geom_weight: float = 1.0
    in_bc_speed: bool = True        # speed feature added to the bc stream
    in_route: bool = True
    # blank the route-raster input plane (camera-route protocol)
    in_route_blank: bool = False
    # the rest of the input-mode flags
    in_backbone: int = 1            # stacked camera frames
    in_lidar: bool = False
    in_left_camera: bool = False
    in_right_camera: bool = False
    in_speed: bool = False          # speed as an extra input plane
    input_mode: int = 9
    output_mode: int = 12
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


# ---------------------------------------------------------------------------
# The reference's experiment grid: input and output modes as DANetParams
# field updates (the JAX package's tables, copied).

INPUT_MODES = {
    1: dict(in_backbone=1, in_lidar=False, in_route=False),
    2: dict(in_backbone=4, in_lidar=False, in_route=False),
    3: dict(in_backbone=1, in_lidar=True, in_route=False),
    4: dict(in_backbone=4, in_lidar=True, in_route=False),
    5: dict(in_backbone=1, in_lidar=False, in_route=True),
    6: dict(in_backbone=1, in_lidar=False, in_route=True,
            in_left_camera=True, in_right_camera=True),
    7: dict(in_backbone=1, in_lidar=False, in_route=True, in_speed=True),
    8: dict(in_backbone=1, in_lidar=True, in_route=True, in_speed=True),
    9: dict(in_backbone=1, in_lidar=False, in_route=True, in_bc_speed=True),
    10: dict(in_backbone=1, in_lidar=False, in_route=False,
             in_bc_speed=True),
}

_IN_DEFAULTS = dict(in_left_camera=False, in_right_camera=False,
                    in_speed=False, in_bc_speed=False)

OUTPUT_MODES = {
    0: dict(),                                    # plain rgb reconstruction
    1: dict(pred_light_state=True, pred_light_dist=True),
    2: dict(pred_topdown_rgb=True, pred_light_state=True,
            pred_light_dist=True),
    3: dict(pred_light_state=True, pred_light_dist=True,
            pred_topdown_seg=True),
    4: dict(pred_lidar=True, pred_light_state=True, pred_light_dist=True),
    5: dict(pred_lidar=True, pred_topdown_rgb=True, pred_light_state=True,
            pred_light_dist=True),
    6: dict(pred_lidar=True, pred_topdown_seg=True, pred_light_state=True,
            pred_light_dist=True),
    7: dict(pred_camera_seg=True),
    8: dict(pred_camera_seg=True, pred_route=True),
    9: dict(pred_camera_seg=True, pred_route=True, pred_light_state=True),
    10: dict(pred_camera_seg=True, pred_left_camera_seg=True,
             pred_right_camera_seg=True, pred_route=True),
    11: dict(pred_camera_seg=True, pred_left_camera_seg=True,
             pred_right_camera_seg=True, pred_route=True,
             pred_light_state=True),
    12: dict(pred_camera_seg=True, pred_route=True, pred_light_state=True,
             pred_bc=True),
    13: dict(pred_camera_seg=True, pred_light_state=True),
    14: dict(pred_camera_seg=True, pred_light_state=True, pred_bc=True),
}

_OUT_DEFAULTS = dict(pred_light_state=False, pred_light_dist=False,
                     pred_camera_seg=False, pred_left_camera_seg=False,
                     pred_right_camera_seg=False, pred_route=False,
                     pred_bc=False, pred_lidar=False, pred_topdown_rgb=False,
                     pred_topdown_seg=False)


def params_for_modes(input_mode: int, output_mode: int,
                     **overrides) -> DANetParams:
    """(input_mode, output_mode) -> DANetParams with the reference's
    channel arithmetic: 3 input planes per stacked camera view (and per
    left/right camera and lidar), one per route raster, one for speed;
    each camera head 8-class seg where predicted, 3-channel recon
    otherwise."""
    fields = dict(_IN_DEFAULTS)
    fields.update(INPUT_MODES[input_mode])
    fields.update(_OUT_DEFAULTS)
    fields.update(OUTPUT_MODES[output_mode])
    nb = fields["in_backbone"]
    channels = nb * 3
    for flag, per_frame in (("in_left_camera", 3), ("in_right_camera", 3),
                            ("in_lidar", 3), ("in_route", 1)):
        if fields.get(flag):
            channels += nb * per_frame
    if fields.get("in_speed"):
        channels += 1
    fields["input_channel"] = channels
    for side in ("", "left_", "right_"):
        fields[f"{side}camera_output_channel"] = \
            8 if fields[f"pred_{side}camera_seg"] else 3
    fields["input_mode"] = input_mode
    fields["output_mode"] = output_mode
    fields.update(overrides)
    return dataclasses.replace(DANetParams(), **fields)
