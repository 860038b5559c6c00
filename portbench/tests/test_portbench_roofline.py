"""The yardstick at known shapes: PERF.md's "Bound ms" figures for K1, K2
and K3, ResNet FLOPs against their published counts, and the MFU
counts."""
import pytest

from portbench.core import roofline as rf


def test_k2_least_time_matches_the_bound_column():
    # PERF.md §6: bf16 B=32 0.000514 ms (bytes), f32 B=48 0.00174 (ops)
    assert rf.k2_least_s(32, 40, 128, 16, True) * 1e3 == \
        pytest.approx(0.000514, rel=2e-3)
    assert rf.k2_least_s(48, 40, 128, 16, False) * 1e3 == \
        pytest.approx(0.00174, rel=5e-3)
    # wide: C=512, Cqk=64, B=48 f32 0.02387 (ops); B=256 bf16 0.01643
    assert rf.k2_least_s(48, 40, 512, 64, False) * 1e3 == \
        pytest.approx(0.02387, rel=2e-3)
    assert rf.k2_least_s(256, 40, 512, 64, True) * 1e3 == \
        pytest.approx(0.01643, rel=2e-3)


def test_k3_least_time_matches_the_bound_column():
    assert rf.k3_least_s(48, 40, 128, 16) * 1e3 == \
        pytest.approx(0.00399, rel=5e-3)
    assert rf.k3_least_s(48, 40, 512, 64) * 1e3 == \
        pytest.approx(0.05539, rel=2e-3)
    assert rf.k3_least_s(48, 475, 512, 64) * 1e3 == \
        pytest.approx(1.01774, rel=2e-3)


def test_paint_least_time_is_bytes_at_hbm_speed():
    # one env step at N=32: fig 256x144x1 and rgb 144x256x3 canvases
    n = 32
    base = n * 256 * 144 * 1 + n * 144 * 256 * 3
    t = rf.paint_least_s(base, 0)
    assert t == pytest.approx(2 * base * 4 / 3.35e12)


def test_share_is_least_over_device_time():
    assert rf.share_pct([1.0, 1.0], [4.0, 4.0]) == pytest.approx(25.0)
    assert rf.share_pct([], [1.0]) is None
    assert rf.share_pct([1.0], [0.0]) is None


@pytest.mark.parametrize("arch,gmacs", [("resnet18", 1.814),
                                        ("resnet50", 4.087)])
def test_backbone_flops_match_published_counts(arch, gmacs):
    # torchvision's counts at 224x224 (fc included: 0.5 and 2.0 MMACs)
    fc = {"resnet18": 512 * 1000, "resnet50": 2048 * 1000}[arch]
    f, c, h, w = rf.backbone_flops(arch, 3, 224, 224)
    assert (f / 2 + fc) / 1e9 == pytest.approx(gmacs, rel=0.01)
    assert (h, w) == (7, 7)


def test_bank_and_iteration_counts():
    # one row, one frame: the LSTM's 4 gates over input and hidden, and
    # the two 3-layer MLPs
    f, h = 530, 128
    one = rf.bank_flops(1, 1, f, h, 33)
    assert one == 2.0 * (4 * f * 2 * f + f * h + h * h + h * 33
                         + f * h + h * h + h)
    cfg = dict(backbone="resnet18", input_channel=4, image_height=144,
               image_width=256, da_feature_channel=512, inter_att_dims=512,
               z_dims=256)
    it = rf.ppo_iteration_flops(cfg, 2048, 25, 8, f, h, (33, 3), 4, 2)
    assert it > 26 * 2048 * rf.latent_flops(cfg)
    assert rf.pretrain_step_flops(dict(cfg, feat_h=5, feat_w=8,
                                       camera_output_channel=8,
                                       light_classes_num=4), 48) > 0
