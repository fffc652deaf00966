"""VGG-16 on CIFAR-10 — the paper's own experimental model (Sec. VII).

13 conv + 3 FC layers = 16 HSFL-cuttable units. The paper's Fig. 2 uses cut
layers L1=3, L2=8 on this network.
"""
from ..models.vgg import VggSpec

SPEC = VggSpec(
    name="vgg16-cifar10",
    conv_channels=(64, 64, 128, 128, 256, 256, 256, 512, 512, 512, 512, 512, 512),
    pool_after=(1, 3, 6, 9, 12),  # conv indices followed by 2x2 maxpool
    fc_dims=(512, 512, 10),
    image_size=32,
    in_channels=3,
    num_classes=10,
)

REDUCED = VggSpec(
    name="vgg16-reduced",
    conv_channels=(16, 16, 32),
    pool_after=(0, 2),
    fc_dims=(64, 10),
    image_size=16,
    in_channels=3,
    num_classes=10,
)
