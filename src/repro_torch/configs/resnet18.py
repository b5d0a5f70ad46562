"""resnet18: the paper's own model (N2UQ-quantised ResNet-18, §6.1), port
of ``repro.configs.resnet18``.  Used by the compile-and-execute path
(``models/resnet.py``): every basic-block conv compiles to a TLMAC plan
and runs as a lookup conv."""

from repro_torch.models.resnet import ResNetConfig

CONFIG = ResNetConfig(name="resnet18", w_bits=3, a_bits=3)
SMOKE = ResNetConfig(
    name="resnet18-smoke", w_bits=3, a_bits=3, width=16,
    stages=((16, 1, 1), (32, 1, 2)), num_classes=10, in_hw=16,
)
