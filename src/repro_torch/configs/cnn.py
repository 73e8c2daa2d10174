"""The paper's two CNNs, ResNet-18 and MobileNetV3-Small, as the JAX
package configures them for its reproduction of Tables I/II: 32-px
synthetic images, 10 classes, the published block structure (depths,
strides, expansions) with widths scaled by ``width_mult``."""
from repro_torch.configs.base import CNNConfig


def config(arch: str) -> CNNConfig:
    if arch == "resnet18":
        return CNNConfig(name="resnet18", arch="resnet18", n_classes=10,
                         image_size=32, stem_channels=32)
    if arch == "mobilenetv3s":
        return CNNConfig(name="mobilenetv3s", arch="mobilenetv3s", n_classes=10,
                         image_size=32, stem_channels=16)
    raise KeyError(arch)
