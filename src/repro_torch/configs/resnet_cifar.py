"""ResNet-8..50 on CIFAR-10 — the paper's own case-study family."""
from ..models.resnet import ResNetConfig, resnet_config

DEPTHS = (8, 14, 20, 26, 32, 38, 44, 50)


def config(depth: int = 8) -> ResNetConfig:
    return resnet_config(depth)
