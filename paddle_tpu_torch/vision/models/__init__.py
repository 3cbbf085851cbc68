"""The ResNet family (counterpart of ``paddle_tpu.vision.models``'s
``resnet.py`` names; the other models wait in ROADMAP.md Queue 1)."""
from .resnet import (ResNet, resnet18, resnet34, resnet50,  # noqa: F401
                     resnet101, resnet152, wide_resnet50_2, wide_resnet101_2)

__all__ = ["ResNet", "resnet18", "resnet34", "resnet50", "resnet101",
           "resnet152", "wide_resnet50_2", "wide_resnet101_2"]
