"""paddle_tpu_torch.models.vision: the ResNet family (ResNet-50 trains as
``bench.py:bench_resnet50`` runs it)."""
from .resnet import (BasicBlock, BottleneckBlock, ResNet, resnet18,
                     resnet34, resnet50, resnet101, resnet152)

__all__ = ["ResNet", "BasicBlock", "BottleneckBlock", "resnet18",
           "resnet34", "resnet50", "resnet101", "resnet152"]
