"""paddle_tpu_torch.models.vision: the ResNet family (ResNet-50 trains as
``bench.py:bench_resnet50`` runs it) and LeNet (as
``bench.py:bench_lenet_exec`` runs it, in static mode)."""
from .lenet import LeNet
from .resnet import (BasicBlock, BottleneckBlock, ResNet, resnet18,
                     resnet34, resnet50, resnet101, resnet152)

__all__ = ["LeNet", "ResNet", "BasicBlock", "BottleneckBlock", "resnet18",
           "resnet34", "resnet50", "resnet101", "resnet152"]
