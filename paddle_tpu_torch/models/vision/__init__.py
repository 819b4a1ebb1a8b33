"""paddle_tpu_torch.models.vision: the ResNet family (ResNet-50 trains as
``bench.py:bench_resnet50`` runs it), VGG and MobileNet V1/V2 (trained
the same way by ``chip_smoke.py``'s phase 26) and LeNet (as
``bench.py:bench_lenet_exec`` runs it, in static mode)."""
from .lenet import LeNet
from .mobilenet import MobileNetV1, MobileNetV2
from .resnet import (BasicBlock, BottleneckBlock, ResNet, resnet18,
                     resnet34, resnet50, resnet101, resnet152)
from .vgg import VGG, vgg11, vgg13, vgg16, vgg19

__all__ = ["LeNet", "ResNet", "BasicBlock", "BottleneckBlock", "resnet18",
           "resnet34", "resnet50", "resnet101", "resnet152", "VGG", "vgg11",
           "vgg13", "vgg16", "vgg19", "MobileNetV1", "MobileNetV2"]
