from eventgrad_tpu_torch.models.cnn import CNN1, CNN2, LeNetCifar
from eventgrad_tpu_torch.models.mlp import MLP
from eventgrad_tpu_torch.models.resnet import (
    BasicBlock, Bottleneck, ResNet, ResNet18, ResNet34, ResNet50, ResNet101,
    ResNet152,
)

#: the JAX package's registry keys
MODEL_REGISTRY = {
    "mlp": MLP,
    "cnn1": CNN1,
    "cnn2": CNN2,
    "lenet_cifar": LeNetCifar,
    "resnet18": ResNet18,
    "resnet34": ResNet34,
    "resnet50": ResNet50,
    "resnet101": ResNet101,
    "resnet152": ResNet152,
}

__all__ = ["BasicBlock", "Bottleneck", "CNN1", "CNN2", "LeNetCifar", "MLP",
           "MODEL_REGISTRY", "ResNet", "ResNet18", "ResNet34", "ResNet50",
           "ResNet101", "ResNet152"]
