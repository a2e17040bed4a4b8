from eventgrad_tpu_torch.models.cnn import CNN1, CNN2, LeNetCifar
from eventgrad_tpu_torch.models.mlp import MLP
from eventgrad_tpu_torch.models.resnet import (
    BasicBlock, ResNet, ResNet18, ResNet34,
)


def _bottleneck(name: str):
    def refuse(**kw):
        raise NotImplementedError(
            f"{name} is built of Bottleneck blocks, which are not ported "
            "yet (models/resnet.py takes BasicBlock only)"
        )

    refuse.__name__ = name
    return refuse


#: the JAX package's registry keys; the Bottleneck ResNets raise
MODEL_REGISTRY = {
    "mlp": MLP,
    "cnn1": CNN1,
    "cnn2": CNN2,
    "lenet_cifar": LeNetCifar,
    "resnet18": ResNet18,
    "resnet34": ResNet34,
    "resnet50": _bottleneck("ResNet50"),
    "resnet101": _bottleneck("ResNet101"),
    "resnet152": _bottleneck("ResNet152"),
}

__all__ = ["BasicBlock", "CNN1", "CNN2", "LeNetCifar", "MLP",
           "MODEL_REGISTRY", "ResNet", "ResNet18", "ResNet34"]
