from eventgrad_tpu_torch.models.resnet import BasicBlock, ResNet, ResNet18

__all__ = ["BasicBlock", "ResNet", "ResNet18"]
