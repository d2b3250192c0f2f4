from repro_torch.models import cnn, layers
from repro_torch.models.cnn import CNN_MODELS, AlexNet, ResNet18, SqueezeNet

__all__ = ["cnn", "layers", "CNN_MODELS", "AlexNet", "ResNet18", "SqueezeNet"]
