"""Model zoo: MobileNetV2 in PyTorch, its layers, and the weights bridge."""
