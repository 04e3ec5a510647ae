"""CIFAR-10 input pipeline: the host loader and on-device augmentation."""
