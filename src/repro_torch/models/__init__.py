"""Models of the port (``repro.models`` counterpart): the CIFAR ResNet
and the dense decoder LM."""
