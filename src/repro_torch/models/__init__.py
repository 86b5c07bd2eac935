"""Models of the port (``repro.models`` counterpart): the CIFAR ResNet
and the decoder LM's dense, MoE, SSM and hybrid patterns."""
