"""Hand-written Hopper kernels of the port, each beside its plain version.

A wrapper given a CPU tensor computes its plain PyTorch version; given a
CUDA tensor it launches its kernel or raises. Every wrapper counts its
kernel launches in a plain integer attribute, ``<wrapper>.launches``. The
wrappers on the training path are ``torch.autograd.Function``s, so a kernel
output carries its gradient.
"""
