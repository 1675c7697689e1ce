"""Hand-written Hopper kernels (``csrc/*.cu``), their plain PyTorch
versions (``ref``) and the device-dispatching wrappers (``ops``)."""
