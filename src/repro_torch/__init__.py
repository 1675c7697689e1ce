"""PyTorch/CUDA port of the FlexRank serving stack for NVIDIA Hopper.

Mirrors the layout of the JAX package (``repro``) module for module; the
kernels that package wrote in Pallas are hand-written CUDA C++ here
(``kernels/csrc``), each with a plain PyTorch version beside it. A wrapper
takes the plain version only for a tensor on the CPU; for a CUDA tensor it
launches its kernel or raises. Entry points (``serving.ElasticEngine``,
``launch.serve``) run on the card unless the caller asks for the CPU.
"""
import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the card: ``cuda``, or a clear error when CUDA is
    absent. Any other value is taken as given (``"cpu"`` for tests)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on an NVIDIA GPU by default and CUDA is not "
                "available here; pass device='cpu' to run the plain PyTorch "
                "versions of the kernels on the CPU")
        device = "cuda"
    return torch.device(device)
