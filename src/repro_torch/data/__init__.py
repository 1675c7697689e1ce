"""Data substrate: synthetic + memmap token pipelines (numpy only, a copy
of the JAX package's ``data/pipeline.py``; batches are equal bit for bit)."""
from repro_torch.data.pipeline import (MemmapTokens, SyntheticTokens,
                                       calibration_batches, host_batch_slice,
                                       make_source)
