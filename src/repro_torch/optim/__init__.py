"""Optimizers: AdamW with schedules and global-norm clipping."""
from repro_torch.optim import adamw
from repro_torch.optim.adamw import (AdamWConfig, AdamWState, apply_updates,
                                     init)
