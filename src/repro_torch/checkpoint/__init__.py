"""Fault-tolerant checkpointing."""
from repro_torch.checkpoint.manager import CheckpointManager
