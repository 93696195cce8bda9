"""repro_torch.checkpoint — fault-tolerant checkpoints of the training
state (the reference's on-disk layout)."""
from repro_torch.checkpoint.manager import CheckpointManager  # noqa: F401
