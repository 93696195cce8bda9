"""repro_torch.train — the training step (loss, gradient accumulation,
AdamW) and the loop around it (checkpoints, straggler monitor, the
grad-drift precision schedule)."""
