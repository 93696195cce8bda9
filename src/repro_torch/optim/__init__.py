"""repro_torch.optim — AdamW with optional int8 block-quantized moments."""
