"""repro_torch.optim — AdamW, LR schedules and gradient compression."""
