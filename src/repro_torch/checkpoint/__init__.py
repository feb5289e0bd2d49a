"""repro_torch.checkpoint — atomic, async numpy checkpoints."""
