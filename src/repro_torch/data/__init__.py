"""repro_torch.data — the synthetic token pipeline and the MNIST stand-in."""
