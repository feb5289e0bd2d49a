"""repro_torch.train — loss, train state and the training step."""
