"""repro_torch.models: the decoder stack (dense decode path)."""
