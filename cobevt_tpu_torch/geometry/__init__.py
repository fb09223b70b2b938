"""cobevt_tpu_torch.geometry."""
