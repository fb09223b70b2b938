"""cobevt_tpu_torch.utils."""
