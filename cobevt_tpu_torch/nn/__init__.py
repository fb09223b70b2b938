"""cobevt_tpu_torch.nn."""
