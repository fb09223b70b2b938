"""cobevt_tpu_torch.models.fusion."""
