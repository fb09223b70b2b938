"""cobevt_tpu_torch.tools."""
