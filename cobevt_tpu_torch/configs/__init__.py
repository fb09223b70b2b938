"""cobevt_tpu_torch.configs."""
