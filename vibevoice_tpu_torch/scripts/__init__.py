"""The port's scripts (`python -m vibevoice_tpu_torch.scripts.<name>`)."""
