"""The port's command-line demos (`python -m vibevoice_tpu_torch.demo.<name>`)."""
