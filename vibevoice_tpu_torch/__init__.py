"""PyTorch/CUDA port of VibeVoice-TPU (see README, section PyTorch/CUDA port)."""
