"""Model components: Qwen2 LM, connectors, diffusion head, sigma-VAE tokenizers."""
