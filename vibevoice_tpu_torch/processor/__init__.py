"""Host-side text and audio processing (own copies, no JAX)."""
