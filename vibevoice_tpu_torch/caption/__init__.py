"""Caption generation: script timing (`simple`) and optional STT (`whisper`)."""
