"""Generation engine and streaming transport."""
