"""Host-side utilities of the port: tokenizer, images, checkpoints."""
