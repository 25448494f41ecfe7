"""Command-line entry points of the PyTorch port (``python -m
ctrlora_tpu_torch.scripts.<name>``)."""
