"""Samplers of the PyTorch port."""
