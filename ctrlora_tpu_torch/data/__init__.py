"""Datasets of the PyTorch port."""
