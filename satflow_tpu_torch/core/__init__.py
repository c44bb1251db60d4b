"""Model registry of the PyTorch port."""
