"""Weight bridges into the PyTorch port."""
