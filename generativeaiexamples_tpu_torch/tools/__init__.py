"""Command-line tools of the PyTorch/CUDA port."""
