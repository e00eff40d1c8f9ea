"""Command-line entry points of the PyTorch/CUDA port."""
