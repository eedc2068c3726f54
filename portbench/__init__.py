"""The benchmark of the PyTorch / CUDA port: see ``portbench/README.md``."""
