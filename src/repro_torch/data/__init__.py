"""Synthetic data of the paper's shapes and the non-IID partitioner."""
