"""Helpers shared across the port."""
