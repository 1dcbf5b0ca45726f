"""Frozen copy of the port's plain PyTorch paths (no hand kernel)."""
