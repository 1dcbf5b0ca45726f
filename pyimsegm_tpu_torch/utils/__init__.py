"""Utilities: IO, metrics, profiling, sample data."""


class ImageDimensionError(TypeError):
    """Two label maps (or an image and its annotation) of different
    shapes."""
