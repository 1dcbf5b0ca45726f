"""Annotation handling CLIs (relabel, inpaint, colour conversion,
quantisation, overlaps)."""
