"""Experiment applications: argparse + YAML driven, file-in / file-out
CLIs (port of the JAX package's ``apps/``).

Each app runs as ``python -m pyimsegm_tpu_torch.apps.<name>``, with the JAX
app's parameters, flags and output layout, plus ``--device`` (default
``cuda``; ``cpu`` runs the plain PyTorch path).
"""
