"""Command-line entry points of the port (``python -m bodyfitting_torch.apps.genebody``)."""
