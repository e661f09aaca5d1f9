"""Command-line tools of the port (``python -m bodyfitting_torch.tools.*``)."""
