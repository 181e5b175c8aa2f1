"""Launchers of the port: ``serve`` (``python -m repro_torch.launch.serve``) and ``fleet`` (its ``--fleet``)."""
