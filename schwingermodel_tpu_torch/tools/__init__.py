"""Command-line tools of the port (``python -m schwingermodel_tpu_torch.tools.<name>``)."""
