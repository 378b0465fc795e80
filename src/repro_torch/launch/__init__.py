"""Command-line drivers of the port (``python -m repro_torch.launch.sql``)."""
