"""Command-line entry points of the port: ``python -m repro_torch.launch.sql``
(the SQL CLI) and ``python -m repro_torch.launch.serve`` (batched LM
serving)."""
