"""Launchers of the port: ``python -m repro_torch.launch.train``.  The
reference's mesh, dry-run and serving launchers belong to the multi-device
slice (ROADMAP.md §A)."""
