"""Data parallelism: `mesh.py`."""
