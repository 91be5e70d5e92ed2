"""Data parallel over processes (parallel/ddp.py)."""
