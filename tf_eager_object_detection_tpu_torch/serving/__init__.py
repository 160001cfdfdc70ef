"""Serving export of the port (`export.py`)."""
