"""Launchers of the port: the serving entry point (``serve.py``)."""
