"""Launchers of the port: the serving (``serve.py``) and training
(``train.py``) entry points."""
