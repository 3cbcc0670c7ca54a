"""Launchers of the port: ``serve``, ``train``."""
