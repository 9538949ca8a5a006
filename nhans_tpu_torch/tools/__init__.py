"""Diagnostic scripts and checkpoint tools for the port (run with
``python -m``)."""
