"""Frozen core of the serving benchmark (see ``servebench/__init__``)."""
