"""Synthetic benchmark scenes."""
