"""Ensembles of shock paths on one GPU (`parallel/ensemble.py`)."""
