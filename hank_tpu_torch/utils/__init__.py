"""Disk caching of steady states and the steady-state Jacobian."""
