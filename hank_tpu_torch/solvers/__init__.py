"""Steady states, the steady-state Jacobian and the path solvers."""
