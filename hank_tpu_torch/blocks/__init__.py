"""Household blocks: backward EGM recursion, forward push-forward, assembly."""
