"""Synthetic depth scenes with analytic ground truth."""
