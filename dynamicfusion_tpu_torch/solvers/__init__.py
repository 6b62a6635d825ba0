"""Solvers: rigid projective ICP."""
