"""Lie groups (Sim(3))."""
