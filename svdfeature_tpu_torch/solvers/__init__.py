"""Trainers and the solver registry."""
