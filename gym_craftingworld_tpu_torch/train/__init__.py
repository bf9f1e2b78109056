"""Trainers of the port. So far: the fast PPO loop over the packed engine."""
