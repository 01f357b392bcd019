"""Closed-loop rollouts of the port."""
