"""Rollout loops over batches of envs."""
