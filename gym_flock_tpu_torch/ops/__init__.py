"""Pairwise operations: dense helpers (``pairwise``) and the K1 kernel's
wrapper with its plain version (``flocking_sums``)."""
