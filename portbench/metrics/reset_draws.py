"""Draws a reset made, on the mean over the window's resets: the port's own
counter ``env.last_reset_tries``, read after each ``reset_env``."""
import statistics


def read(run):
    draws = getattr(run.cell, "reset_draws", None)
    return statistics.fmean(draws) if draws else None
