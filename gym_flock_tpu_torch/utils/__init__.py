"""Host utilities: the initial-formation generators."""
