"""Environment families: flocking (and its variants), coverage, shepherding,
formation flying, networked LQR, mapping and delayed-aggregation flocking."""
