"""Environment families ported so far: flocking."""
