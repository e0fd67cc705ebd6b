"""Host utilities: the initial-formation generators, the AirSim settings
parser and the profiling helpers."""
