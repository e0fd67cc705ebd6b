"""Agent-steps a second of the rollout loop in the cells whose step the host
leads: swarms x agents x env-steps over the seconds of the window's calls
that ran without the profiler (their resets included); host clock.  The
quantity ``agent_steps_per_s`` reads end to end, here read per layer: the
host's speed moves it past any bound these cells could hold."""
from portbench import readers


def read(run):
    seconds = readers.window_s_per_unit(run, "agent_steps")
    return 1.0 / seconds if seconds else None
