"""Agent-steps a second in the cells whose step the device leads: swarms x
agents x env-steps completed in the window (its resets included) over the
window's seconds; host clock.  The same quantity as ``agent_steps_per_s``,
under a name of its own so that its bound holds only these cells."""


def read(run):
    return run.window.total("agent_steps") / run.window.seconds
