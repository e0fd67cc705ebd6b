"""Agent-steps a second: swarms x agents x env-steps completed in the
window (its resets included) over the window's seconds; host clock."""


def read(run):
    return run.window.total("agent_steps") / run.window.seconds
