"""In the cells whose step the host leads: the port's host reads of device
values that gate its control flow, over the env-steps the process ran
through the port.  The count is the port's own counter
``gym_flock_tpu_torch.utils.profiling.syncs``, which covers the whole
process, so the steps are the process's too: the window's and those of the
set-up's warm-up (two full calls, the call that ends an episode where the
chunk does not divide it, and a reset).  A port without the counter gives
nothing to read."""


def read(run):
    if getattr(run.cell, "system_name", None) != "program":
        return None
    from gym_flock_tpu_torch.utils import profiling

    syncs = getattr(profiling, "syncs", None)
    if syncs is None:
        return None
    cell = run.cell
    warm = 2 * cell.chunk + cell.episode % cell.chunk
    return syncs / (run.window.total("steps") + warm)
