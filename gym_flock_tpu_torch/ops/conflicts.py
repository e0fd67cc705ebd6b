"""K7, the coverage step's movement-conflict resolution: the CUDA kernel's
wrapper and its plain PyTorch version.

Over ``[B, R]`` robots, upstream's two sequential passes (gym-flock
coverage.py:186-201): pass 1 lets every robot whose choice is its current
node claim it; pass 2 walks the robots in index order, and robot i moves to
``chosen[i]`` unless that id already appears in the partly filled result,
else it stays at ``cur[i]``.  Ids are node ids >= 0.

The plain version is the JAX package's vectorized fixed point
(``gym_flock_tpu/envs/coverage.py:_resolve_conflicts``), which resolves in
rounds and reads the host once a round to test whether any robot is still
pending (``utils.profiling.host_bool``).  The kernel (``csrc/conflicts.cu``)
runs the two passes themselves, one warp a world, in one launch with no
host read.

Dispatch is by the device of the inputs: CPU tensors take the plain version,
CUDA tensors launch the kernel (built at first use) or raise, any other
device raises.
"""
from __future__ import annotations

import torch

from gym_flock_tpu_torch.utils.profiling import host_bool

__all__ = ["MAX_ROBOTS", "resolve_conflicts", "resolve_conflicts_reference"]

MAX_ROBOTS = 1024  # the kernel keeps a world's result in 4 KB of shared memory

launches = 0  # K7 kernel launches in this process; only _launch adds to it


def resolve_conflicts_reference(cur: torch.Tensor, chosen: torch.Tensor):
    """The plain version: ``(next_locs, rounds)`` by the fixed point, any
    integer type and device.

    A robot resolves in a round when no smaller-indexed robot is still
    pending a claim that could affect ``chosen[i]``; each round resolves at
    least the lowest pending index, so there are at most R rounds.  Each
    round costs one host read (the "any env still pending" test), and one
    more ends the loop.
    """
    r = cur.shape[1]
    idx = torch.arange(r, device=cur.device)
    j_lt_i = idx[None, :] < idx[:, None]  # [i, j]
    nl = torch.where(chosen == cur, chosen, -1)
    is_stay = nl >= 0  # pass-1 claims, visible to every robot
    # claims of still-pending smaller-indexed robots that could take chosen[i]
    conflict = j_lt_i & (
        (chosen[:, None, :] == chosen[:, :, None]) | (cur[:, None, :] == chosen[:, :, None])
    )
    rounds = 0
    while True:
        pending = nl == -1
        if not host_bool(pending.any()):
            return nl, rounds
        rounds += 1
        visible = is_stay[:, None, :] | (j_lt_i & ~pending[:, None, :])
        definitely_taken = (visible & (nl[:, None, :] == chosen[:, :, None])).any(dim=2)
        maybe_taken = (conflict & pending[:, None, :]).any(dim=2)
        resolve_now = pending & ~maybe_taken
        nl = torch.where(resolve_now, torch.where(definitely_taken, cur, chosen), nl)


def _check_inputs(cur, chosen):
    for name, x in (("cur", cur), ("chosen", chosen)):
        if not isinstance(x, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor, got {type(x).__name__}")
        if x.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {x.dtype}")
        if x.dim() != 2:
            raise ValueError(f"{name} must be [B, R], got shape {tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if cur.shape != chosen.shape:
        raise ValueError(f"cur and chosen differ in shape: {tuple(cur.shape)} and "
                         f"{tuple(chosen.shape)}")
    if cur.shape[1] > MAX_ROBOTS:
        raise ValueError(f"R must be at most {MAX_ROBOTS}, got {cur.shape[1]}")
    if cur.device != chosen.device:
        raise ValueError(f"inputs on {cur.device} and {chosen.device}")


def _launch(cur, chosen):
    global launches
    from gym_flock_tpu_torch.ops import _build

    b, r = cur.shape
    out = torch.empty(b, r, dtype=torch.int32, device=cur.device)
    if b == 0 or r == 0:
        return out
    lib = _build.load()
    with torch.cuda.device(cur.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.gft_resolve_conflicts(cur.data_ptr(), chosen.data_ptr(), out.data_ptr(), b, r,
                                       stream)
    if rc != 0:
        raise RuntimeError(f"K7 (resolve_conflicts) launch failed: CUDA error {rc}")
    launches += 1
    return out


def resolve_conflicts(cur: torch.Tensor, chosen: torch.Tensor) -> torch.Tensor:
    """``[B, R]`` int32 next locations from ``cur`` and ``chosen``, contiguous
    ``[B, R]`` int32 node ids >= 0, R <= :data:`MAX_ROBOTS`; raises on
    anything else.  The ids are not read on the host: on the card an id
    below 0 gives an unspecified result."""
    _check_inputs(cur, chosen)
    device = cur.device.type
    if device == "cpu":
        return resolve_conflicts_reference(cur, chosen)[0]
    if device == "cuda":
        return _launch(cur, chosen)
    raise ValueError(f"resolve_conflicts runs on cpu or cuda, not {device}")
