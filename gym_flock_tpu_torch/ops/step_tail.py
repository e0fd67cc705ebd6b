"""K8, the fused flocking rollout's step tail: the CUDA kernel's wrapper, its
plain PyTorch version and the dispatch between them.

After each step's pass, the rollout turns the Turner expert's four sums
into the action (``ops.flocking_sums.turner_action``), takes the Euler step
(:func:`integrate`), computes the reward (:func:`instant_cost`) and writes
the action and the reward into the trajectory's slots.  The JAX package
leaves this tail to XLA's fusion; it has no Pallas kernel.  The kernel
(``csrc/step_tail.cu``) does it in one launch, a warp or a block a swarm.

:func:`step_tail` routes by device: a CUDA tensor launches the kernel
(counted in :data:`launches`), which takes float32 and raises on anything
else; a CPU tensor takes the plain version :func:`step_tail_reference`, in
float32 or float64.  On the card the action and the next state are the
plain version's bit for bit (the kernel mirrors PyTorch's f32 sequence);
the reward sums the same velocities in f64 and in another order, so it
agrees with ``torch.var``'s f32 result to within that result's rounding.
"""
from __future__ import annotations

import ctypes

import torch

from gym_flock_tpu_torch.ops.flocking_sums import check_float_type, float4_rows, turner_action

__all__ = ["instant_cost", "integrate", "step_tail", "step_tail_reference"]

launches = 0  # K8 kernel launches in this process; only _launch adds to it


# ------------------------------------------------------------ plain version


def instant_cost(x: torch.Tensor) -> torch.Tensor:
    """``[B]`` minus the summed velocity variances (reference
    flocking_relative.py:145-147); ``correction=0`` is NumPy's ddof=0."""
    v = x[..., 2:4]
    return -1.0 * torch.var(v, dim=-2, correction=0).sum(dim=-1)


def integrate(x: torch.Tensor, u: torch.Tensor, dt,
              mask: torch.Tensor | None = None) -> torch.Tensor:
    """Euler double-integrator update (reference flocking_relative.py:98-105).

    ``dt`` is a float or a ``[B]`` tensor (one dt per swarm).  ``mask``
    (float ``[N]``, 0 = frozen agent) makes the masked agents ignore their
    control input (flocking_leader.py:27-31, flocking_obstacle.py:41-47).
    """
    if isinstance(dt, torch.Tensor) and dt.dim() == 1:
        dt = dt[:, None]
    ux, uy = u[..., 0], u[..., 1]
    if mask is not None:
        ux, uy = ux * mask, uy * mask
    px = x[..., 0] + x[..., 2] * dt + ux * dt * dt * 0.5
    py = x[..., 1] + x[..., 3] * dt + uy * dt * dt * 0.5
    vx = x[..., 2] + ux * dt
    vy = x[..., 3] + uy * dt
    return torch.stack((px, py, vx, vy), dim=-1)


def step_tail_reference(x, s_gx, s_gy, s_dvx, s_dvy, action_scalar, action_scale, dt, mask,
                        u_out, reward_out):
    """The plain version of :func:`step_tail`, with its contract."""
    u = turner_action(s_gx, s_gy, s_dvx, s_dvy, action_scalar)
    x_next = integrate(x, u * action_scale, dt, mask)
    u_out.copy_(u)
    reward_out.copy_(instant_cost(x_next))
    return x_next


# ------------------------------------------------------------------ kernel


def _check_inputs(x, sums, mask, u_out, reward_out) -> None:
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"x must be a torch.Tensor, got {type(x).__name__}")
    check_float_type("x", x)
    if x.dim() != 3 or x.shape[-1] != 4:
        raise ValueError(f"x must have shape [B, N, 4], got {tuple(x.shape)}")
    b, n, _ = x.shape
    named = [(f"s_{k}", t, (b, n)) for k, t in zip(("gx", "gy", "dvx", "dvy"), sums)]
    named += [("u_out", u_out, (b, n, 2)), ("reward_out", reward_out, (b,))]
    if mask is not None:
        named.append(("mask", mask, (n,)))
    for name, t, shape in named:
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor, got {type(t).__name__}")
        if t.dtype != x.dtype or t.device != x.device:
            raise TypeError(f"{name} must be {x.dtype} on {x.device}, got {t.dtype} on "
                            f"{t.device}")
        if t.shape != shape:
            raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")


def _launch(x, sums, action_scalar, action_scale, dt, mask, u_out, reward_out):
    global launches
    from gym_flock_tpu_torch.ops import _build

    b, n, _ = x.shape
    if u_out.stride(2) != 1 or (n > 1 and u_out.stride(1) != 2):
        raise ValueError(f"u_out must have contiguous [N, 2] rows, got strides "
                         f"{tuple(u_out.stride())}")
    if u_out.data_ptr() % 8 or (b > 1 and u_out.stride(0) % 2):
        raise ValueError("u_out's rows must be 8-byte aligned")
    x = float4_rows(x)
    x_next = torch.empty(b, n, 4, dtype=torch.float32, device=x.device)
    if b == 0 or n == 0:
        return x_next
    strides = (ctypes.c_longlong * 8)(*(s for t in sums for s in (t.stride(1), t.stride(0))))
    # the library makes x's card current for the launch, as K6's does
    card = x.device.index
    rc = _build.load().gft_step_tail(
        x.data_ptr(), *(t.data_ptr() for t in sums), strides,
        0 if mask is None else mask.contiguous().data_ptr(), b, n, float(action_scalar),
        float(action_scale), float(dt), u_out.data_ptr(), u_out.stride(0),
        reward_out.data_ptr(), reward_out.stride(0), x_next.data_ptr(), card,
        torch.cuda.current_stream(card).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"K8 (step_tail) launch failed: CUDA error {rc}")
    launches += 1
    return x_next


def step_tail(x, s_gx, s_gy, s_dvx, s_dvy, action_scalar, action_scale, dt, mask, u_out,
              reward_out) -> torch.Tensor:
    """One rollout step after its pass: returns ``x_next [B, N, 4]``.

    From the state ``x [B, N, 4]`` and the Turner expert's sums ``s_* [B,
    N]`` (any strides), the action ``turner_action(..., action_scalar)``
    goes into ``u_out [B, N, 2]``, the state moves by
    ``integrate(x, u * action_scale, dt, mask)`` (``dt`` a float, ``mask``
    ``None`` or ``[N]`` in x's type) and ``instant_cost(x_next)`` goes into
    ``reward_out [B]``.  On the card ``u_out``'s rows must be contiguous
    and 8-byte aligned (any batch stride; a trajectory's slot is).  The
    kernel on a CUDA tensor, the plain version on a CPU one; raises on
    anything else."""
    sums = (s_gx, s_gy, s_dvx, s_dvy)
    _check_inputs(x, sums, mask, u_out, reward_out)
    device = x.device.type
    if device == "cpu":
        return step_tail_reference(x, *sums, action_scalar, action_scale, dt, mask, u_out,
                                   reward_out)
    if device == "cuda":
        return _launch(x, sums, action_scalar, action_scale, dt, mask, u_out, reward_out)
    raise ValueError(f"step_tail runs on cpu or cuda, not {device}")
