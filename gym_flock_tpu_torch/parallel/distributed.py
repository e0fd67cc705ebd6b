"""Process groups, device meshes and per-rank random streams (counterpart of
``gym_flock_tpu/parallel/distributed.py``).

Scale-out in the port is ``torch.distributed``: one process a rank, each on
its card (NCCL) or on the host (gloo, as the CPU tests run it).  The data
layout is the JAX package's:

* the env-batch axis splits over the ranks (envs are independent, so a
  step makes no collective); the model and the optimizer are replicated,
  and the gradients' mean is one all-reduce a step;
* an agent axis, where a swarm is split too, is the ``"ap"`` dimension of
  :func:`gym_flock_tpu_torch.parallel.agent_shard.make_flock_mesh`;
* per-rank randomness comes from :func:`host_fold`: one seed, folded with
  the rank.

Nothing here falls back silently: a failed :func:`initialize` raises, and so
does every function that needs a process group when none was set up.
"""
from __future__ import annotations

import hashlib
import os
from datetime import timedelta
from typing import Optional

import torch
import torch.distributed as dist

__all__ = ["initialize", "global_env_mesh", "host_fold", "local_shard_size",
           "mesh_device_type", "rank_generator"]


def initialize(backend: str = "nccl", init_method: Optional[str] = None,
               world_size: Optional[int] = None, rank: Optional[int] = None,
               timeout_s: Optional[float] = None) -> None:
    """``torch.distributed.init_process_group`` with the rendezvous given.

    ``init_method`` is a ``tcp://host:port`` or ``file://path`` address
    (``None`` reads ``MASTER_ADDR``/``MASTER_PORT`` from the environment);
    ``world_size`` and ``rank`` say where this process stands.  NCCL (the
    default) first makes a card this process's device: ``rank %
    device_count``, or, when ``rank`` comes from the environment, its
    ``LOCAL_RANK`` (else its ``RANK``, else 0) modulo the card count, so
    that the ranks of one host each take a card of their own.  Any failure
    raises, a second call included: unlike the JAX package's
    ``initialize``, nothing is swallowed.
    """
    if dist.is_initialized():
        raise RuntimeError("torch.distributed is already initialized")
    if backend == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError("the nccl backend needs a CUDA device; none is available")
        card = rank
        if card is None:
            card = int(os.environ.get("LOCAL_RANK", os.environ.get("RANK", "0")))
        torch.cuda.set_device(card % torch.cuda.device_count())
    kwargs = {}
    if timeout_s is not None:
        kwargs["timeout"] = timedelta(seconds=timeout_s)
    dist.init_process_group(backend=backend, init_method=init_method,
                            world_size=-1 if world_size is None else world_size,
                            rank=-1 if rank is None else rank, **kwargs)


def mesh_device_type() -> str:
    """The device type the process group's backend runs on: ``"cuda"`` for
    NCCL, ``"cpu"`` for gloo."""
    backend = dist.get_backend()
    if backend == "nccl":
        return "cuda"
    if backend == "gloo":
        return "cpu"
    raise ValueError(f"no device type known for the {backend!r} backend")


def global_env_mesh(axis_name: str = "env"):
    """A 1-D ``DeviceMesh`` over every rank (the env-batch, or dp, axis)."""
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(mesh_device_type(), (dist.get_world_size(),),
                            mesh_dim_names=(axis_name,))


def _fold(seed: int, rank: int) -> int:
    digest = hashlib.sha256(f"{int(seed)}:{int(rank)}".encode()).digest()
    return int.from_bytes(digest[:8], "little") & ((1 << 63) - 1)


def host_fold(seed: int, rank: Optional[int] = None, device="cpu") -> torch.Generator:
    """A generator on ``device`` seeded from ``seed`` and ``rank`` (this
    process's rank in the default group when ``None``): the same seed gives
    every rank a stream of its own."""
    if rank is None:
        rank = dist.get_rank()
    return torch.Generator(device=device).manual_seed(_fold(seed, rank))


def rank_generator(generator: torch.Generator, group=None) -> torch.Generator:
    """This rank's generator for one sharded step: one seed drawn from
    ``generator`` (which every rank holds in the same state, so the draw
    keeps them in step), folded with the rank in ``group``
    (:func:`host_fold`)."""
    seed = int(torch.randint(0, 1 << 62, (1,), generator=generator, device=generator.device))
    return host_fold(seed, dist.get_rank(group), generator.device)


def local_shard_size(n_global: int, group=None) -> int:
    """Rows of a batch of ``n_global`` split over the ranks of ``group``
    that this rank holds; raises where they do not divide."""
    world = dist.get_world_size(group)
    if n_global % world:
        raise ValueError(f"{n_global} rows do not split over {world} ranks")
    return n_global // world
