"""Device-mesh helpers for data-parallel Monte-Carlo and design sweeps."""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

__all__ = ["dp_mesh", "dp_mesh_2d", "make_dp_step", "make_dp_step_2d",
           "multihost_init"]


def dp_mesh(n_devices: int | None = None, axis: str = "dp") -> Mesh:
    """1-D mesh over the first n devices (default: all)."""
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    import numpy as np

    return Mesh(np.array(devs), (axis,))


def make_dp_step(step_fn, mesh: Mesh, axis: str = "dp"):
    """SPMD-wrap a per-device MC step, keyed by GLOBAL batch index.

    step_fn(key, sigma) -> dict of scalar counters.  The wrapped function
    has signature (key_snr, sigma, gb0): device i runs global batch
    gb0 + i with key fold_in(key_snr, gb0 + i) — the SAME per-batch key
    stream a single-device run uses, so Monte-Carlo counters are exactly
    invariant to the mesh size (the reference's reproducibility contract,
    LDPC_BER_Sim.cpp:129: same seed -> same results file, which its
    per-process seed offsets only guaranteed per fixed process count).
    Counters come back UN-reduced as (n_devices,) vectors in global-batch
    order; the host applies the sequential early-exit rules exactly as a
    single-device run would and sums (replacing the offline result
    merging of scripts/aggregate_results.m; partial sums are fine to
    psum in-device when the caller does not need sequential-stop
    exactness).
    """
    n = mesh.shape[axis]

    @jax.jit
    @partial(shard_map, mesh=mesh, in_specs=(P(), P(), P()),
             out_specs=P(), check_vma=False)
    def wrapped(key_snr, sigma, gb0):
        gb = gb0 + jax.lax.axis_index(axis)
        counts = step_fn(jax.random.fold_in(key_snr, gb), sigma)
        # all_gather (not psum): the host needs per-batch counters to
        # apply sequential stop rules; replicated so every process of a
        # multi-host mesh can read them without cross-host addressing
        return jax.tree.map(
            lambda x: jax.lax.all_gather(jnp.asarray(x), axis), counts)

    wrapped.n_devices = n
    return wrapped


def dp_mesh_2d(n_snr: int, n_devices: int | None = None,
               axes: tuple = ("snr", "dp")) -> Mesh:
    """2-D (snr x batch) mesh: SNR points run concurrently on mesh rows,
    frames data-parallel along mesh columns (SURVEY.md section 2's device
    mapping of the reference's per-seed x per-SNR shell fan-out)."""
    import numpy as np

    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    n = len(devs)
    if n % n_snr:
        raise ValueError(f"{n} devices not divisible by {n_snr} SNR rows")
    return Mesh(np.array(devs).reshape(n_snr, n // n_snr), axes)


def make_dp_step_2d(step_fn, mesh: Mesh, axes: tuple = ("snr", "dp")):
    """SPMD MC step over a 2-D (snr, dp) mesh.

    step_fn(key, sigma) -> dict of scalar counters.  The wrapped function
    has signature (base_key, sigmas, gb0): sigmas (n_snr,) is sharded
    over the snr axis (one noise level per mesh row), each row derives
    its SNR key as fold_in(base_key, snr_index) — the same derivation
    BERSim.run uses per SNR point — and within a row device j runs
    global batch gb0 + j keyed fold_in(key_snr, gb0 + j), the exact
    single-device key stream (mesh-size-invariant counters, as in
    make_dp_step).  Counters are psum-reduced over the dp axis only:
    shape (n_snr,) per counter."""
    snr_ax, dp_ax = axes

    @jax.jit
    @partial(shard_map, mesh=mesh, in_specs=(P(), P(snr_ax), P()),
             out_specs=P(snr_ax), check_vma=False)
    def wrapped(base_key, sigmas, gb0):
        key_snr = jax.random.fold_in(base_key, jax.lax.axis_index(snr_ax))
        gb = gb0 + jax.lax.axis_index(dp_ax)
        counts = step_fn(jax.random.fold_in(key_snr, gb), sigmas[0])
        counts = jax.tree.map(lambda x: jax.lax.psum(x, dp_ax), counts)
        return jax.tree.map(lambda x: x[None], counts)

    return wrapped


def multihost_init():
    """Initialize jax.distributed when running under a multi-host launcher;
    no-op (returns False) in single-process runs."""
    import os

    if "JAX_COORDINATOR_ADDRESS" in os.environ or "COORDINATOR_ADDRESS" in os.environ:
        jax.distributed.initialize()
        return True
    return False
