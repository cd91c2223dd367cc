"""Mid-run checkpoint / resume for long particle runs (preemption-safe).

The reference persists only *completed* sweep results (its ``run=True/False``
npz flag pattern — covered by ``sweeps/persistence.py``).  On preemptible
machines the unit of loss is the run **in flight**, so this module chunks the
observation-frame scan and checkpoints the scan carry (the full
:class:`~hydrolim_tpu.particles.init.ParticleState`, including the threefry
key and the exit log) plus each chunk's frame stack.  A resumed run restores
the carry of the newest complete chunk and continues on the same global
frame grid, so the stitched result is **bit-identical** to an uninterrupted
run: the per-frame time origin is derived from the global frame index and
the randomness is carried in the state.

Layout of ``ckpt_dir``::

    manifest.json          {"run_hash", "n_frames", "chunk_frames", ...}
    chunk_00000.npz        frames__<field> arrays + state__<field> carry
    chunk_00001.npz        ...

Chunk files are written atomically (tmp + ``os.replace``), so a kill at any
point leaves a consistent prefix.  The manifest's ``run_hash`` covers the
config, params, grid, and recording flags — resuming with any of them
changed raises instead of silently stitching incompatible physics.
"""
from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Optional

import jax
import numpy as np

from hydrolim_tpu.core.config import ParticleConfig, ParticleParams
from hydrolim_tpu.particles.init import ParticleState
from hydrolim_tpu.particles.run import (
    ParticleFrames,
    ParticleRunResult,
    _record_initial,
    _run_scan_range,
    run_particles,
    substeps_for,
)
from hydrolim_tpu.sweeps.persistence import config_hash

__all__ = ["run_particles_checkpointed", "pde_solve_checkpointed",
           "run_lattice_gas_k_checkpointed",
           "run_lattice_gas_checkpointed",
           "run_pde_ensemble_checkpointed",
           "run_particle_ensemble_checkpointed", "cleanup_ckpt_dir"]


def _run_hash(config: ParticleConfig, params: ParticleParams, *, T: float,
              obs_dt: float, dt: float, record_pos: bool,
              record_fft: bool) -> str:
    """Hash of everything that determines the trajectory and frame schema.

    The chunk size is deliberately NOT hashed: it is an I/O tuning knob,
    not physics — a resume adopts the layout stored in the manifest, so a
    preempted run survives an operator resuming with a different
    ``chunk_frames``.  ``flip_rate_fn`` is a callable (unhashable
    content); its *identity* being absent from the hash is the documented
    limitation — swapping the function between resume calls is on the
    user, as with any closure."""
    cfg = {f: getattr(config, f) for f in config.__dataclass_fields__
           if f != "flip_rate_fn"}
    cfg["has_flip_rate_fn"] = config.flip_rate_fn is not None
    par = {f: np.asarray(getattr(params, f)).tolist()
           for f in params._fields}
    return config_hash({"config": {k: repr(v) for k, v in cfg.items()},
                        "params": par, "T": T, "obs_dt": obs_dt, "dt": dt,
                        "record_pos": record_pos, "record_fft": record_fft})


def _read_manifest(path: Path) -> Optional[dict]:
    """None when absent or unparseable (a pre-atomic-write legacy crash);
    callers decide whether unparseable-with-chunks is recoverable."""
    try:
        return json.loads(path.read_text())
    except (OSError, json.JSONDecodeError):
        return None


def _write_manifest(path: Path, payload: dict) -> None:
    tmp = path.with_suffix(".json.tmp")
    tmp.write_text(json.dumps(payload))
    os.replace(tmp, path)


def _atomic_savez(path: Path, **arrays) -> None:
    tmp = path.with_suffix(".tmp.npz")
    np.savez_compressed(tmp, **arrays)
    os.replace(tmp, path)


def _save_chunk(path: Path, frames: ParticleFrames,
                state: ParticleState) -> None:
    payload = {}
    for f in ParticleFrames._fields:
        payload[f"frames__{f}"] = np.asarray(getattr(frames, f))
    for f in ParticleState._fields:
        payload[f"state__{f}"] = np.asarray(getattr(state, f))
    _atomic_savez(path, **payload)


def _load_chunk(path: Path):
    with np.load(path) as z:
        frames = ParticleFrames(**{f: z[f"frames__{f}"]
                                   for f in ParticleFrames._fields})
        state = ParticleState(**{f: jax.numpy.asarray(z[f"state__{f}"])
                                 for f in ParticleState._fields})
    return frames, state


def _chunk_path(ckpt_dir: Path, i: int) -> Path:
    return ckpt_dir / f"chunk_{i:05d}.npz"


def _place(mesh, tree):
    """Re-place a batched carry on the run's sweep mesh:
    resume restores host arrays from npz, so the carry must be put back on
    the mesh — batch-leading leaves on the 'sweep' axis, everything else
    replicated (the same placement the uncheckpointed sharded run uses).
    No-op without a mesh; keys are prefix-stable under padding, so the
    resharded run stays bit-identical to the single-device one."""
    if mesh is None:
        return tree
    from hydrolim_tpu.parallel.mesh import shard_batch

    return shard_batch(mesh, tree)


def _resume_prefix(ckpt_dir: Path, run_hash: str, *, what: str,
                   resume: bool, chunk_size: int, n_units: int,
                   size_key: str, unit_key: str,
                   adopt_chunk_size: bool = True,
                   scan_prefix: bool = True, extra: Optional[dict] = None):
    """Shared manifest guard for every checkpoint driver.

    Validates an existing manifest (raising on an unreadable file or a
    foreign ``run_hash``), optionally adopts the stored chunk layout,
    deletes **unvouched** chunk files (without a verified manifest, any
    ``chunk_*.npz`` on disk is a relic of some other run and must never be
    stitched), writes the fresh manifest, and returns
    ``(chunk_size, n_chunks, done)`` where ``done`` is the longest
    consecutive complete-chunk prefix (0 when ``scan_prefix=False`` —
    callers with non-index chunk naming do their own per-chunk checks)."""
    manifest_path = ckpt_dir / "manifest.json"
    manifest = None
    if resume and manifest_path.exists():
        manifest = _read_manifest(manifest_path)
        if manifest is None:
            raise ValueError(
                f"unreadable manifest at {manifest_path} — cannot verify "
                f"the existing chunks belong to this {what}; pass "
                "resume=False to start over or use a fresh dir")
        if manifest.get("run_hash") != run_hash:
            raise ValueError(
                f"checkpoint at {ckpt_dir} belongs to a different {what} "
                f"(hash {manifest.get('run_hash')!r} != {run_hash!r}); "
                "pass resume=False to overwrite or use a fresh dir")
    if manifest is None:
        for p in ckpt_dir.glob("chunk_*.npz"):
            p.unlink()
    elif adopt_chunk_size:
        chunk_size = int(manifest.get(size_key, chunk_size))
    n_chunks = -(-n_units // chunk_size)
    done = 0
    if manifest is not None and scan_prefix:
        while done < n_chunks and _chunk_path(ckpt_dir, done).exists():
            done += 1
    _write_manifest(manifest_path,
                    {"run_hash": run_hash, size_key: chunk_size,
                     unit_key: n_units, "n_chunks": n_chunks,
                     **(extra or {})})
    return chunk_size, n_chunks, done


def _pipelined_chunks(ckpt_dir: Path, carry, *, done: int, n_chunks: int,
                      chunk_size: int, n_units: int, run_chunk, save_chunk,
                      stop_after_chunks: Optional[int]):
    """Shared pipelined chunk loop: chunk c+1 is DISPATCHED (jax async)
    before chunk c's payload is pulled to host and compressed — device
    compute overlaps checkpoint I/O.  Saves still land strictly in order,
    so a kill at any point leaves the same consistent prefix as a serial
    loop.

    ``run_chunk(carry, lo, hi) -> (payload, carry)`` executes units
    ``[lo, hi)``; ``save_chunk(path, payload, carry)`` persists one chunk
    (and is where device→host transfer belongs, so it happens AFTER the
    next chunk was dispatched).  Returns the final carry, or ``None`` when
    ``stop_after_chunks`` halted an incomplete run (the pending chunk is
    flushed first, preserving the prefix)."""
    pending = None

    def _flush():
        nonlocal pending
        if pending is None:
            return
        c_, payload, carry_ = pending
        save_chunk(_chunk_path(ckpt_dir, c_), payload, carry_)
        pending = None

    executed = 0
    for c in range(done, n_chunks):
        if stop_after_chunks is not None and executed >= stop_after_chunks:
            _flush()
            return None
        lo = c * chunk_size
        hi = min((c + 1) * chunk_size, n_units)
        payload, carry = run_chunk(carry, lo, hi)
        _flush()
        pending = (c, payload, carry)
        executed += 1
    _flush()
    return carry


def run_particles_checkpointed(
        config: ParticleConfig, params: ParticleParams,
        state0: ParticleState, *, T: float, obs_dt: float, dt: float,
        ckpt_dir, chunk_frames: int = 64, record_pos: bool = True,
        record_fft: bool = True, resume: bool = True,
        stop_after_chunks: Optional[int] = None
) -> Optional[ParticleRunResult]:
    """Checkpointed equivalent of :func:`run_particles`.

    Runs the frame grid in chunks of ``chunk_frames`` frames, writing an
    atomic checkpoint (chunk frames + carry state) after each.  With
    ``resume=True`` (default) an existing compatible checkpoint prefix is
    reused — only the missing chunks execute, and the manifest's stored
    chunk layout wins over the ``chunk_frames`` argument (so a resume
    with a different chunk size keeps the completed prefix);
    ``resume=False`` discards any existing chunks and starts over.

    ``stop_after_chunks=k`` executes at most ``k`` *new* chunks this call
    and returns ``None`` if the run is still incomplete (the test hook for
    simulated preemption; a real preemption is just a kill).

    Returns the stitched :class:`ParticleRunResult` (frames on host) once
    all chunks exist.  Frame values are bit-identical to
    :func:`run_particles` on the same inputs (pinned in
    ``tests/test_checkpoint_run.py``).
    """
    from hydrolim_tpu.particles.stepper import build_static_arrays

    ckpt_dir = Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)

    times_obs = np.arange(0.0, T, obs_dt)
    n_frames = len(times_obs)
    if n_frames == 0:
        return run_particles(config, params, state0, T=T, obs_dt=obs_dt,
                             dt=dt, record_pos=record_pos,
                             record_fft=record_fft)
    assert chunk_frames >= 1
    n_sub = substeps_for(obs_dt, dt)
    run_hash = _run_hash(config, params, T=T, obs_dt=obs_dt, dt=dt,
                         record_pos=record_pos, record_fft=record_fft)

    # the stored chunk layout wins on resume — the chunk size is an I/O
    # knob, and honoring it lets a resume with a different argument reuse
    # the completed prefix instead of discarding it
    chunk_frames, n_chunks, done = _resume_prefix(
        ckpt_dir, run_hash, what="run", resume=resume,
        chunk_size=chunk_frames, n_units=n_frames,
        size_key="chunk_frames", unit_key="n_frames",
        extra={"obs_dt": obs_dt, "T": T})

    if done > 0:
        _, state = _load_chunk(_chunk_path(ckpt_dir, done - 1))
    else:
        state = state0

    def run_chunk(state, lo, hi):
        parts = []
        if lo == 0:
            parts.append(_record_initial(config, state,
                                         statics_builder=build_static_arrays,
                                         record_pos=record_pos,
                                         record_fft=record_fft))
        if hi > max(lo, 1):
            res = _run_scan_range(config, params, state, max(lo, 1),
                                  statics_builder=build_static_arrays,
                                  length=hi - max(lo, 1), n_sub=n_sub,
                                  obs_dt=obs_dt, record_pos=record_pos,
                                  record_fft=record_fft)
            parts.append(res.frames)
            state = res.final_state
        return parts, state

    def save_parts(path, parts, st):
        arrs = [jax.tree.map(np.asarray, p) for p in parts]
        frames = arrs[0] if len(arrs) == 1 else jax.tree.map(
            lambda *xs: np.concatenate(xs, axis=0), *arrs)
        _save_chunk(path, frames, jax.tree.map(np.asarray, st))

    state = _pipelined_chunks(ckpt_dir, state, done=done, n_chunks=n_chunks,
                              chunk_size=chunk_frames, n_units=n_frames,
                              run_chunk=run_chunk, save_chunk=save_parts,
                              stop_after_chunks=stop_after_chunks)
    if state is None:
        return None

    # stitch all chunks (read back from disk so the returned result is
    # exactly what a resumed process would reconstruct)
    chunk_frames_list = []
    for c in range(n_chunks):
        f, state = _load_chunk(_chunk_path(ckpt_dir, c))
        chunk_frames_list.append(f)
    frames = jax.tree.map(
        lambda *xs: np.concatenate(xs, axis=0), *chunk_frames_list)
    return ParticleRunResult(frames=frames, final_state=state)


# ---------------------------------------------------------------------------
# PDE engine
# ---------------------------------------------------------------------------

def _pde_run_hash(config, params, *, n_tracers: int) -> str:
    """Chunk size deliberately not hashed — see :func:`_run_hash`."""
    cfg = {f: repr(getattr(config, f)) for f in config.__dataclass_fields__}
    par = {f: np.asarray(getattr(params, f)).tolist()
           for f in params._fields}
    return config_hash({"pde_config": cfg, "params": par,
                        "n_tracers": n_tracers})


def _flatten_named(prefix: str, tree):
    """Flatten a (possibly nested) NamedTuple of arrays into npz keys."""
    out = {}
    for f in tree._fields:
        v = getattr(tree, f)
        if hasattr(v, "_fields"):
            out.update(_flatten_named(f"{prefix}{f}__", v))
        else:
            out[f"{prefix}{f}"] = np.asarray(v)
    return out


def _save_pde_chunk(path: Path, blocks, carry) -> None:
    recs, snaps, m_snaps, snap_times = blocks
    payload = _flatten_named("recs__", recs)
    payload["snaps"] = np.asarray(snaps)
    payload["m_snaps"] = np.asarray(m_snaps)
    payload["snap_times"] = np.asarray(snap_times)
    payload.update(_flatten_named("carry__", carry))
    _atomic_savez(path, **payload)


def _load_pde_chunk(path: Path):
    from hydrolim_tpu.pde.stepper import PDECarry, PDERecord, TracerState

    with np.load(path) as z:
        recs = PDERecord(**{f: z[f"recs__{f}"] for f in PDERecord._fields})
        tracers = TracerState(
            **{f: jax.numpy.asarray(z[f"carry__tracers__{f}"])
               for f in TracerState._fields})
        carry = PDECarry(rho_p=jax.numpy.asarray(z["carry__rho_p"]),
                         rho_m=jax.numpy.asarray(z["carry__rho_m"]),
                         tracers=tracers,
                         key=jax.numpy.asarray(z["carry__key"]))
        blocks = (recs, z["snaps"], z["m_snaps"], z["snap_times"])
    return blocks, carry


def pde_solve_checkpointed(config, params, ops, rho_p0, rho_m0, tracers0,
                           key, *, ckpt_dir, chunk_blocks: int = 8,
                           resume: bool = True,
                           stop_after_chunks: Optional[int] = None):
    """Checkpointed equivalent of :func:`hydrolim_tpu.pde.stepper.pde_solve`.

    The snapshot-block scan runs in chunks of ``chunk_blocks`` blocks
    (``chunk_blocks * snapshot_interval`` IMEX steps per checkpoint),
    writing each chunk's raw block stacks plus the carry
    (fields + tracer state incl. the circular displacement buffer + key)
    atomically.  Resume restores the newest complete chunk's carry;
    stitched records/snapshots are bit-identical to an uninterrupted
    solve.  Returns a :class:`PDESolveResult`, or ``None`` when
    ``stop_after_chunks`` halted an incomplete run."""
    import math

    from hydrolim_tpu.pde.stepper import (
        PDECarry,
        PDESolveResult,
        _finalize_records,
        _pde_solve_range,
    )

    ckpt_dir = Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    n_blocks = math.ceil((config.nsteps + 1) / config.snapshot_interval)
    assert chunk_blocks >= 1
    run_hash = _pde_run_hash(
        config, params, n_tracers=int(np.asarray(tracers0.pos).shape[-1]))

    chunk_blocks, n_chunks, done = _resume_prefix(
        ckpt_dir, run_hash, what="PDE solve", resume=resume,
        chunk_size=chunk_blocks, n_units=n_blocks,
        size_key="chunk_blocks", unit_key="n_blocks")

    if done > 0:
        _, carry = _load_pde_chunk(_chunk_path(ckpt_dir, done - 1))
    else:
        carry = PDECarry(rho_p0, rho_m0, tracers0, key)

    def run_chunk(carry, lo, hi):
        carry, blocks = _pde_solve_range(config, params, ops, carry, lo,
                                         length=hi - lo)
        return blocks, carry

    def save_blocks(path, blocks, carry_):
        _save_pde_chunk(path, jax.tree.map(np.asarray, blocks),
                        jax.tree.map(np.asarray, carry_))

    carry = _pipelined_chunks(ckpt_dir, carry, done=done, n_chunks=n_chunks,
                              chunk_size=chunk_blocks, n_units=n_blocks,
                              run_chunk=run_chunk, save_chunk=save_blocks,
                              stop_after_chunks=stop_after_chunks)
    if carry is None:
        return None

    stacks = []
    for c in range(n_chunks):
        blocks, carry = _load_pde_chunk(_chunk_path(ckpt_dir, c))
        stacks.append(blocks)
    recs, snaps, m_snaps, snap_times = jax.tree.map(
        lambda *xs: np.concatenate(xs, axis=0), *stacks)
    recs = _finalize_records(config, recs, n_blocks)
    return PDESolveResult(
        rho_p=np.asarray(carry.rho_p), rho_m=np.asarray(carry.rho_m),
        records=recs, snapshots=snaps, m_snapshots=m_snaps,
        snap_times=snap_times)


# ---------------------------------------------------------------------------
# lattice-gas slot engine (batched)
# ---------------------------------------------------------------------------

def _digest(arr) -> Optional[str]:
    if arr is None:
        return None
    import hashlib

    a = np.ascontiguousarray(np.asarray(arr))
    return hashlib.sha256(a.tobytes()).hexdigest()[:16]


def _lg_engine_run_hash(tag, config, params_b, *, T: float, obs_dt: float,
                        dt: float, record_fft: bool, n_tracers: int,
                        rho0_plus, rho0_minus) -> str:
    """Chunk size deliberately not hashed — see :func:`_run_hash`."""
    cfg = {f: repr(getattr(config, f)) for f in config.__dataclass_fields__
           if f != "flip_rate_fn"}
    cfg["has_flip_rate_fn"] = config.flip_rate_fn is not None
    par = {f: np.asarray(getattr(params_b, f)).tolist()
           for f in params_b._fields}
    return config_hash({f"{tag}_config": cfg, "params": par, "T": T,
                        "obs_dt": obs_dt, "dt": dt,
                        "record_fft": record_fft, "n_tracers": n_tracers,
                        "rho0_plus": _digest(rho0_plus),
                        "rho0_minus": _digest(rho0_minus)})


def _save_lg_chunk(path: Path, frames, carry, tr_valid,
                   carry_fields) -> None:
    payload = _flatten_named("frames__", frames)
    for name, v in zip(carry_fields, carry):
        payload[f"carry__{name}"] = np.asarray(v)
    payload["tr_valid"] = np.asarray(tr_valid)
    _atomic_savez(path, **payload)


def _load_lg_chunk(path: Path, carry_fields):
    from hydrolim_tpu.particles.lattice_gas import LatticeGasFrames

    with np.load(path) as z:
        frames = LatticeGasFrames(
            **{f: z[f"frames__{f}"] for f in LatticeGasFrames._fields})
        carry = tuple(jax.numpy.asarray(z[f"carry__{n}"])
                      for n in carry_fields)
        tr_valid = jax.numpy.asarray(z["tr_valid"])
    return frames, carry, tr_valid


def _run_lg_family_checkpointed(
        eng: dict, config, params_b, key, *, T: float, obs_dt: float,
        dt: float, ckpt_dir, chunk_frames: int, rho0_plus, rho0_minus,
        record_fft: bool, n_tracers: int, occ_sharding, resume: bool,
        stop_after_chunks: Optional[int], mesh=None):
    """Shared checkpoint driver for the batched lattice-gas engines.

    ``eng`` describes one engine: ``tag`` (hash namespace), ``init``
    (per-replica field init), ``init_2d`` (whether per-replica 2-D
    intensity profiles are supported), ``carry0``/``scan_range`` (the
    engine's batched carry builder and range scan), ``carry_fields``
    (npz field names for the carry tuple)."""
    from hydrolim_tpu.particles.run import substeps_for

    ckpt_dir = Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    assert chunk_frames >= 1
    n_frames = len(np.arange(0.0, T, obs_dt))
    assert n_frames >= 1, "T <= 0: nothing to checkpoint"
    n_sub = substeps_for(obs_dt, dt)
    run_hash = _lg_engine_run_hash(
        eng["tag"], config, params_b, T=T, obs_dt=obs_dt, dt=dt,
        record_fft=record_fft, n_tracers=n_tracers, rho0_plus=rho0_plus,
        rho0_minus=rho0_minus)
    carry_fields = eng["carry_fields"]

    chunk_frames, n_chunks, done = _resume_prefix(
        ckpt_dir, run_hash, what="lattice-gas run", resume=resume,
        chunk_size=chunk_frames, n_units=n_frames,
        size_key="chunk_frames", unit_key="n_frames")

    if done > 0:
        _, carry, tr_valid = _load_lg_chunk(_chunk_path(ckpt_dir, done - 1),
                                            carry_fields)
        carry, tr_valid = _place(mesh, (carry, tr_valid))
        frame0 = None
    else:
        # prologue identical to the engine's runner (key fan-out, init)
        B = params_b.beta.shape[0]
        keys = jax.random.split(key, B)
        init_keys = jax.vmap(lambda k: jax.random.fold_in(k, 0))(keys)
        if (eng["init_2d"] and rho0_plus is not None
                and np.ndim(rho0_plus) == 2):
            field0 = jax.vmap(
                lambda k, rp, rm: eng["init"](config, k, rp, rm))(
                    init_keys, jax.numpy.asarray(rho0_plus),
                    jax.numpy.asarray(rho0_minus))
        else:
            field0 = jax.vmap(lambda k: eng["init"](config, k, rho0_plus,
                                                    rho0_minus))(init_keys)
        if occ_sharding is not None:
            field0 = jax.device_put(field0, occ_sharding)
        carry, tr_valid, frame0 = eng["carry0"](
            config, params_b, field0, keys, n_sub=n_sub, obs_dt=obs_dt,
            record_fft=record_fft, n_tracers=n_tracers)
        carry, tr_valid = _place(mesh, (carry, tr_valid))

    def run_chunk(carry, lo, hi):
        # frame 0 is the initial record; stepped frames are 1..n_frames-1
        length = (hi - 1) if lo == 0 else (hi - lo)
        frames = None
        if length > 0:
            carry, frames = eng["scan_range"](
                config, params_b, carry, tr_valid, length=length,
                n_sub=n_sub, obs_dt=obs_dt, record_fft=record_fft,
                n_tracers=n_tracers)
        return (frame0 if lo == 0 else None, frames), carry

    def save_lg(path, payload, carry_):
        f0_, frames_ = payload
        frames_ = None if frames_ is None else jax.tree.map(np.asarray,
                                                            frames_)
        if f0_ is not None:
            f0_ = jax.tree.map(lambda a: np.asarray(a)[:, None], f0_)
            frames_ = f0_ if frames_ is None else jax.tree.map(
                lambda a, b: np.concatenate([a, b], axis=1), f0_, frames_)
        _save_lg_chunk(path, frames_, jax.tree.map(np.asarray, carry_),
                       np.asarray(tr_valid), carry_fields)

    carry = _pipelined_chunks(ckpt_dir, carry, done=done, n_chunks=n_chunks,
                              chunk_size=chunk_frames, n_units=n_frames,
                              run_chunk=run_chunk, save_chunk=save_lg,
                              stop_after_chunks=stop_after_chunks)
    if carry is None:
        return None

    stacks = []
    for c in range(n_chunks):
        frames, carry, tr_valid = _load_lg_chunk(_chunk_path(ckpt_dir, c),
                                                 carry_fields)
        stacks.append(frames)
    frames = jax.tree.map(lambda *xs: np.concatenate(xs, axis=1), *stacks)
    return frames, np.asarray(carry[0])


def run_lattice_gas_k_checkpointed(
        config, params_b, key, *, T: float, obs_dt: float, dt: float,
        ckpt_dir, chunk_frames: int = 64, rho0_plus=None, rho0_minus=None,
        record_fft: bool = True, n_tracers: int = 0, occ_sharding=None,
        resume: bool = True, stop_after_chunks: Optional[int] = None,
        mesh=None):
    """Checkpointed equivalent of
    :func:`hydrolim_tpu.particles.lattice_gas_k.run_lattice_gas_k` (same
    argument and return contract: batched ``(frames, final_slots)``).

    The batched frame scan runs in ``chunk_frames``-frame chunks with an
    atomic checkpoint of each chunk's frames plus the carry (slot field,
    tracer sites/slots/windings, per-replica keys) and the phantom-tracer
    mask after each; resume restores the newest complete chunk and the
    stitched result is bit-identical to the unsplit run."""
    from hydrolim_tpu.particles import lattice_gas_k as lgk

    eng = dict(tag="lgk", init=lgk.lgk_init, init_2d=True,
               carry0=lgk._lgk_carry0, scan_range=lgk._lgk_scan_range,
               carry_fields=("slots", "tr_site", "tr_slot", "wind", "key"))
    return _run_lg_family_checkpointed(
        eng, config, params_b, key, T=T, obs_dt=obs_dt, dt=dt,
        ckpt_dir=ckpt_dir, chunk_frames=chunk_frames, rho0_plus=rho0_plus,
        rho0_minus=rho0_minus, record_fft=record_fft, n_tracers=n_tracers,
        occ_sharding=occ_sharding, resume=resume,
        stop_after_chunks=stop_after_chunks, mesh=mesh)


def run_lattice_gas_checkpointed(
        config, params_b, key, *, T: float, obs_dt: float, dt: float,
        ckpt_dir, chunk_frames: int = 64, rho0_plus=None, rho0_minus=None,
        record_fft: bool = True, n_tracers: int = 0, occ_sharding=None,
        resume: bool = True, stop_after_chunks: Optional[int] = None,
        mesh=None):
    """Checkpointed equivalent of the K=1 site-centric engine
    :func:`hydrolim_tpu.particles.lattice_gas.run_lattice_gas` — same
    contract and bit-identity guarantee as the slot-engine variant."""
    from hydrolim_tpu.particles import lattice_gas as lg

    eng = dict(tag="lg1", init=lg.lg_init, init_2d=False,
               carry0=lg._lg_carry0, scan_range=lg._lg_scan_range,
               carry_fields=("occ", "tr", "wind", "key"))
    return _run_lg_family_checkpointed(
        eng, config, params_b, key, T=T, obs_dt=obs_dt, dt=dt,
        ckpt_dir=ckpt_dir, chunk_frames=chunk_frames, rho0_plus=rho0_plus,
        rho0_minus=rho0_minus, record_fft=record_fft, n_tracers=n_tracers,
        occ_sharding=occ_sharding, resume=resume,
        stop_after_chunks=stop_after_chunks, mesh=mesh)


# ---------------------------------------------------------------------------
# PDE ensemble (the vmapped (β × runs) sweep grid)
# ---------------------------------------------------------------------------

def _pde_ensemble_run_hash(config, params_b, rho_p0, rho_m0, tracers0,
                           solve_keys, keep_snapshots: bool) -> str:
    """The initial fields / tracers / keys are hashed by digest — they
    capture seed, init mode and noise without re-deriving them here.
    Chunk size deliberately not hashed (I/O knob, see :func:`_run_hash`)."""
    cfg = {f: repr(getattr(config, f)) for f in config.__dataclass_fields__}
    par = {f: np.asarray(getattr(params_b, f)).tolist()
           for f in params_b._fields}
    return config_hash({"pde_ensemble_config": cfg, "params": par,
                        "rho_p0": _digest(rho_p0), "rho_m0": _digest(rho_m0),
                        "tracer_pos0": _digest(tracers0.pos),
                        "solve_keys": _digest(solve_keys),
                        "keep_snapshots": keep_snapshots})


def run_pde_ensemble_checkpointed(config, params_b, ops, rho_p0, rho_m0,
                                  tracers0, solve_keys, *, ckpt_dir,
                                  chunk_blocks: int = 8, resume: bool = True,
                                  keep_snapshots: bool = True,
                                  stop_after_chunks: Optional[int] = None,
                                  mesh=None):
    """Checkpointed equivalent of the vmapped XLA grid inside
    :func:`hydrolim_tpu.sweeps.pde_sweeps.run_pde_ensemble` (same batched
    ``PDESolveResult`` contract).

    The whole (β × runs) batch advances together through the snapshot-block
    scan in ``chunk_blocks``-block chunks; each checkpoint stores every
    replica's carry (fields + tracer ring buffer + key) plus the chunk's
    raw block stacks, so a preempted sweep resumes mid-grid-program and the
    stitched result is bit-identical to the uninterrupted vmapped solve.
    ``mesh=`` composes: the restored host carry is
    re-placed with the run's sweep sharding (:func:`_place`), so a
    preempted sharded sweep resumes sharded; trajectories stay
    bit-identical to the single-device run.

    ``keep_snapshots=False`` stores zero-width snapshot stacks in the chunk
    files (the sweep facades discard them anyway — at reference scale the
    per-interval ρ blocks dominate transfer/compression/disk for data that
    is thrown away); the flag is part of the run hash, so chunks of mixed
    snapshot width never stitch."""
    import math

    from hydrolim_tpu.pde.stepper import (
        PDECarry,
        PDESolveResult,
        _pde_solve_range,
    )

    ckpt_dir = Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    n_blocks = math.ceil((config.nsteps + 1) / config.snapshot_interval)
    assert chunk_blocks >= 1
    run_hash = _pde_ensemble_run_hash(config, params_b, rho_p0, rho_m0,
                                      tracers0, solve_keys, keep_snapshots)

    chunk_blocks, n_chunks, done = _resume_prefix(
        ckpt_dir, run_hash, what="PDE ensemble", resume=resume,
        chunk_size=chunk_blocks, n_units=n_blocks,
        size_key="chunk_blocks", unit_key="n_blocks")

    if done > 0:
        _, carry = _load_pde_chunk(_chunk_path(ckpt_dir, done - 1))
    else:
        carry = PDECarry(jax.numpy.asarray(rho_p0),
                         jax.numpy.asarray(rho_m0), tracers0,
                         jax.numpy.asarray(solve_keys))
    carry = _place(mesh, carry)

    def _ranged(carry_, lo, length):
        # vmap over (params, carry); the traced block start is broadcast so
        # interior chunks share ONE compiled program per distinct length
        f = lambda p, c, lo_: _pde_solve_range(config, p, ops, c, lo_,
                                               length=length)
        return jax.vmap(f, in_axes=(0, 0, None))(params_b, carry_,
                                                 jax.numpy.int32(lo))

    def run_chunk(carry, lo, hi):
        carry, blocks = _ranged(carry, lo, hi - lo)
        if not keep_snapshots:
            recs_c, sn, msn, st = blocks
            blocks = (recs_c, sn[:, :0], msn[:, :0], st[:, :0])
        return blocks, carry

    def save_blocks(path, blocks, carry_):
        _save_pde_chunk(path, jax.tree.map(np.asarray, blocks),
                        jax.tree.map(np.asarray, carry_))

    carry = _pipelined_chunks(ckpt_dir, carry, done=done, n_chunks=n_chunks,
                              chunk_size=chunk_blocks, n_units=n_blocks,
                              run_chunk=run_chunk, save_chunk=save_blocks,
                              stop_after_chunks=stop_after_chunks)
    if carry is None:
        return None

    stacks = []
    for c in range(n_chunks):
        blocks, carry = _load_pde_chunk(_chunk_path(ckpt_dir, c))
        stacks.append(blocks)
    # chunks stack on the BLOCK axis, which is axis 1 here (batch leads)
    recs, snaps, m_snaps, snap_times = jax.tree.map(
        lambda *xs: np.concatenate(xs, axis=1), *stacks)
    # batched _finalize_records: flatten blocks × interval on axis 1,
    # truncate the padded tail, thin to the record cadence
    n_iters = config.nsteps + 1
    interval = config.snapshot_interval
    recs = jax.tree.map(
        lambda a: a.reshape((a.shape[0], n_blocks * interval)
                            + a.shape[3:])[:, :n_iters], recs)
    if config.record_every > 1:
        recs = jax.tree.map(lambda a: a[:, ::config.record_every], recs)
    return PDESolveResult(
        rho_p=np.asarray(carry.rho_p), rho_m=np.asarray(carry.rho_m),
        records=recs, snapshots=snaps, m_snapshots=m_snaps,
        snap_times=snap_times)


def cleanup_ckpt_dir(ckpt_dir, *, missing_ok: bool = True) -> int:
    """Delete a checkpoint directory's chunk files, manifest, and any
    write-interrupted ``*.tmp.npz`` relics; returns the number of files
    removed.  Call after a checkpointed run has returned its stitched
    result and the caller has persisted what it needs (the chunk stacks
    can reach GBs for long record-heavy runs).  The directory itself is
    removed when it ends up empty."""
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.exists():
        if missing_ok:
            return 0
        raise FileNotFoundError(ckpt_dir)
    n = 0
    for pattern in ("chunk_*.npz", "chunk_*.tmp.npz", "manifest.json",
                    "manifest.json.tmp"):
        for p in ckpt_dir.glob(pattern):
            p.unlink()
            n += 1
    try:
        ckpt_dir.rmdir()          # only when nothing else lives there
    except OSError:
        pass
    return n


# ---------------------------------------------------------------------------
# particle ensemble (the vmapped (β × runs) grid, τ-leap engine)
# ---------------------------------------------------------------------------

def _particle_ensemble_run_hash(config, params_b, states0, *, T, obs_dt, dt,
                                record_pos, record_fft) -> str:
    """Initial states are hashed by per-leaf digest (they capture the init
    draw, profiles and key fan-out without re-deriving them here).  Chunk
    size deliberately not hashed — see :func:`_run_hash`."""
    cfg = {f: repr(getattr(config, f)) for f in config.__dataclass_fields__
           if f != "flip_rate_fn"}
    cfg["has_flip_rate_fn"] = config.flip_rate_fn is not None
    par = {f: np.asarray(getattr(params_b, f)).tolist()
           for f in params_b._fields}
    st = {f: _digest(getattr(states0, f)) for f in states0._fields}
    return config_hash({"particle_ensemble_config": cfg, "params": par,
                        "states0": st, "T": T, "obs_dt": obs_dt, "dt": dt,
                        "record_pos": record_pos,
                        "record_fft": record_fft})


def run_particle_ensemble_checkpointed(
        config: ParticleConfig, params_b: ParticleParams, states0,
        *, T: float, obs_dt: float, dt: float, ckpt_dir,
        chunk_frames: int = 64, record_pos: bool = True,
        record_fft: bool = True, resume: bool = True,
        stop_after_chunks: Optional[int] = None, mesh=None
) -> Optional[ParticleRunResult]:
    """Checkpointed equivalent of
    :func:`hydrolim_tpu.sweeps.ensemble.run_particle_ensemble` on prebuilt
    batched initial states (same batched ``ParticleRunResult`` contract).

    The whole (β × runs) batch advances together through the frame scan in
    ``chunk_frames``-frame chunks, checkpointing every replica's carry
    state after each — the vmapped analogue of
    :func:`run_particles_checkpointed`, with the same bit-identity and
    resume guarantees.  ``mesh=`` composes: the (restored) carry is
    re-placed with the run's sweep sharding (:func:`_place`)."""
    from hydrolim_tpu.particles.stepper import build_static_arrays

    ckpt_dir = Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    n_frames = len(np.arange(0.0, T, obs_dt))
    assert n_frames >= 1, "T <= 0: nothing to checkpoint"
    assert chunk_frames >= 1
    n_sub = substeps_for(obs_dt, dt)
    run_hash = _particle_ensemble_run_hash(
        config, params_b, states0, T=T, obs_dt=obs_dt, dt=dt,
        record_pos=record_pos, record_fft=record_fft)

    chunk_frames, n_chunks, done = _resume_prefix(
        ckpt_dir, run_hash, what="particle ensemble", resume=resume,
        chunk_size=chunk_frames, n_units=n_frames,
        size_key="chunk_frames", unit_key="n_frames",
        extra={"obs_dt": obs_dt, "T": T})

    if done > 0:
        _, states = _load_chunk(_chunk_path(ckpt_dir, done - 1))
    else:
        states = states0
    states = _place(mesh, states)

    def _v_initial(sts):
        return jax.vmap(lambda s: _record_initial(
            config, s, statics_builder=build_static_arrays,
            record_pos=record_pos, record_fft=record_fft))(sts)

    def _v_range(sts, lo, length):
        f = lambda p, s, lo_: _run_scan_range(
            config, p, s, lo_, statics_builder=build_static_arrays,
            length=length, n_sub=n_sub, obs_dt=obs_dt,
            record_pos=record_pos, record_fft=record_fft)
        return jax.vmap(f, in_axes=(0, 0, None))(params_b, sts,
                                                 jax.numpy.int32(lo))

    def run_chunk(states, lo, hi):
        parts = []
        if lo == 0:
            # _record_initial already returns a (1, ...) frame stack, so
            # the vmapped call is (B, 1, ...) — concat-ready on axis 1
            parts.append(_v_initial(states))
        if hi > max(lo, 1):
            res = _v_range(states, max(lo, 1), hi - max(lo, 1))
            parts.append(res.frames)
            states = res.final_state
        return parts, states

    def save_parts(path, parts, sts):
        arrs = [jax.tree.map(np.asarray, p) for p in parts]
        frames = arrs[0] if len(arrs) == 1 else jax.tree.map(
            lambda *xs: np.concatenate(xs, axis=1), *arrs)
        _save_chunk(path, frames, jax.tree.map(np.asarray, sts))

    states = _pipelined_chunks(ckpt_dir, states, done=done,
                               n_chunks=n_chunks, chunk_size=chunk_frames,
                               n_units=n_frames, run_chunk=run_chunk,
                               save_chunk=save_parts,
                               stop_after_chunks=stop_after_chunks)
    if states is None:
        return None

    chunk_frames_list = []
    for c in range(n_chunks):
        f, states = _load_chunk(_chunk_path(ckpt_dir, c))
        chunk_frames_list.append(f)
    frames = jax.tree.map(
        lambda *xs: np.concatenate(xs, axis=1), *chunk_frames_list)
    return ParticleRunResult(frames=frames, final_state=states)
