"""Checkpoint / resume of carver state (SURVEY §5).

The reference persists only its 9 settings across invocations
(`gimp_set_data`, src/main.c:166-167,219-220).  Here the whole mid-carve state
(current luma + origcol + vmap + width + energy) is a pytree; a long carve can
be split into chunks of seams with a durable snapshot between chunks —
checkpoint-restart for the seam loop on preemptible jobs.

Two formats:
  * single-device: one .npz (portable; arrays this small need no orbax);
  * sharded (orbax): each host writes only its own shards (OCDBT), each
    chunk commits atomically into its own step directory, and restore is
    ABSTRACT (ShapeDtypeStruct targets with NamedShardings rebuilt from the
    partition specs recorded at save time) so no host materializes the full
    arrays.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import jax.numpy as jnp

from ..ops.carve import CarveState
from .config import CarverConfig

__all__ = ["save_state", "load_state", "carve_resumable",
           "save_sharded", "load_sharded"]

_FORMAT_VERSION = 2
_STEP_PREFIX = "state-"


# ------------------------------------------------- sharded (orbax) format --

def _leaf_specs(tree) -> dict:
    """Map flattened-path key -> list-of-axis-names partition spec (or None
    for replicated/unsharded leaves).  The specs travel WITH the checkpoint,
    so restore re-shards any pytree without name-based guessing."""
    import jax
    from jax.sharding import NamedSharding

    out = {}
    for kp, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = jax.tree_util.keystr(kp)
        spec = None
        if hasattr(leaf, "sharding") and isinstance(leaf.sharding,
                                                    NamedSharding):
            spec = [
                (list(e) if isinstance(e, tuple) else e)
                for e in leaf.sharding.spec
            ]
        out[key] = spec
    return out


def _as_tree(state):
    """NamedTuples save/restore as dicts keyed by field name (what orbax's
    StandardCheckpointer does anyway for the values; doing it explicitly keeps
    the spec keys and the restored structure consistent)."""
    return state._asdict() if hasattr(state, "_asdict") else state


def _step_dirs(path: str):
    import os

    if not os.path.isdir(path):
        return []
    steps = []
    for name in os.listdir(path):
        if (name.startswith(_STEP_PREFIX) and ".orbax" not in name
                and name[len(_STEP_PREFIX):].isdigit()):
            steps.append((int(name[len(_STEP_PREFIX):]), name))
    return sorted(steps)


def save_sharded(path: str, state, meta: dict) -> None:
    """Checkpoint a MESH-SHARDED carve state (parallel.spatial
    SpatialCarveState or any pytree of sharded arrays) with orbax.

    Each host writes only its own shards (orbax OCDBT).  Atomicity: every
    chunk saves into its own `state-{seams_done}` step directory (orbax
    commits the directory by rename, so a preempted save never surfaces as a
    restorable step), and the authoritative progress counter is the step
    name — a stale side-car meta.json can never pair old progress with new
    state.  Older steps are pruned only after the new one is committed.
    `meta` must carry `seams_done`; carve parameters in `meta` are validated
    on resume by the caller (parallel.spatial)."""
    import os
    import shutil
    import jax
    import orbax.checkpoint as ocp

    path = os.path.abspath(path)
    step = int(meta["seams_done"])
    tree = _as_tree(state)
    meta_full = {
        "version": _FORMAT_VERSION,
        "shardings": _leaf_specs(tree),
        **{k: v for k, v in meta.items()},
    }
    # the orbax save is a collective: every process calls it, each writing
    # only its own shards; it returns after the commit rename
    with ocp.StandardCheckpointer() as ckptr:
        # force=True: a fresh run reusing a checkpoint_dir may hit a step
        # number that already has a committed directory (e.g. the surviving
        # step of a previous run matching the new run's first chunk
        # boundary); overwrite it — the step-directory rename commit still
        # guarantees atomicity
        ckptr.save(os.path.join(path, f"{_STEP_PREFIX}{step:08d}"), tree,
                   force=True)
    if jax.process_index() == 0:
        # meta.json is static per run (progress lives in the step name);
        # tmp + atomic replace so readers never see a torn file
        tmp = os.path.join(path, ".meta.json.tmp")
        with open(tmp, "w") as f:
            json.dump(meta_full, f)
        os.replace(tmp, os.path.join(path, "meta.json"))
        for s, name in _step_dirs(path):
            if s != step:
                shutil.rmtree(os.path.join(path, name), ignore_errors=True)


def load_sharded(path: str, mesh, axis: str = None, state_cls=None):
    """Restore the newest committed step of a sharded checkpoint onto `mesh`.
    Returns (state, meta); meta["seams_done"] comes from the committed step
    name (never from the side-car file).  Restore is abstract: orbax reads
    each leaf directly into the NamedSharding recorded at save time, so each
    host touches only its own shards.  `axis` is unused (kept for signature
    compatibility); the sharding rule is the saved per-leaf partition spec,
    not field names."""
    import os
    import jax
    from etils import epath
    from jax.sharding import NamedSharding, PartitionSpec as P
    import orbax.checkpoint as ocp

    path = os.path.abspath(path)
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    if meta["version"] != _FORMAT_VERSION:
        raise ValueError(f"checkpoint version {meta['version']} unsupported")
    steps = _step_dirs(path)
    if not steps:
        raise FileNotFoundError(f"no committed checkpoint step under {path}")
    step, name = steps[-1]
    meta["seams_done"] = step
    specs = meta.pop("shardings")

    step_path = os.path.join(path, name)
    with ocp.StandardCheckpointer() as ckptr:
        md = ckptr.handler.metadata(epath.Path(step_path))

        def target(kp, m):
            spec = specs.get(jax.tree_util.keystr(kp))
            pspec = P() if spec is None else P(
                *[tuple(e) if isinstance(e, list) else e for e in spec])
            return jax.ShapeDtypeStruct(
                tuple(m.shape), m.dtype,
                sharding=NamedSharding(mesh, pspec))

        abstract = jax.tree_util.tree_map_with_path(
            target, md, is_leaf=lambda n: hasattr(n, "shape"))
        tree = ckptr.restore(step_path, abstract)
    if state_cls is not None:
        return state_cls(**tree), meta
    return tree, meta


def _config_to_jsonable(config: CarverConfig) -> dict:
    from ..ops.energy_fn import EnergyFunction, BUILTIN_ENERGIES

    d = dataclasses.asdict(config)
    e = d.get("energy")
    if isinstance(e, EnergyFunction):
        if BUILTIN_ENERGIES.get(e.name) is not e:
            raise ValueError(
                "custom EnergyFunction objects cannot be checkpointed; "
                "pass the builtin name in config.energy, or re-supply the "
                "function on resume"
            )
        d["energy"] = e.name
    return d


def save_state(path: str, state: CarveState, config: CarverConfig,
               seams_done: int, n_seams_total: int) -> None:
    meta = {
        "version": _FORMAT_VERSION,
        "seams_done": int(seams_done),
        "n_seams_total": int(n_seams_total),
        "config": _config_to_jsonable(config),
    }
    np.savez_compressed(
        path,
        luma=np.asarray(state.luma),
        origcol=np.asarray(state.origcol),
        vmap=np.asarray(state.vmap),
        width=np.asarray(state.width),
        energy=np.asarray(state.energy),
        meta=np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8),
    )


def load_state(path: str):
    """Returns (CarveState, CarverConfig, seams_done, n_seams_total)."""
    z = np.load(path)
    meta = json.loads(bytes(z["meta"]).decode())
    if meta["version"] not in (1, _FORMAT_VERSION):
        raise ValueError(f"checkpoint version {meta['version']} unsupported")
    state = CarveState(
        luma=jnp.asarray(z["luma"]),
        origcol=jnp.asarray(z["origcol"]),
        vmap=jnp.asarray(z["vmap"]),
        width=jnp.asarray(z["width"]),
        energy=jnp.asarray(z["energy"]),
    )
    cfg = CarverConfig(**meta["config"])
    return state, cfg, meta["seams_done"], meta["n_seams_total"]


def carve_resumable(
    luma,
    n_seams: int,
    config: CarverConfig,
    *,
    checkpoint_path: str | None = None,
    checkpoint_every: int = 0,
    resume_from: str | None = None,
    progress=None,
):
    """Carve with optional periodic checkpointing and resume.

    Runs the jitted seam loop in chunks of `checkpoint_every` seams (0 = one
    chunk), snapshotting after each chunk.  `progress` is an optional
    `Progress` (utils/progress.py) mirroring the liblqr progress hooks.
    """
    from ..ops.carve import (  # noqa: PLC0415
        make_state, _one_seam, full_energy_map, min_strip_width,
    )
    import jax

    if resume_from is not None:
        state, cfg_loaded, done, total = load_state(resume_from)
        if total != n_seams:
            raise ValueError(
                f"checkpoint was for {total} seams, requested {n_seams}"
            )
        config = cfg_loaded
    energy_fn = config.energy_function
    if resume_from is None:
        state = make_state(jnp.asarray(luma))
        e0 = jax.jit(
            full_energy_map, static_argnames=("blocksize", "energy_fn")
        )(state.luma, config.blocksize, config.edges, config.textures,
          energy_fn=energy_fn)
        state = state._replace(energy=e0)
        done = 0

    chunk = checkpoint_every if checkpoint_every > 0 else n_seams
    # same tiny-image guard as carve_n_seams: strips must fit in the buffer
    n_eff = energy_fn.n if energy_fn is not None else config.blocksize
    strip = config.strip_update and (
        state.luma.shape[1] >= min_strip_width(n_eff, config.delta_x)
    )
    @jax.jit
    def run_chunk(state, start, count):
        def body(i, s):
            return _one_seam(
                s, (start + i + 1).astype(jnp.int32), config.blocksize,
                config.edges, config.textures, strip,
                config.delta_x, config.rigidity, energy_fn,
                getattr(config, "tie", "leftmost"),
            )
        return jax.lax.fori_loop(0, count, body, state)

    if progress is not None:
        from .i18n import _ as _t

        progress.init(_t("Resizing width..."))
    while done < n_seams:
        count = min(chunk, n_seams - done)
        state = jax.block_until_ready(
            run_chunk(state, jnp.int32(done), jnp.int32(count))
        )
        done += count
        if progress is not None:
            progress.update(done / n_seams)
        if checkpoint_path is not None:
            save_state(checkpoint_path, state, config, done, n_seams)
    if progress is not None:
        progress.end()
    return state
