"""Import-guarded gym/gymnasium interop shim (port of
roboticsplayroompybullet_tpu/gym_registry.py).

The reference's public API surface is `gym.make('UR5PlayAbsRPY1Obj-v0')`
via 20 `gym.envs.registration.register` calls at package import
(reference roboticsPlayroomPybullet/__init__.py:3-99). When `gym` (or its
successor `gymnasium`) is importable, `register_gym_envs()` registers every
live catalog id with an entry point that builds the port's numpy-I/O
`PlayEnv` (on the card unless the caller passes device="cpu"). Without gym
installed, nothing happens; `envs.wrapper.make` is the primary interface
either way. The reference's dead `pointMass3D-v0` registration is not
reproduced.
"""
from __future__ import annotations

from functools import partial

from .envs.config import CATALOG
from .envs.wrapper import PlayEnv


def _entry_point(env_id: str, **kwargs):
    return PlayEnv(CATALOG[env_id], **kwargs)


def register_gym_envs(module=None) -> bool:
    """Register all catalog ids with gym/gymnasium if available.

    `module` injects a registry module for tests. Returns True if a
    registry was found and the envs are registered (idempotent: ids
    already present are skipped), False if no gym-like package exists.
    """
    reg = module
    if reg is None:
        try:
            import gym as reg                             # noqa: F401
        except Exception:
            try:
                import gymnasium as reg                   # noqa: F401
            except Exception:
                return False
    try:
        registry = reg.envs.registry
        # gym<0.26 exposes .env_specs dict; newer gym/gymnasium are a dict
        existing = getattr(registry, "env_specs", registry)
    except Exception:
        existing = {}
    for env_id in CATALOG:
        if env_id in existing:
            continue
        cfg = CATALOG[env_id]
        kwargs_trials = (
            # gymnasium: skip its api/order wrappers — PlayEnv speaks the
            # classic gym API the reference used (reset()->obs,
            # step()->(obs, r, done, info))
            dict(max_episode_steps=cfg.max_episode_steps,
                 order_enforce=False, disable_env_checker=True),
            dict(max_episode_steps=cfg.max_episode_steps),
            {},
        )
        for kw in kwargs_trials:
            try:
                reg.register(id=env_id,
                             entry_point=partial(_entry_point, env_id),
                             **kw)
                break
            except TypeError:
                continue
    return True
