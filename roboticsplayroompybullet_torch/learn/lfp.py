"""Learning-from-play consumer: goal-conditioned BC over play windows
(port of roboticsplayroompybullet_tpu/learn/lfp.py).

The reference exists to produce teleoperated play data for the author's
`learning_from_play` project (reference README.md:2-10): episodes are
replayed as random windows whose FINAL achieved goal relabels the window
as a goal-conditioned demonstration. This module reads the native episode
log (utils/episodelog.py), performs hindsight window relabelling (numpy,
copied from the JAX module), and trains a goal-conditioned policy
π(a | obs, goal) with torch.optim.Adam on the card.

The policy is the JAX package's flax MLP as an nn.Module; its parameters
carry over both ways (policy_params_from_jax / policy_params_to_jax), in
the leaf order the JAX package's save_pytree writes them.

No claim of matching the upstream LfP architecture (a seq2seq CVAE); the
deliverable is the data path: log → windows → relabel → train step.
"""
from __future__ import annotations

from typing import Dict, Mapping, Sequence, Tuple

import numpy as np
import torch
from torch import nn


# --------------------------------------------------------------------------
# hindsight window relabelling (the LfP batch construction)
# --------------------------------------------------------------------------

def relabel_windows(obs_w: np.ndarray, act_w: np.ndarray,
                    ag_w: np.ndarray) -> Dict[str, np.ndarray]:
    """(B, W, ·) windows → flat training batch with hindsight goals.

    Every step of a window is conditioned on the window's FINAL achieved
    goal — play data needs no reward or task labels, the future IS the
    goal (LfP relabelling; the reference's play envs expose exactly the
    achieved_goal layout this consumes, environments.py:804-839).
    """
    B, W, _ = obs_w.shape
    goal = np.repeat(ag_w[:, -1:, :], W, axis=1)        # (B, W, ag)
    return {
        "obs": obs_w.reshape(B * W, -1).astype(np.float32),
        "goal": goal.reshape(B * W, -1).astype(np.float32),
        "act": act_w.reshape(B * W, -1).astype(np.float32),
    }


def sample_lfp_batch(reader, rng: np.random.Generator, batch: int,
                     window: int,
                     fields: Tuple[str, str, str] = ("obs_quat", "action",
                                                     "achieved_goal"),
                     ) -> Dict[str, np.ndarray]:
    """Draw aligned windows of (obs, act, ag) from an EpisodeReader and
    relabel. Uses one episode/offset draw per window so the three fields
    stay aligned.

    Alignment: the collector (tools/collect_play_torch.py) logs the
    observation AFTER each action executes — row t is (obs_t, a_t) where
    obs_t is a_t's RESULT. A policy must map the obs it sees to the action
    taken FROM it, so the action window is shifted one step forward: obs_t
    is paired with a_{t+1} (training P(a|obs_before, goal), not inverse
    dynamics)."""
    f_obs, f_act, f_ag = fields
    di = {k: reader.dims[reader.names.index(k)] for k in fields}
    obs_w = np.empty((batch, window, di[f_obs]), np.float32)
    act_w = np.empty((batch, window, di[f_act]), np.float32)
    ag_w = np.empty((batch, window, di[f_ag]), np.float32)
    for b in range(batch):
        ep = int(rng.integers(reader.n_episodes))
        T = reader.episode_len(ep)
        # leave one row after the window so the shifted action exists
        t0 = int(rng.integers(max(T - window, 1)))

        def win(field, shift=0):
            arr = reader.read(ep, field)[t0 + shift:t0 + shift + window]
            if arr.shape[0] < window:
                arr = np.concatenate(
                    [arr] + [arr[-1:]] * (window - arr.shape[0]))
            return arr

        obs_w[b] = win(f_obs)
        act_w[b] = win(f_act, shift=1)
        ag_w[b] = win(f_ag)
    return relabel_windows(obs_w, act_w, ag_w)


def make_memory_sampler(reader, fields: Tuple[str, str, str] = (
        "obs_quat", "action", "achieved_goal")):
    """Load the whole log into RAM and return a vectorized window sampler
    with the same (obs_t, a_{t+1}) alignment as sample_lfp_batch (the
    per-window Python-loop reader is too slow for long runs). Requires
    fixed-length episodes (the batched collector's output).
    sampler(rng, batch, window) → relabelled flat batch."""
    f_obs, f_act, f_ag = fields
    E = reader.n_episodes
    arrs = {f: np.stack([reader.read(e, f) for e in range(E)])
            for f in fields}                              # (E, T, d) each
    T = arrs[f_obs].shape[1]

    def sample(rng: np.random.Generator, batch: int, window: int):
        eps = rng.integers(0, E, batch)
        t0 = rng.integers(0, max(T - window - 1, 1), batch)
        idx = t0[:, None] + np.arange(window)[None]       # (B, W)
        return relabel_windows(arrs[f_obs][eps[:, None], idx],
                               arrs[f_act][eps[:, None], idx + 1],
                               arrs[f_ag][eps[:, None], idx])

    return sample


# --------------------------------------------------------------------------
# policy + train step
# --------------------------------------------------------------------------

class GoalConditionedPolicy(nn.Module):
    """MLP π(a | obs ⊕ goal), tanh-squashed to the action box: flax's
    GoalConditionedPolicy, Dense_i as layers[i]."""

    def __init__(self, obs_dim: int, goal_dim: int, action_dim: int,
                 action_high: Sequence[float],
                 hidden: Sequence[int] = (256, 256)):
        super().__init__()
        widths = [obs_dim + goal_dim] + list(hidden) + [action_dim]
        self.layers = nn.ModuleList(
            nn.Linear(i, o) for i, o in zip(widths[:-1], widths[1:]))
        self.register_buffer("action_high",
                             torch.tensor(action_high, dtype=torch.float32),
                             persistent=False)

    def forward(self, obs: torch.Tensor, goal: torch.Tensor) -> torch.Tensor:
        x = torch.cat([obs, goal], dim=-1)
        for layer in self.layers[:-1]:
            x = torch.relu(layer(x))
        return torch.tanh(self.layers[-1](x)) * self.action_high


def make_train_step(policy: GoalConditionedPolicy,
                    opt: torch.optim.Optimizer):
    """train_step(batch) → loss (a 0-d tensor, not read back): one MSE
    step of Adam on a batch of tensors {"obs", "goal", "act"} on the
    policy's device. The parameters and Adam's moments live in `policy`
    and `opt`."""

    def train_step(batch: Mapping[str, torch.Tensor]) -> torch.Tensor:
        pred = policy(batch["obs"], batch["goal"])
        loss = torch.mean(torch.square(pred - batch["act"]))
        opt.zero_grad()
        loss.backward()
        opt.step()
        return loss.detach()

    return train_step


def _lecun_normal_(w: torch.Tensor, gen: torch.Generator) -> None:
    """flax's default Dense kernel init (variance_scaling(1, "fan_in",
    "truncated_normal")): a normal truncated to ±2 standard deviations,
    scaled to variance 1/fan_in; w is (out, in)."""
    std = float(np.sqrt(1.0 / w.shape[1])) / .87962566103423978
    draw = torch.empty(w.shape, dtype=w.dtype, device=gen.device)
    nn.init.trunc_normal_(draw, std=std, a=-2 * std, b=2 * std,
                          generator=gen)
    with torch.no_grad():
        w.copy_(draw)


def init_training(gen: torch.Generator, obs_dim: int, goal_dim: int,
                  action_dim: int, action_high: Sequence[float],
                  lr: float = 3e-4, hidden: Sequence[int] = (256, 256),
                  device="cuda"):
    """(policy, optimizer) ready for make_train_step, on `device` (the
    card unless the caller asks for the CPU). The kernels are drawn from
    `gen` with flax's initialisers (lecun normal, zero bias); the draws
    cannot match flax's, so a policy made here and one made by the JAX
    package from the same seed differ (carry parameters over with
    policy_params_from_jax instead). Adam is optax.adam's update: betas
    (0.9, 0.999), eps 1e-8 outside the square root."""
    policy = GoalConditionedPolicy(obs_dim, goal_dim, action_dim,
                                   action_high, hidden)
    for layer in policy.layers:
        _lecun_normal_(layer.weight, gen)
        nn.init.zeros_(layer.bias)
    policy = policy.to(device)
    opt = torch.optim.Adam(policy.parameters(), lr=lr, betas=(0.9, 0.999),
                           eps=1e-8)
    return policy, opt


# --------------------------------------------------------------------------
# parameters to and from the JAX package's flax layout
# --------------------------------------------------------------------------

def _flax_layer_names(n_layers: int):
    """Dense_i names in jax.tree_util's leaf order (dict keys sorted)."""
    return sorted(f"Dense_{i}" for i in range(n_layers))


def policy_params_to_jax(policy: GoalConditionedPolicy
                         ) -> Dict[str, torch.Tensor]:
    """The policy's parameters in flax's layout and leaf order:
    "Dense_i/bias" (out,) and "Dense_i/kernel" (in, out), Dense_i sorted
    as jax sorts dict keys. save_pytree of this mapping writes the file
    the JAX package's save_pytree writes for the flax parameters."""
    out = {}
    for name in _flax_layer_names(len(policy.layers)):
        layer = policy.layers[int(name.split("_")[1])]
        out[f"{name}/bias"] = layer.bias.detach()
        out[f"{name}/kernel"] = layer.weight.detach().T
    return out


def policy_params_from_jax(params) -> Dict[str, torch.Tensor]:
    """flax parameters → the policy's state_dict (CPU float32 tensors).

    `params` is the flax tree ({"params": {"Dense_i": {"kernel" (in, out),
    "bias" (out,)}}}) or its leaves in jax.tree_util order as a mapping:
    what np.load of a save_pytree file gives (leaf_0 = Dense_0/bias,
    leaf_1 = Dense_0/kernel, ..., and __n_leaves__) or what load_pytree
    returns; numpy arrays or tensors."""
    if "params" in params:
        layers = {k: (v["kernel"], v["bias"])
                  for k, v in params["params"].items()}
    else:
        leaves = list(params.values())
        if "__n_leaves__" in params:
            leaves = [params[f"leaf_{i}"]
                      for i in range(int(params["__n_leaves__"]))]
        if len(leaves) % 2:
            raise ValueError(f"{len(leaves)} leaves: not (bias, kernel) "
                             "pairs")
        layers = {name: (leaves[2 * j + 1], leaves[2 * j]) for j, name in
                  enumerate(_flax_layer_names(len(leaves) // 2))}
    sd = {}
    for name, (kernel, bias) in layers.items():
        i = int(name.split("_")[1])
        sd[f"layers.{i}.weight"] = _cpu32(kernel).T.contiguous()
        sd[f"layers.{i}.bias"] = _cpu32(bias)
    return sd


def policy_from_params(params, action_high: Sequence[float],
                       device="cuda") -> GoalConditionedPolicy:
    """A policy holding `params` (anything policy_params_from_jax takes),
    on `device`; its widths are read from the parameters' shapes. The
    first layer sees obs ⊕ goal: which part is which is the caller's."""
    sd = policy_params_from_jax(params)
    w = [sd[f"layers.{i}.weight"] for i in range(len(sd) // 2)]
    policy = GoalConditionedPolicy(w[0].shape[1], 0, w[-1].shape[0],
                                   action_high, [x.shape[0] for x in w[:-1]])
    policy.load_state_dict(sd)
    return policy.to(device)


def _cpu32(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", torch.float32)
    return torch.as_tensor(np.asarray(x, np.float32))
