"""Hopper-style planar locomotion env as batched tensors (counterpart of
``elegantrl_tpu/envs/hopper.py``): the spring-loaded-inverted-pendulum
(SLIP) hopping model.

- state: body (x, z, vx, vz), leg angle and length, foot anchor, phase
  (flight or stance);
- actions: [leg-angle target (+-0.5 rad), leg thrust (0..1)];
- flight: ballistic body, leg servo to the target angle, touchdown when the
  foot reaches the ground while falling;
- stance: radial spring leg plus thrust along the leg, liftoff when the leg
  re-extends while rising;
- reward ``vx + 0.5 - 0.05 ||a||^2``; terminal when the body falls below
  0.25; truncation at 1000 steps when not terminal.

The JAX env picks the branch per instance with ``lax.cond``; here both
branches are computed for the whole batch and blended with ``torch.where``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .base import EnvDef, EnvSpec, VecEnv

_DT = 0.01
_G = 9.8
_LEG_LEN = 0.55
_SPRING_K = 300.0
_THRUST = 60.0
_MASS = 1.0
_MIN_Z = 0.25
_MAX_STEP = 1000


class HopperState(NamedTuple):
    x: torch.Tensor          # body horizontal position, (N,) f32
    z: torch.Tensor          # body height
    vx: torch.Tensor
    vz: torch.Tensor
    leg_angle: torch.Tensor  # from vertical, + = forward
    leg_len: torch.Tensor    # current (compressed) leg length
    foot_x: torch.Tensor     # stance foot anchor
    stance: torch.Tensor     # (N,) bool: in ground contact
    t: torch.Tensor          # (N,) int32


def _init(gen: torch.Generator, num_envs: int, device) -> HopperState:
    u = torch.rand((2, num_envs), generator=gen, device=device)
    zero = torch.zeros(num_envs, device=device)
    return HopperState(zero, 0.9 + (-0.05 + 0.1 * u[0]), -0.1 + 0.2 * u[1], zero, zero,
                       torch.full_like(zero, _LEG_LEN), zero,
                       torch.zeros(num_envs, dtype=torch.bool, device=device),
                       torch.zeros(num_envs, dtype=torch.int32, device=device))


def _obs(s: HopperState) -> torch.Tensor:
    return torch.stack([s.z, s.vx, s.vz, s.leg_angle, s.leg_len / _LEG_LEN,
                        s.stance.float()], dim=-1)


def _step(s: HopperState, action: torch.Tensor, gen=None):
    a0, a1 = action[..., 0], action[..., 1]
    target_angle = torch.clamp(a0, -1.0, 1.0) * 0.5
    thrust = torch.clamp(a1, -1.0, 1.0) * 0.5 + 0.5

    # flight: servo the leg toward the target angle; ballistic body
    fl_angle = s.leg_angle + 10.0 * (target_angle - s.leg_angle) * _DT
    fl_vz = s.vz - _G * _DT
    fl_z = s.z + fl_vz * _DT
    fl_x = s.x + s.vx * _DT
    foot_z = fl_z - _LEG_LEN * torch.cos(fl_angle)
    touchdown = (foot_z <= 0.0) & (fl_vz < 0)
    fl_foot_x = torch.where(touchdown, fl_x + _LEG_LEN * torch.sin(fl_angle), s.foot_x)

    # stance: spring + thrust along the leg from the anchored foot
    dx = s.x - s.foot_x
    dz = s.z
    leg_len = torch.sqrt(dx * dx + dz * dz)
    compress = torch.clamp(_LEG_LEN - leg_len, min=0.0)
    force = _SPRING_K * compress + _THRUST * thrust
    ux, uz = dx / (leg_len + 1e-6), dz / (leg_len + 1e-6)
    st_vx = s.vx + force * ux / _MASS * _DT
    st_vz = s.vz + (force * uz / _MASS - _G) * _DT
    st_x = s.x + st_vx * _DT
    st_z = s.z + st_vz * _DT
    new_len = torch.sqrt((st_x - s.foot_x) ** 2 + st_z * st_z)
    liftoff = (new_len >= _LEG_LEN) & (st_vz > 0)
    st_angle = torch.atan2(st_x - s.foot_x, st_z)

    st = s.stance
    t = s.t + 1
    new = HopperState(
        x=torch.where(st, st_x, fl_x), z=torch.where(st, st_z, fl_z),
        vx=torch.where(st, st_vx, s.vx), vz=torch.where(st, st_vz, fl_vz),
        leg_angle=torch.where(st, st_angle, fl_angle),
        leg_len=torch.where(st, new_len, torch.full_like(new_len, _LEG_LEN)),
        foot_x=torch.where(st, s.foot_x, fl_foot_x),
        stance=torch.where(st, ~liftoff, touchdown), t=t)
    reward = new.vx + 0.5 - 0.05 * (torch.square(a0) + torch.square(a1))
    terminal = new.z < _MIN_Z
    truncate = (t >= _MAX_STEP) & ~terminal
    return new, reward, terminal, truncate


def make_hopper() -> EnvDef:
    spec = EnvSpec(env_name='HopperSlip-v0', num_envs=1, max_step=_MAX_STEP,
                   state_dim=6, action_dim=2, if_discrete=False)
    return EnvDef(spec=spec, init=_init, obs=_obs, step=_step)


class HopperEnv(VecEnv):
    def __init__(self, num_envs: int = 1, seed: int = 0, device: str = None, **_kwargs):
        super().__init__(make_hopper(), num_envs=num_envs, seed=seed, device=device)
