"""helloworld: PPO on Pendulum in ONE self-contained PyTorch file.

The PyTorch counterpart of ``helloworld/helloworld_PPO_single_file.py``:
the env is a batch of tensors stepped by one function with a masked
auto-reset, the actor and critic are ``nn.Module`` MLPs, and a training
round is rollout -> GAE -> minibatch SGD on the device.  Randomness comes
from explicit ``torch.Generator`` objects.

Run:  python helloworld_torch/helloworld_PPO_single_file.py               (the card)
      python helloworld_torch/helloworld_PPO_single_file.py --device cpu
Expected: Pendulum avgR rises from ~-1100 to better than -400 within
~1.6e5 env steps.
"""

import argparse
import math
import time
from typing import NamedTuple

import numpy as np
import torch
from torch import nn

# ---------------------------------------------------------------- Pendulum env
MAX_STEP, DT, G = 200, 0.05, 10.0


class EnvState(NamedTuple):
    theta: torch.Tensor       # (N,) each
    theta_dot: torch.Tensor
    t: torch.Tensor           # (N,) int32


def env_init(gen: torch.Generator, num_envs: int, device) -> EnvState:
    u = torch.rand((2, num_envs), generator=gen, device=device)
    return EnvState(u[0] * (2 * math.pi) - math.pi, u[1] * 2.0 - 1.0,
                    torch.zeros(num_envs, dtype=torch.int32, device=device))


def env_obs(s: EnvState) -> torch.Tensor:
    return torch.stack([torch.cos(s.theta), torch.sin(s.theta), s.theta_dot], dim=-1)


def env_step(s: EnvState, action: torch.Tensor):
    """``action`` (N, 1) in [-1, 1] -> (state', reward, done)."""
    u = torch.clamp(action[:, 0] * 2.0, -2.0, 2.0)
    th_wrap = ((s.theta + math.pi) % (2 * math.pi)) - math.pi
    cost = th_wrap ** 2 + 0.1 * s.theta_dot ** 2 + 0.001 * u ** 2
    theta_dot = torch.clamp(s.theta_dot + (1.5 * G * torch.sin(s.theta) + 3.0 * u) * DT,
                            -8.0, 8.0)
    theta = s.theta + theta_dot * DT
    t = s.t + 1
    return EnvState(theta, theta_dot, t), -0.5 * cost, t >= MAX_STEP


def vec_step(state: EnvState, actions: torch.Tensor, gen: torch.Generator):
    """Step all envs; the done ones restart (masked, no Python branches)."""
    new_state, rewards, dones = env_step(state, actions)
    fresh = env_init(gen, actions.shape[0], actions.device)
    state = EnvState(*[torch.where(dones, f, o) for f, o in zip(fresh, new_state)])
    return state, env_obs(state), rewards, dones


# ------------------------------------------------------------------- networks
def mlp(dims, gen: torch.Generator, out_std=None) -> nn.Sequential:
    """Linear layers with tanh-GELU between them, uniform in +-1/sqrt(fan_in)
    from ``gen``; with ``out_std`` the last layer is orthogonal at that gain
    with biases 1e-6."""
    layers = []
    for i in range(len(dims) - 1):
        lin = nn.Linear(dims[i], dims[i + 1])
        with torch.no_grad():
            if i == len(dims) - 2 and out_std is not None:
                nn.init.orthogonal_(lin.weight, gain=out_std, generator=gen)
                lin.bias.fill_(1e-6)
            else:
                bound = 1.0 / np.sqrt(dims[i])
                lin.weight.uniform_(-bound, bound, generator=gen)
                lin.bias.uniform_(-bound, bound, generator=gen)
        layers.append(lin)
        if i < len(dims) - 2:
            layers.append(nn.GELU(approximate='tanh'))
    return nn.Sequential(*layers)


# ------------------------------------------------------------------ PPO agent
HP = dict(num_envs=16, horizon=512, gamma=0.97, lam=0.95, clip=0.25,
          lr=4e-4, batch=128, repeat=32, lambda_entropy=0.001,
          net_dims=(64, 64), total_steps=int(1.6e5))


class Agent(NamedTuple):
    actor: nn.Module
    std_log: nn.Parameter            # (1, 1)
    critic: nn.Module
    actor_opt: torch.optim.Optimizer
    critic_opt: torch.optim.Optimizer


def agent_init(gen: torch.Generator, device) -> Agent:
    actor = mlp((3, *HP['net_dims'], 1), gen, out_std=0.1).to(device)
    critic = mlp((3, *HP['net_dims'], 1), gen, out_std=0.5).to(device)
    std_log = nn.Parameter(torch.zeros((1, 1), device=device))
    return Agent(actor, std_log, critic,
                 torch.optim.Adam([*actor.parameters(), std_log], lr=HP['lr']),
                 torch.optim.Adam(critic.parameters(), lr=HP['lr']))


def logprob_fn(mean, std, a):
    z = (a - mean) / std
    return torch.sum(-0.5 * z ** 2 - torch.log(std) - 0.5 * math.log(2 * math.pi), dim=-1)


def step_clipped(opt: torch.optim.Optimizer, loss: torch.Tensor) -> None:
    """Gradient of ``loss``, clipped to global norm 3 over the optimizer's
    parameters, then one Adam step."""
    opt.zero_grad()
    loss.backward()
    nn.utils.clip_grad_norm_([p for g in opt.param_groups for p in g['params']], 3.0)
    opt.step()


def update(agent: Agent, s, a, lp, adv, tgt):
    """One minibatch step: the critic's MSE, then the clipped surrogate with
    the entropy bonus; returns both losses."""
    critic_loss = torch.mean((agent.critic(s)[:, 0] - tgt) ** 2)
    step_clipped(agent.critic_opt, critic_loss)
    mean, std = agent.actor(s), torch.exp(agent.std_log)
    ratio = torch.exp(logprob_fn(mean, std, a) - lp)
    surr = torch.minimum(adv * ratio, adv * torch.clamp(ratio, 1 - HP['clip'], 1 + HP['clip']))
    ent = torch.sum(0.5 + 0.5 * math.log(2 * math.pi) + torch.log(std), dim=-1)
    actor_loss = -(surr.mean() - HP['lambda_entropy'] * ent.mean())
    step_clipped(agent.actor_opt, actor_loss)
    return critic_loss.detach(), actor_loss.detach()


def advantages(R, U, V, next_v):
    """GAE(lambda), walking the horizon backwards; returns (adv, target)."""
    adv, nv = torch.zeros_like(next_v), next_v
    out = []
    for t in reversed(range(R.shape[0])):
        delta = R[t] + HP['gamma'] * U[t] * nv - V[t]
        adv = delta + HP['gamma'] * HP['lam'] * U[t] * adv
        nv = V[t]
        out.append(adv)
    ADV = torch.stack(out[::-1])
    return ADV, ADV + V


class Carry(NamedTuple):
    agent: Agent
    env_state: EnvState
    obs: torch.Tensor
    gen: torch.Generator


def train_round(c: Carry):
    agent, state, obs, gen = c
    H, N, dev = HP['horizon'], HP['num_envs'], obs.device
    S, A, LP, R, U = [], [], [], [], []
    with torch.no_grad():
        std = torch.exp(agent.std_log)
        for _ in range(H):
            mean = agent.actor(obs)
            a = mean + std * torch.randn(mean.shape, generator=gen, device=dev)
            lp = logprob_fn(mean, std, a)
            state, nobs, r, done = vec_step(state, torch.tanh(a), gen)
            S.append(obs), A.append(a), LP.append(lp), R.append(r), U.append(1.0 - done.float())
            obs = nobs
        S, A, LP, R, U = map(torch.stack, (S, A, LP, R, U))
        V = agent.critic(S)[..., 0]                                 # (H, N)
        ADV, TARGET = advantages(R, U, V, agent.critic(obs)[:, 0])
        ADV = (ADV - ADV.mean()) / (ADV.std(correction=0) + 1e-5)

    for _ in range(H * HP['repeat'] // HP['batch']):
        ids = torch.randint(0, H * N, (HP['batch'],), generator=gen, device=dev)
        i0, i1 = ids % H, ids // H
        update(agent, S[i0, i1], A[i0, i1], LP[i0, i1], ADV[i0, i1], TARGET[i0, i1])
    return Carry(agent, state, obs, gen), R.mean()


@torch.no_grad()
def evaluate(agent: Agent, gen: torch.Generator, num_envs: int = 16) -> float:
    dev = agent.std_log.device
    state = env_init(gen, num_envs, dev)
    ret = torch.zeros(num_envs, device=dev)
    for _ in range(MAX_STEP):
        state, r, _ = env_step(state, torch.tanh(agent.actor(env_obs(state))))
        ret = ret + r
    return float(ret.mean())


def pick_device(device=None) -> torch.device:
    """None is the CUDA card; without one that raises, naming the CPU choice."""
    device = torch.device('cuda' if device is None else device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError('torch.cuda.is_available() is False: no CUDA card; '
                           'run with --device cpu (main(device="cpu")) for the CPU')
    return device


def init_carry(device, seed: int = 0) -> Carry:
    gen = torch.Generator(device=device).manual_seed(seed)
    agent = agent_init(torch.Generator().manual_seed(seed), device)
    state = env_init(gen, HP['num_envs'], device)
    return Carry(agent, state, env_obs(state), gen)


def main(device=None, seed: int = 0):
    device = pick_device(device)
    carry = init_carry(device, seed)
    rounds = HP['total_steps'] // (HP['horizon'] * HP['num_envs'])
    t0 = time.time()
    for i in range(8):
        for _ in range(max(1, rounds // 8)):
            carry, exp_r = train_round(carry)
        avg_r = evaluate(carry.agent, torch.Generator(device=device).manual_seed(100 + i))
        steps = (i + 1) * max(1, rounds // 8) * HP['horizon'] * HP['num_envs']
        print(f"step {steps:8d}  time {time.time()-t0:6.1f}s  "
              f"expR {float(exp_r):8.3f}  avgR {avg_r:8.1f}", flush=True)
    assert avg_r > -400, "PPO helloworld failed to learn"
    print("helloworld PPO: solved-ish. Rollout, GAE and SGD on the device.")
    return avg_r


if __name__ == '__main__':
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('--device', default=None, help="'cuda' (default) or 'cpu'")
    parser.add_argument('--seed', type=int, default=0, help='the training seed')
    opts = parser.parse_args()
    main(opts.device, opts.seed)
