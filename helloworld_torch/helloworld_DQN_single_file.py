"""helloworld: DQN on CartPole in ONE self-contained PyTorch file.

The PyTorch counterpart of ``helloworld/helloworld_DQN_single_file.py``:
the env is a batch of tensors stepped by one function, the Q-network an
``nn.Module``, the replay ring lives on the device, and exploration is
epsilon-greedy.  A round collects ``horizon`` steps of every env, writes
them into the ring, then runs the TD minibatch updates.  Randomness comes
from explicit ``torch.Generator`` objects.

Run:  python helloworld_torch/helloworld_DQN_single_file.py               (the card)
      python helloworld_torch/helloworld_DQN_single_file.py --device cpu
Expected: CartPole avgR (episode length) rises from ~10 to >150 within
~6e4 env steps.
"""

import argparse
import time
from typing import NamedTuple

import numpy as np
import torch
from torch import nn

# ---------------------------------------------------------------- CartPole env
MAX_STEP = 500


class EnvState(NamedTuple):
    x: torch.Tensor     # (N,) each
    v: torch.Tensor
    th: torch.Tensor
    w: torch.Tensor
    t: torch.Tensor     # (N,) int32


def env_init(gen: torch.Generator, num_envs: int, device) -> EnvState:
    s = torch.rand((num_envs, 4), generator=gen, device=device) * 0.1 - 0.05
    return EnvState(s[:, 0], s[:, 1], s[:, 2], s[:, 3],
                    torch.zeros(num_envs, dtype=torch.int32, device=device))


def env_obs(s: EnvState) -> torch.Tensor:
    return torch.stack([s.x, s.v, s.th, s.w], dim=-1)


def env_step(s: EnvState, action: torch.Tensor):
    force = torch.where(action == 1, 10.0, -10.0)
    ct, st = torch.cos(s.th), torch.sin(s.th)
    tmp = (force + 0.05 * s.w ** 2 * st) / 1.1
    wa = (9.8 * st - ct * tmp) / (0.5 * (4 / 3 - 0.1 * ct ** 2 / 1.1))
    xa = tmp - 0.05 * wa * ct / 1.1
    ns = EnvState(s.x + 0.02 * s.v, s.v + 0.02 * xa, s.th + 0.02 * s.w, s.w + 0.02 * wa,
                  s.t + 1)
    done = (torch.abs(ns.x) > 2.4) | (torch.abs(ns.th) > 0.2095) | (ns.t >= MAX_STEP)
    return ns, torch.ones_like(ns.x), done


def where_state(mask: torch.Tensor, a: EnvState, b: EnvState) -> EnvState:
    """``a`` where ``mask``, else ``b``, field by field."""
    return EnvState(*[torch.where(mask, x, y) for x, y in zip(a, b)])


# ------------------------------------------------------------------- Q-network
def mlp(dims, gen: torch.Generator) -> nn.Sequential:
    """Linear layers with tanh-GELU between them, weights and biases uniform
    in +-1/sqrt(fan_in) drawn from ``gen``."""
    layers = []
    for i in range(len(dims) - 1):
        lin = nn.Linear(dims[i], dims[i + 1])
        bound = 1.0 / np.sqrt(dims[i])
        with torch.no_grad():
            lin.weight.uniform_(-bound, bound, generator=gen)
            lin.bias.uniform_(-bound, bound, generator=gen)
        layers.append(lin)
        if i < len(dims) - 2:
            layers.append(nn.GELU(approximate='tanh'))
    return nn.Sequential(*layers)


HP = dict(num_envs=16, horizon=64, gamma=0.99, lr=1e-3, batch=128,
          buf_size=50_000, eps=0.15, tau=5e-3, net_dims=(128, 128),
          total_steps=int(6e4))


def soft_update(target: nn.Module, online: nn.Module, tau: float) -> None:
    with torch.no_grad():
        for t, o in zip(target.parameters(), online.parameters()):
            t.mul_(1 - tau).add_(o * tau)


class Agent(NamedTuple):
    q: nn.Module
    q_tgt: nn.Module
    opt: torch.optim.Optimizer


def agent_init(gen: torch.Generator, device) -> Agent:
    q = mlp((4, *HP['net_dims'], 2), gen).to(device)
    q_tgt = mlp((4, *HP['net_dims'], 2), gen).to(device)
    q_tgt.load_state_dict(q.state_dict())
    return Agent(q, q_tgt, torch.optim.Adam(q.parameters(), lr=HP['lr']))


def update(agent: Agent, s, a, r, u, ns) -> torch.Tensor:
    """One TD step on a minibatch: MSE to ``r + gamma u max Q_tgt(s')``,
    gradients clipped to global norm 3, Adam, then the soft target update."""
    with torch.no_grad():
        target = r + HP['gamma'] * u * agent.q_tgt(ns).max(dim=-1).values
    qv = agent.q(s).gather(1, a[:, None])[:, 0]
    loss = torch.mean((qv - target) ** 2)
    agent.opt.zero_grad()
    loss.backward()
    nn.utils.clip_grad_norm_(agent.q.parameters(), 3.0)
    agent.opt.step()
    soft_update(agent.q_tgt, agent.q, HP['tau'])
    return loss.detach()


class Ring:
    """(obs, act, rew, undone) rings of ``buf_size`` steps x ``num_envs``."""

    def __init__(self, device):
        m, n = HP['buf_size'], HP['num_envs']
        self.s = torch.zeros((m, n, 4), device=device)
        self.a = torch.zeros((m, n), dtype=torch.int64, device=device)
        self.r = torch.zeros((m, n), device=device)
        self.u = torch.zeros((m, n), device=device)
        self.ptr, self.size = 0, 0

    def add(self, S, A, R, U):
        h = S.shape[0]
        idx = (self.ptr + torch.arange(h, device=S.device)) % HP['buf_size']
        self.s[idx], self.a[idx], self.r[idx], self.u[idx] = S, A, R, U
        self.ptr = (self.ptr + h) % HP['buf_size']
        self.size = min(self.size + h, HP['buf_size'])

    def sample(self, gen: torch.Generator):
        """A minibatch of (s, a, r, u, s') at uniform (step, env) ids."""
        rows = self.size - 1
        ids = torch.randint(0, rows * HP['num_envs'], (HP['batch'],), generator=gen,
                            device=self.s.device)
        i0, i1 = ids % rows, ids // rows
        return self.s[i0, i1], self.a[i0, i1], self.r[i0, i1], self.u[i0, i1], self.s[i0 + 1, i1]


class Carry(NamedTuple):
    agent: Agent
    ring: Ring
    env_state: EnvState
    obs: torch.Tensor
    gen: torch.Generator


def train_round(c: Carry):
    """Rollout -> ring insert -> TD updates; returns the carry and the mean
    step reward."""
    n, dev = HP['num_envs'], c.obs.device
    state, obs = c.env_state, c.obs
    S, A, R, U = [], [], [], []
    for _ in range(HP['horizon']):
        with torch.no_grad():
            greedy = torch.argmax(c.agent.q(obs), dim=-1)
        rand = torch.randint(0, 2, (n,), generator=c.gen, device=dev)
        act = torch.where(torch.rand(n, generator=c.gen, device=dev) < HP['eps'], rand, greedy)
        new_state, rew, done = env_step(state, act)
        state = where_state(done, env_init(c.gen, n, dev), new_state)
        S.append(obs), A.append(act), R.append(rew), U.append(1.0 - done.float())
        obs = env_obs(state)
    c.ring.add(torch.stack(S), torch.stack(A), torch.stack(R), torch.stack(U))
    # replay ratio grows with the ring (reference: cur_size * repeat / batch)
    n_upd = max(c.ring.size * n // (HP['batch'] * 8), 4)
    for _ in range(n_upd):
        update(c.agent, *c.ring.sample(c.gen))
    return c._replace(env_state=state, obs=obs), torch.stack(R).mean()


@torch.no_grad()
def evaluate(q: nn.Module, gen: torch.Generator, num_envs: int = 16) -> float:
    """Mean return of greedy episodes (each stops at its first done)."""
    dev = next(q.parameters()).device
    state = env_init(gen, num_envs, dev)
    ret = torch.zeros(num_envs, device=dev)
    alive = torch.ones(num_envs, device=dev)
    for _ in range(MAX_STEP):
        a = torch.argmax(q(env_obs(state)), dim=-1)
        new_state, r, done = env_step(state, a)
        ret = ret + r * alive
        alive = alive * (1.0 - done.float())
        state = where_state(alive == 0, state, new_state)
    return float(ret.mean())


def pick_device(device=None) -> torch.device:
    """None is the CUDA card; without one that raises, naming the CPU choice."""
    device = torch.device('cuda' if device is None else device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError('torch.cuda.is_available() is False: no CUDA card; '
                           'run with --device cpu (main(device="cpu")) for the CPU')
    return device


def init_carry(device) -> Carry:
    gen = torch.Generator(device=device).manual_seed(0)
    agent = agent_init(torch.Generator().manual_seed(0), device)
    env_state = env_init(gen, HP['num_envs'], device)
    return Carry(agent, Ring(device), env_state, env_obs(env_state), gen)


def main(device=None):
    device = pick_device(device)
    carry = init_carry(device)
    rounds = HP['total_steps'] // (HP['horizon'] * HP['num_envs'])
    t0 = time.time()
    best = 0.0
    for i in range(8):
        for _ in range(max(1, rounds // 8)):
            carry, exp_r = train_round(carry)
        avg_r = evaluate(carry.agent.q, torch.Generator(device=device).manual_seed(100 + i))
        best = max(best, avg_r)
        steps = (i + 1) * max(1, rounds // 8) * HP['horizon'] * HP['num_envs']
        print(f"step {steps:8d}  time {time.time()-t0:6.1f}s  avgR {avg_r:8.1f}", flush=True)
    assert best > 150, f"DQN helloworld failed to learn (best {best})"
    print("helloworld DQN: learned. Replay ring + TD loop on the device.")
    return best


if __name__ == '__main__':
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('--device', default=None, help="'cuda' (default) or 'cpu'")
    main(parser.parse_args().device)
