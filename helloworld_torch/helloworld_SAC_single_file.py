"""helloworld: SAC on Pendulum in ONE self-contained PyTorch file.

The PyTorch counterpart of ``helloworld/helloworld_SAC_single_file.py``: a
tanh-Gaussian actor with an auto-tuned temperature, a twin critic whose
minimum makes the TD target, and a replay ring on the device.  A round
collects ``horizon`` steps of every env, writes them into the ring, then
passes over the ring once in minibatch updates.  Randomness comes from
explicit ``torch.Generator`` objects.  On the card the update is captured
once as a CUDA graph and replayed (PyTorch's whole-network capture): one
step of these small nets is ~200 kernel launches, which the host would
otherwise issue one at a time, ~100,000 times a run.

Run:  python helloworld_torch/helloworld_SAC_single_file.py               (the card)
      python helloworld_torch/helloworld_SAC_single_file.py --device cpu
Expected: Pendulum avgR rises from ~-1200 to better than -250 within
~2e5 env steps.
"""

import argparse
import math
import time
from typing import NamedTuple

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

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


def mlp(dims, gen: torch.Generator) -> nn.Sequential:
    """Linear layers with tanh-GELU between them, uniform in +-1/sqrt(fan_in)
    from ``gen``."""
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


HP = dict(num_envs=8, horizon=100, gamma=0.97, lr=5e-4, batch=256,
          buf=200_000, tau=5e-3, net=(64, 64), total=int(2e5),
          reward_scale=1.0, target_entropy=0.0)


def actor_dist(actor: nn.Module, obs):
    mean, log_std = actor(obs).chunk(2, dim=-1)
    return mean, torch.clamp(log_std, -20, 2)


def sample_action(actor: nn.Module, obs, noise):
    """The tanh-squashed Gaussian action at standard-normal ``noise`` and its
    log-probability (the tanh correction in softplus form)."""
    mean, log_std = actor_dist(actor, obs)
    pre = mean + torch.exp(log_std) * noise
    logp = torch.sum(-log_std - 0.5 * noise ** 2 - 0.5 * math.log(2 * math.pi)
                     - 2.0 * (math.log(2.0) - pre - F.softplus(-2.0 * pre)), dim=-1)
    return torch.tanh(pre), logp


def q_twin(critic: nn.Module, obs, act):
    return critic(torch.cat([obs, act], dim=-1))          # (..., 2)


class Agent(NamedTuple):
    actor: nn.Module
    critic: nn.Module              # twin heads: output dim 2
    critic_tgt: nn.Module
    a_opt: torch.optim.Optimizer
    c_opt: torch.optim.Optimizer
    alpha_log: nn.Parameter        # ()
    al_opt: torch.optim.Optimizer


def agent_init(gen: torch.Generator, device) -> Agent:
    actor = mlp((3, *HP['net'], 2), gen).to(device)
    critic = mlp((4, *HP['net'], 2), gen).to(device)
    critic_tgt = mlp((4, *HP['net'], 2), gen).to(device)
    critic_tgt.load_state_dict(critic.state_dict())
    alpha_log = nn.Parameter(torch.tensor(-1.0, device=device))
    # capturable: the optimizers' step counts live on the device, so their
    # steps can be captured in a CUDA graph
    adam = dict(lr=HP['lr'], capturable=torch.device(device).type == 'cuda')
    return Agent(actor, critic, critic_tgt,
                 torch.optim.Adam(actor.parameters(), **adam),
                 torch.optim.Adam(critic.parameters(), **adam),
                 alpha_log, torch.optim.Adam([alpha_log], **adam))


def step_clipped(opt: torch.optim.Optimizer, params, loss: torch.Tensor) -> None:
    opt.zero_grad()
    loss.backward()
    nn.utils.clip_grad_norm_(params, 3.0)
    opt.step()


def update(ag: Agent, s, a, r, u, ns, noise_next, noise_pi):
    """One SAC step on a minibatch: the twin critic to the soft TD target
    (``noise_next``: the next action's draw), the soft target update, the
    temperature, then the actor (``noise_pi``: one draw for both the
    temperature's and the actor's sample).  Returns the three losses."""
    with torch.no_grad():
        na, nlp = sample_action(ag.actor, ns, noise_next)
        alpha = torch.exp(ag.alpha_log)
        target = r + HP['gamma'] * u * (torch.min(q_twin(ag.critic_tgt, ns, na), dim=-1).values
                                        - alpha * nlp)
    c_loss = torch.mean(torch.square(q_twin(ag.critic, s, a) - target[:, None]))
    step_clipped(ag.c_opt, ag.critic.parameters(), c_loss)
    with torch.no_grad():
        for t, o in zip(ag.critic_tgt.parameters(), ag.critic.parameters()):
            t.mul_(1 - HP['tau']).add_(o * HP['tau'])

    with torch.no_grad():
        _, lp_now = sample_action(ag.actor, s, noise_pi)
    al_loss = torch.mean(ag.alpha_log * (HP['target_entropy'] - lp_now))
    ag.al_opt.zero_grad()
    al_loss.backward()
    ag.al_opt.step()
    with torch.no_grad():
        ag.alpha_log.clamp_(-16, 2)
        alpha = torch.exp(ag.alpha_log)

    act_pg, lp = sample_action(ag.actor, s, noise_pi)
    a_loss = -torch.mean(torch.min(q_twin(ag.critic, s, act_pg), dim=-1).values - alpha * lp)
    step_clipped(ag.a_opt, ag.actor.parameters(), a_loss)
    return c_loss.detach(), al_loss.detach(), a_loss.detach()


class Ring:
    """(obs, act, rew, undone) rings of ``buf`` steps x ``num_envs``."""

    def __init__(self, device):
        m, n = HP['buf'], HP['num_envs']
        self.s = torch.zeros((m, n, 3), device=device)
        self.a = torch.zeros((m, n, 1), device=device)
        self.r = torch.zeros((m, n), device=device)
        self.u = torch.zeros((m, n), device=device)
        self.ptr, self.size = 0, 0

    def add(self, S, A, R, U):
        h = S.shape[0]
        idx = (self.ptr + torch.arange(h, device=S.device)) % HP['buf']
        self.s[idx], self.a[idx], self.r[idx], self.u[idx] = S, A, R, U
        self.ptr = (self.ptr + h) % HP['buf']
        self.size = min(self.size + h, HP['buf'])

    def gather(self, ids, rows):
        """The minibatch (s, a, r, u, s') at flat (step, env) ids below
        ``rows * num_envs`` (``rows``: an int or a 0-d tensor)."""
        i0, i1 = ids % rows, ids // rows
        return self.s[i0, i1], self.a[i0, i1], self.r[i0, i1], self.u[i0, i1], self.s[i0 + 1, i1]


class Updater:
    """``update`` on minibatches of the ring.  On the CPU it runs eagerly.
    On the card the first ``WARMUP`` updates run eagerly on a side stream
    (they create the gradients and the optimizers' moments, as capture
    requires), the next is captured as a CUDA graph from static inputs, and
    every update from then on copies its ids, row count and noise into those
    inputs and replays the graph.  ``losses`` holds the last update's three
    losses (on the card, the graph's own outputs after a replay)."""
    WARMUP = 3

    def __init__(self, agent: Agent, ring: Ring):
        self.agent, self.ring, self.done = agent, ring, 0
        self.cuda = ring.s.device.type == 'cuda'
        self.graph = self.losses = None

    def __call__(self, ids, rows: int, noise):
        if not self.cuda:
            self.losses = update(self.agent, *self.ring.gather(ids, rows), noise[0], noise[1])
        elif self.done < self.WARMUP:
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                self.losses = update(self.agent, *self.ring.gather(ids, rows),
                                     noise[0], noise[1])
            torch.cuda.current_stream().wait_stream(side)
        else:
            if self.graph is None:
                self.ids, self.noise = torch.empty_like(ids), torch.empty_like(noise)
                self.rows = torch.ones((), dtype=torch.int64, device=ids.device)
                for opt in (self.agent.a_opt, self.agent.c_opt, self.agent.al_opt):
                    opt.zero_grad(set_to_none=True)
                self.graph = torch.cuda.CUDAGraph()
                with torch.cuda.graph(self.graph):
                    self.losses = update(self.agent, *self.ring.gather(self.ids, self.rows),
                                         self.noise[0], self.noise[1])
            self.ids.copy_(ids)
            self.noise.copy_(noise)
            self.rows.fill_(rows)
            self.graph.replay()
        self.done += 1


class Carry(NamedTuple):
    agent: Agent
    ring: Ring
    updater: Updater
    env_state: EnvState
    obs: torch.Tensor
    gen: torch.Generator


def train_round(c: Carry):
    n, dev = HP['num_envs'], c.obs.device
    state, obs = c.env_state, c.obs
    S, A, R, U = [], [], [], []
    with torch.no_grad():
        for _ in range(HP['horizon']):
            act, _ = sample_action(c.agent.actor, obs,
                                   torch.randn((n, 1), generator=c.gen, device=dev))
            new_state, rew, done = env_step(state, act)
            fresh = env_init(c.gen, n, dev)
            state = EnvState(*[torch.where(done, f, o) for f, o in zip(fresh, new_state)])
            S.append(obs), A.append(act), R.append(rew * HP['reward_scale'])
            U.append(1.0 - done.float())
            obs = env_obs(state)
    c.ring.add(torch.stack(S), torch.stack(A), torch.stack(R), torch.stack(U))
    # one pass over the ring; the round's ids and noise drawn at once
    B, rows = HP['batch'], c.ring.size - 1
    n_upd = max(c.ring.size * n // B, 4)
    ids = torch.randint(0, rows * n, (n_upd, B), generator=c.gen, device=dev)
    noise = torch.randn((n_upd, 2, B, 1), generator=c.gen, device=dev)
    for k in range(n_upd):
        c.updater(ids[k], rows, noise[k])
    return c._replace(env_state=state, obs=obs), torch.stack(R).mean()


@torch.no_grad()
def evaluate(actor: nn.Module, gen: torch.Generator, num_envs: int = 16) -> float:
    dev = next(actor.parameters()).device
    state = env_init(gen, num_envs, dev)
    ret = torch.zeros(num_envs, device=dev)
    for _ in range(MAX_STEP):
        mean, _ = actor_dist(actor, env_obs(state))
        state, r, _ = env_step(state, torch.tanh(mean))
        ret = ret + r
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
    ring = Ring(device)
    state = env_init(gen, HP['num_envs'], device)
    return Carry(agent, ring, Updater(agent, ring), state, env_obs(state), gen)


def main(device=None):
    device = pick_device(device)
    carry = init_carry(device)
    n = HP['num_envs']
    rounds = HP['total'] // (HP['horizon'] * n)
    t0, best = time.time(), -1e9
    for i in range(8):
        for _ in range(max(1, rounds // 8)):
            carry, exp_r = train_round(carry)
        avg_r = evaluate(carry.agent.actor, torch.Generator(device=device).manual_seed(100 + i))
        best = max(best, avg_r)
        steps = (i + 1) * max(1, rounds // 8) * HP['horizon'] * n
        print(f"step {steps:8d}  time {time.time()-t0:6.1f}s  avgR {avg_r:8.1f}", flush=True)
    assert best > -250, f"SAC helloworld failed to learn (best {best})"
    print("helloworld SAC: learned. Twin critics + auto-alpha on the device.")
    return best


if __name__ == '__main__':
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('--device', default=None, help="'cuda' (default) or 'cpu'")
    main(parser.parse_args().device)
