"""helloworld: REINFORCE on CartPole in ONE self-contained PyTorch file.

The PyTorch counterpart of
``helloworld/helloworld_REINFORCE_single_file.py``: the simplest
policy-gradient algorithm, with Monte-Carlo returns cut at episode ends, no
critic and no replay.  A round collects ``horizon`` steps of every env,
walks the returns backwards and takes one gradient step.  Randomness comes
from explicit ``torch.Generator`` objects.

Run:  python helloworld_torch/helloworld_REINFORCE_single_file.py               (the card)
      python helloworld_torch/helloworld_REINFORCE_single_file.py --device cpu
Expected: CartPole avgR rises from ~20 to >300 within ~6e5 env steps.
"""

import argparse
import time
from typing import NamedTuple

import numpy as np
import torch
from torch import nn

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
    return EnvState(*[torch.where(mask, x, y) for x, y in zip(a, b)])


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


HP = dict(num_envs=32, horizon=256, gamma=0.99, lr=1e-3, net=(64, 64),
          total=int(6e5))


def returns(R, U):
    """Discounted returns, walking backwards and cut at episode ends,
    normalised over the whole round."""
    ret, out = torch.zeros_like(R[0]), []
    for t in reversed(range(R.shape[0])):
        ret = R[t] + HP['gamma'] * U[t] * ret
        out.append(ret)
    G = torch.stack(out[::-1])
    return (G - G.mean()) / (G.std(correction=0) + 1e-6)


def update(policy: nn.Module, opt: torch.optim.Optimizer, S, A, G) -> torch.Tensor:
    """One policy-gradient step: ``-mean(log pi(a|s) G)``, gradients clipped
    to global norm 3, Adam."""
    logp = torch.log_softmax(policy(S), dim=-1).gather(-1, A[..., None])[..., 0]
    loss = -torch.mean(logp * G)
    opt.zero_grad()
    loss.backward()
    nn.utils.clip_grad_norm_(policy.parameters(), 3.0)
    opt.step()
    return loss.detach()


class Carry(NamedTuple):
    policy: nn.Module
    opt: torch.optim.Optimizer
    env_state: EnvState
    obs: torch.Tensor
    gen: torch.Generator


def train_round(c: Carry):
    n, dev = HP['num_envs'], c.obs.device
    state, obs = c.env_state, c.obs
    S, A, R, U = [], [], [], []
    with torch.no_grad():
        for _ in range(HP['horizon']):
            probs = torch.softmax(c.policy(obs), dim=-1)
            act = torch.multinomial(probs, 1, generator=c.gen)[:, 0]
            new_state, rew, done = env_step(state, act)
            state = where_state(done, env_init(c.gen, n, dev), new_state)
            S.append(obs), A.append(act), R.append(rew), U.append(1.0 - done.float())
            obs = env_obs(state)
        S, A, R, U = map(torch.stack, (S, A, R, U))
        G = returns(R, U)
    update(c.policy, c.opt, S, A, G)
    return c._replace(env_state=state, obs=obs), R.mean()


@torch.no_grad()
def evaluate(policy: nn.Module, gen: torch.Generator, num_envs: int = 16) -> float:
    """Mean return of greedy episodes (each stops at its first done)."""
    dev = next(policy.parameters()).device
    state = env_init(gen, num_envs, dev)
    ret = torch.zeros(num_envs, device=dev)
    alive = torch.ones(num_envs, device=dev)
    for _ in range(MAX_STEP):
        a = torch.argmax(policy(env_obs(state)), dim=-1)
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
    policy = mlp((4, *HP['net'], 2), torch.Generator().manual_seed(0)).to(device)
    state = env_init(gen, HP['num_envs'], device)
    return Carry(policy, torch.optim.Adam(policy.parameters(), lr=HP['lr']), state,
                 env_obs(state), gen)


def main(device=None):
    device = pick_device(device)
    carry = init_carry(device)
    rounds = HP['total'] // (HP['horizon'] * HP['num_envs'])
    t0, best = time.time(), 0.0
    for i in range(8):
        for _ in range(max(1, rounds // 8)):
            carry, exp_r = train_round(carry)
        avg_r = evaluate(carry.policy, torch.Generator(device=device).manual_seed(100 + i))
        best = max(best, avg_r)
        steps = (i + 1) * max(1, rounds // 8) * HP['horizon'] * HP['num_envs']
        print(f"step {steps:8d}  time {time.time()-t0:6.1f}s  avgR {avg_r:8.1f}", flush=True)
    assert best > 300, f"REINFORCE helloworld failed to learn (best {best})"
    print("helloworld REINFORCE: learned. Pure policy gradient on the device.")
    return best


if __name__ == '__main__':
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('--device', default=None, help="'cuda' (default) or 'cpu'")
    main(parser.parse_args().device)
