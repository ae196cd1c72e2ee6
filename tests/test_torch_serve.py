"""``elegantrl_tpu_torch/serve.py`` against ``elegantrl_tpu/serve.py`` on
the CPU: a checkpoint saved by the JAX package (``build_training`` +
``save_pytree``) is served by both servers over HTTP, and the port's
actions equal the JAX server's within atol 1e-6, rtol 1e-5 (float32
forwards whose sums run in another order; discrete actions exactly), for
PPO, SAC and DQN; the HTTP surface (``/health``, 404, 400, 500, one
observation), four client threads, more threads than cores under a short
switch interval (no lost count), and the default device without a GPU."""
import json
import os
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from elegantrl_tpu.agents import AgentDQN as JAgentDQN
from elegantrl_tpu.agents import AgentPPO as JAgentPPO
from elegantrl_tpu.agents import AgentSAC as JAgentSAC
from elegantrl_tpu.config import Config as JConfig
from elegantrl_tpu.envs import CartPoleEnv as JCartPoleEnv
from elegantrl_tpu.envs import PendulumEnv as JPendulumEnv
from elegantrl_tpu.serve import PolicyServer as JPolicyServer
from elegantrl_tpu.train.runner import build_training as jbuild_training
from elegantrl_tpu.utils.checkpoint import save_pytree as jsave_pytree
from elegantrl_tpu_torch import PolicyServer
from elegantrl_tpu_torch.agents import AgentDQN, AgentPPO, AgentSAC

PEND = {'env_name': 'Pendulum-v1', 'num_envs': 4, 'max_step': 200, 'state_dim': 3,
        'action_dim': 1, 'if_discrete': False}
CART = {'env_name': 'CartPole-v1', 'num_envs': 4, 'max_step': 500, 'state_dim': 4,
        'action_dim': 2, 'if_discrete': True}
NET = (16, 16)
CASES = {'ppo': (JAgentPPO, AgentPPO, JPendulumEnv, PEND),
         'sac': (JAgentSAC, AgentSAC, JPendulumEnv, PEND),
         'dqn': (JAgentDQN, AgentDQN, JCartPoleEnv, CART)}


def _post(url, payload: bytes):
    req = urllib.request.Request(url, data=payload,
                                 headers={'Content-Type': 'application/json'})
    with urllib.request.urlopen(req, timeout=30) as r:
        return json.loads(r.read())


def _act(base, obs):
    return np.asarray(_post(base + '/act', json.dumps({'obs': obs.tolist()}).encode())
                      ['action'])


def _jax_checkpoint(tmp_path, case):
    jagent, _, jenv, env_args = CASES[case]
    args = JConfig(jagent, jenv, dict(env_args))
    args.net_dims = NET
    args.buffer_size = 64
    ctx = jbuild_training(args)
    ckpt = str(tmp_path / f'{case}.npz')
    jsave_pytree(ckpt, ctx.carry.agent_state)
    return ckpt


@pytest.fixture(scope='module')
def servers(tmp_path_factory):
    """Each case's checkpoint served by both packages."""
    tmp = tmp_path_factory.mktemp('serve')
    out = {}
    for case, (jagent, agent, _, env_args) in CASES.items():
        ckpt = _jax_checkpoint(tmp, case)
        jsrv = JPolicyServer(jagent, net_dims=NET, env_args=dict(env_args), checkpoint=ckpt)
        srv = PolicyServer(agent, net_dims=NET, env_args=dict(env_args), checkpoint=ckpt,
                           device='cpu')
        out[case] = (jsrv, srv, jsrv.start(port=0), srv.start(port=0), env_args)
    yield out
    for jsrv, srv, *_ in out.values():
        jsrv.stop()
        srv.stop()


@pytest.mark.parametrize('case', sorted(CASES))
def test_served_actions_match_the_jax_server(servers, case):
    jsrv, srv, jport, port, env_args = servers[case]
    rng = np.random.default_rng(0)
    for rows in (1, 5, 64):
        obs = rng.normal(size=(rows, env_args['state_dim'])).astype(np.float32)
        got = _act(f'http://127.0.0.1:{port}', obs)
        want = _act(f'http://127.0.0.1:{jport}', obs)
        assert got.shape == want.shape == ((rows,) if env_args['if_discrete']
                                           else (rows, env_args['action_dim']))
        if env_args['if_discrete']:
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-5)
    assert srv.agent_state is not None and srv.device.type == 'cpu'


def test_http_surface(servers):
    _, srv, _, port, env_args = servers['ppo']
    base = f'http://127.0.0.1:{port}'
    before = srv.requests
    health = json.loads(urllib.request.urlopen(base + '/health', timeout=30).read())
    assert health == {'ok': True, 'requests': before, 'state_dim': 3, 'if_discrete': False}
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(base + '/nowhere', timeout=30)
    assert e.value.code == 404
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(base + '/nowhere', b'{}')
    assert e.value.code == 404
    for bad in (b'{not json', b'{"no_obs": 1}', json.dumps({'obs': [[1.0, 2.0]]}).encode()):
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(base + '/act', bad)
        assert e.value.code == 400 and 'error' in json.loads(e.value.read())
    obs = np.random.default_rng(1).normal(size=3).astype(np.float32)
    one = np.asarray(_post(base + '/act', json.dumps({'obs': obs.tolist()}).encode())['action'])
    assert one.shape == (1,)
    np.testing.assert_allclose(one, srv.act(obs[None])[0], atol=1e-6, rtol=1e-5)
    assert srv.requests == before + 2          # the 400s served nothing


def test_four_client_threads(servers):
    """4 threads x 10 requests: 40 requests counted, every answer the one
    the same rows get alone."""
    _, srv, _, port, _ = servers['dqn']
    base = f'http://127.0.0.1:{port}'
    rng = np.random.default_rng(2)
    batches = [rng.normal(size=(1 + i % 7, 4)).astype(np.float32) for i in range(40)]
    want = [srv.act(b) for b in batches]
    before = srv.requests
    got, errors = [None] * 40, []

    def client(t):
        try:
            for i in range(t, 40, 4):
                got[i] = _act(base, batches[i])
        except Exception as e:   # reported below
            errors.append(e)

    threads = [threading.Thread(target=client, args=(t,)) for t in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    assert srv.requests - before == 40
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_act_under_many_threads_counts_every_request(servers):
    """More threads than cores, switching every microsecond: the request
    count and K11b's launch count (its wrapper's plain version on the CPU,
    counted here as the card counts launches) lose no update, and each
    answer is its rows' own."""
    import sys

    from elegantrl_tpu_torch.ops import kernels
    _, srv, _, _, _ = servers['ppo']
    obs = np.random.default_rng(3).normal(size=(16, 3)).astype(np.float32)
    want = srv.act(obs)
    real = kernels.fused_mlp3

    def counted(*a, **k):
        counted.launches += 1
        return real(*a, **k)
    counted.launches = 0
    before, errors = srv.requests, []
    n_threads, calls = 2 * (os.cpu_count() or 4), 10

    def worker():
        try:
            for _ in range(calls):
                np.testing.assert_array_equal(srv.act(obs), want)
        except Exception as e:   # reported below
            errors.append(e)

    interval = sys.getswitchinterval()
    kernels.fused_mlp3 = counted
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
        kernels.fused_mlp3 = real
    assert not any(t.is_alive() for t in threads) and not errors, errors
    assert srv.requests - before == counted.launches == n_threads * calls


def test_a_server_failure_fails_the_request(tmp_path, monkeypatch):
    """An error past the client's request (a failed launch on the card, say)
    is a 500, and nothing answers in its place."""
    ckpt = _jax_checkpoint(tmp_path, 'ppo')
    srv = PolicyServer(AgentPPO, net_dims=NET, env_args=dict(PEND), checkpoint=ckpt,
                       device='cpu')

    def broken(state, obs):
        raise RuntimeError('CUDA error: an illegal memory access was encountered')

    monkeypatch.setattr(srv, '_greedy', broken)
    port = srv.start(port=0)
    try:
        with pytest.raises(urllib.error.HTTPError) as e:
            _act(f'http://127.0.0.1:{port}', np.zeros((2, 3), np.float32))
        assert e.value.code == 500 and 'CUDA error' in json.loads(e.value.read())['error']
        assert srv.requests == 0
    finally:
        srv.stop()


def test_default_device_is_the_card(tmp_path, monkeypatch):
    ckpt = _jax_checkpoint(tmp_path, 'ppo')
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PolicyServer(AgentPPO, net_dims=NET, env_args=dict(PEND), checkpoint=ckpt)
