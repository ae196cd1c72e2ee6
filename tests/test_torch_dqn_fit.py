"""The DQN-family chunk's kernel (K9, ``csrc/dqn_update.cu``) takes every
workload that the JAX package sends to its Pallas chunk: batch a multiple of
128 up to 2048 with ``max(net_dims) * batch <= 131072`` and two hidden
layers (``elegantrl_tpu/agents/dqn.py:_fused_update``).  At the corners of
that set, with the widest state (151, the stock env's) and 15 actions, the
port's fit holds for all four nets, and ``select_kernel`` with ``'auto'``
on a card (``device='cuda'``, decided before anything is allocated, so a
CPU box can read it) takes the kernel; ``False`` is refused there.
"""
import pytest

from elegantrl_tpu_torch import Config
from elegantrl_tpu_torch.agents import AgentD3QN, AgentDoubleDQN, AgentDQN, AgentDuelingDQN
from elegantrl_tpu_torch.agents import dqn as pdqn
from elegantrl_tpu_torch.ops import fused_offpolicy_update as fo
from elegantrl_tpu_torch.train.replay_buffer import ReplayBuffer

S, A = 151, 15
CORNERS = [((64, 64), 2048), ((128, 128), 1024), ((256, 256), 512), ((1024, 1024), 128)]
AGENTS = [AgentDQN, AgentDoubleDQN, AgentDuelingDQN, AgentD3QN]


def _make(agent_class, net, batch, monkeypatch, **kw):
    args = Config()
    args.batch_size, args.device = batch, 'cuda'
    for k, v in kw.items():
        setattr(args, k, v)
    chosen = {}
    real = pdqn.select_kernel

    def spy(a, flag, jax_takes, port_fits, *rest, **kwargs):
        out = real(a, flag, jax_takes, port_fits, *rest, **kwargs)
        chosen[flag] = (jax_takes, port_fits, out)
        return out

    monkeypatch.setattr(pdqn, 'select_kernel', spy)
    buf = ReplayBuffer(16, S, A, num_seqs=4, if_discrete=True, args=args, device='cuda')
    agent_class.make(net, S, A, args, buffer=buf)
    return chosen['use_fused_update']


@pytest.mark.parametrize('agent_class', AGENTS, ids=lambda c: c.__name__)
@pytest.mark.parametrize('net,batch', CORNERS, ids=lambda x: str(x))
def test_card_takes_k9_wherever_jax_takes_its_chunk(agent_class, net, batch, monkeypatch):
    assert max(net) * batch <= 131072 and batch % 128 == 0 and batch <= 2048
    assert fo.dqn_fits(net)
    assert _make(agent_class, net, batch, monkeypatch) == (True, True, True)
    with pytest.raises(ValueError, match='use_fused_update=False'):
        _make(agent_class, net, batch, monkeypatch, use_fused_update=False)
