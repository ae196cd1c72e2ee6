"""The DDPG/TD3 chunk's kernel (K7, under PER K7', ``csrc/ddpg_update.cu``)
and the SAC/ModSAC chunk's (K8, ``csrc/sac_update.cu``) take every workload
that the JAX package sends to its Pallas chunk.  DDPG/TD3: batch a multiple
of 128 up to 2048 with ``max(net_dims) * batch <= 131072``, two hidden
layers, under PER also a multiple of the buffer's sequences
(``elegantrl_tpu/agents/ddpg_td3.py:_fused_update``).  SAC/ModSAC: the same
batches with a lane chunk and ``max(net_dims) <= 128``, no PER
(``elegantrl_tpu/agents/sac.py:313-332``).  At the corners of those sets,
with the widest state (151, the stock env's) and 15 actions, the port's fit
holds and ``select_kernel`` with ``'auto'`` on a card (``device='cuda'``,
decided before anything is allocated, so a CPU box can read it) takes the
kernel; ``False`` is refused there.  The kernels' shared memory is fixed
(the activations live in a workspace), and its Python copy matches the
layout of the structs the ``.cu`` files declare.
"""
import ctypes

import pytest

from elegantrl_tpu_torch import Config
from elegantrl_tpu_torch.agents import AgentDDPG, AgentModSAC, AgentSAC, AgentTD3
from elegantrl_tpu_torch.agents import ddpg_td3 as pddpg
from elegantrl_tpu_torch.agents import sac as psac
from elegantrl_tpu_torch.ops import fused_offpolicy_update as fo
from elegantrl_tpu_torch.train.replay_buffer import ReplayBuffer

S, A = 151, 15
DDPG_CORNERS = [((64, 64), 2048), ((128, 128), 1024), ((256, 256), 512), ((1024, 1024), 128)]
SAC_CORNERS = [((64, 64), 2048), ((128, 128), 2048), ((128, 128), 1024), ((128, 128), 128)]


def _make(module, agent_class, net, batch, monkeypatch, **kw):
    args = Config()
    args.batch_size, args.device = batch, 'cuda'
    for k, v in kw.items():
        setattr(args, k, v)
    chosen = {}
    real = module.select_kernel

    def spy(a, flag, jax_takes, port_fits, *rest, **kwargs):
        out = real(a, flag, jax_takes, port_fits, *rest, **kwargs)
        chosen[flag] = (jax_takes, port_fits, out)
        return out

    monkeypatch.setattr(module, 'select_kernel', spy)
    buf = ReplayBuffer(16, S, A, num_seqs=4, if_use_per=bool(kw.get('if_use_per')), args=args,
                       device='cuda')
    agent_class.make(net, S, A, args, buffer=buf)
    return chosen['use_fused_update']


@pytest.mark.parametrize('per', [False, True], ids=['uniform', 'per'])
@pytest.mark.parametrize('agent_class', [AgentDDPG, AgentTD3], ids=lambda c: c.__name__)
@pytest.mark.parametrize('net,batch', DDPG_CORNERS, ids=lambda x: str(x))
def test_card_takes_k7_wherever_jax_takes_its_chunk(agent_class, net, batch, per,
                                                    monkeypatch):
    assert max(net) * batch <= 131072 and batch % 128 == 0 and batch <= 2048 and batch % 4 == 0
    assert fo.ddpg_fits(net)
    kw = dict(if_use_per=per)
    assert _make(pddpg, agent_class, net, batch, monkeypatch, **kw) == (True, True, True)
    with pytest.raises(ValueError, match='use_fused_update=False'):
        _make(pddpg, agent_class, net, batch, monkeypatch, use_fused_update=False, **kw)


@pytest.mark.parametrize('agent_class', [AgentSAC, AgentModSAC], ids=lambda c: c.__name__)
@pytest.mark.parametrize('net,batch', SAC_CORNERS, ids=lambda x: str(x))
def test_card_takes_k8_wherever_jax_takes_its_chunk(agent_class, net, batch, monkeypatch):
    assert max(net) <= 128 and batch % 128 == 0 and batch <= 2048
    assert fo.sac_fits(net)
    assert _make(psac, agent_class, net, batch, monkeypatch) == (True, True, True)
    with pytest.raises(ValueError, match='use_fused_update=False'):
        _make(psac, agent_class, net, batch, monkeypatch, use_fused_update=False)


def test_fits_take_two_hidden_layers_only():
    for fits in (fo.dqn_fits, fo.ddpg_fits, fo.sac_fits):
        assert fits((64, 64)) and fits((2048, 2048))
        assert not fits((64,)) and not fits((64, 64, 64))


class _Smem(ctypes.Structure):  # gg::Smem, csrc/grid_gemm.cuh
    _fields_ = [('a', ctypes.c_float * 33 * 32), ('b', ctypes.c_float * 33 * 32),
                ('red', ctypes.c_float * 2 * 8)]


def test_smem_copies_match_the_kernels_layout():
    assert fo.GG_SMEM_BYTES == ctypes.sizeof(_Smem)
    # the DQN chunk: 8 warps' 2 x 64 head rows beside the tiles
    assert fo.DQN_SMEM_BYTES == ctypes.sizeof(_Smem) + 4 * 8 * 2 * 64
    # the DDPG/TD3 and SAC chunks: the tiles alone
    assert fo.DDPG_SMEM_BYTES == fo.SAC_SMEM_BYTES == ctypes.sizeof(_Smem)
    assert len(fo.DDPG_PHASES) == 21 and len(fo.SAC_PHASES) == 20
