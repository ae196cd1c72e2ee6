"""The port's prioritised replay (``elegantrl_tpu_torch/ops/per.py``, the
replay buffer's PER, cumulative-return and save/load methods) against the
JAX package's on the same inputs.

Priorities are halves and small integers, which float32 sums exactly, so a
last-bit difference between XLA's and PyTorch's summation order cannot move
a draw across a chunk boundary: ids, leaves and sums are compared exactly;
importance weights to 1e-6 relative.  The stratified uniforms are the JAX
package's own draws, passed in.
"""
import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elegantrl_tpu.config import Config as JConfig
from elegantrl_tpu.ops.per import SegmentTree as JTree
from elegantrl_tpu.train.replay_buffer import ReplayBuffer as JReplayBuffer
from elegantrl_tpu_torch import Config
from elegantrl_tpu_torch.ops.per import SegmentTree, last_writer
from elegantrl_tpu_torch.train.replay_buffer import ReplayBuffer
from elegantrl_tpu_torch.utils.jax_params import buffer_state_from_numpy, buffer_state_to_numpy

torch.set_num_threads(1)
M, N = 600, 4            # 3 chunks of 256 leaves per sequence (cap 768)


def _halves(rng, shape):
    return (rng.integers(1, 16, shape) * 0.5).astype(np.float32)


def _t(x):
    return torch.tensor(np.asarray(x))


def _trees(rng):
    """The same filled tree in both packages: every row at priority 10,
    then an exactly-summable scatter."""
    jt, pt = JTree(M, N), SegmentTree(M, N)
    ids = np.arange(M, dtype=np.int32)
    prob = _halves(rng, (M, N))
    jtree = jax.jit(jt.update)(jt.init(), jnp.asarray(ids), jnp.asarray(prob))
    ptree = pt.update(pt.init('cpu'), _t(ids).long(), _t(prob))
    return jt, pt, jtree, ptree


def _assert_tree_equal(jtree, ptree):
    for a, b in zip(jtree, ptree):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def test_init_and_update():
    jt, pt, jtree, ptree = _trees(np.random.default_rng(0))
    assert (pt.n_chunks, pt.cap) == (jt.n_chunks, jt.cap) == (3, 768)
    _assert_tree_equal(jtree, ptree)
    np.testing.assert_array_equal(pt.totals(ptree).numpy(), np.asarray(jt.totals(jtree)))


def test_update_scattered_duplicates_last_wins():
    rng = np.random.default_rng(1)
    jt, pt, jtree, ptree = _trees(rng)
    B = 64
    ids0 = rng.integers(0, M, B).astype(np.int32)
    ids1 = rng.integers(0, N, B).astype(np.int32)
    ids0[10:20], ids1[10:20] = ids0[3], ids1[3]         # ten duplicates of one pair
    prob = _halves(rng, B)
    prob[3], prob[19] = 1.5, 7.0                        # the last one must win
    jtree = jax.jit(jt.update_scattered)(jtree, jnp.asarray(ids0), jnp.asarray(ids1),
                                         jnp.asarray(prob))
    ptree = pt.update_scattered(ptree, _t(ids0), _t(ids1), _t(prob))
    _assert_tree_equal(jtree, ptree)
    assert float(ptree[1][ids1[3], ids0[3]]) == 7.0


def test_last_writer():
    keys = torch.tensor([5, 3, 5, 1, 3, 5, 7])
    assert last_writer(keys).tolist() == [5, 4, 5, 3, 4, 5, 6]


@pytest.mark.parametrize('lead', [(), (3,)])
def test_sample_ids_exact(lead):
    """Stratified draws through both levels, one or several at once (the
    fused path draws a chunk's minibatches together)."""
    rng = np.random.default_rng(2)
    jt, pt, jtree, ptree = _trees(rng)
    sub = 16
    keys = jax.random.split(jax.random.PRNGKey(7), max(int(np.prod(lead)), 1))
    want_ids, want_prios, u = jax.jit(jax.vmap(
        lambda k: (*jt.sample(jtree, k, sub), jax.random.uniform(k, (N, sub)))))(keys)
    ids, prios = pt.sample(ptree, sub, _t(np.asarray(u).reshape(lead + (N, sub))))
    np.testing.assert_array_equal(ids.reshape(-1, N, sub).numpy(), np.asarray(want_ids))
    np.testing.assert_array_equal(prios.reshape(-1, N, sub).numpy(), np.asarray(want_prios))


def test_leaves_from_leaves_min_leaf():
    rng = np.random.default_rng(3)
    jt, pt, jtree, ptree = _trees(rng)
    np.testing.assert_array_equal(pt.leaves(ptree).numpy(), np.asarray(jt.leaves(jtree)))
    leaves = _halves(rng, (N, M))
    _assert_tree_equal(jax.jit(jt.from_leaves)(jnp.asarray(leaves)), pt.from_leaves(_t(leaves)))
    min_leaf = jax.jit(jt.min_leaf)
    for size in (1, 257, M):
        np.testing.assert_array_equal(pt.min_leaf(ptree, size).numpy(),
                                      np.asarray(min_leaf(jtree, jnp.asarray(size))))


# ------------------------------------------------------------------ buffer

S, A, H = 3, 2, 40


def _items(rng, h):
    return (rng.standard_normal((h, N, S)).astype(np.float32),
            rng.uniform(-1, 1, (h, N, A)).astype(np.float32),
            rng.standard_normal((h, N)).astype(np.float32),
            (rng.random((h, N)) > 0.1).astype(np.float32), np.ones((h, N), np.float32))


@pytest.fixture(scope='module')
def buffers():
    """Both buffers with PER and the cumulative-return column, filled by two
    inserts that wrap the ring once (max_size 64)."""
    rng = np.random.default_rng(4)
    jargs, args = JConfig(), Config()
    jargs.lambda_fit_cum_r = args.lambda_fit_cum_r = 0.1
    jrb = JReplayBuffer(64, S, A, num_seqs=N, if_use_per=True, args=jargs)
    rb = ReplayBuffer(64, S, A, num_seqs=N, if_use_per=True, args=args, device='cpu')
    jbuf, buf = jrb.init(), rb.init()
    update = jax.jit(jrb.update)
    for h in (40, 40):
        items = _items(rng, h)
        jbuf = update(jbuf, tuple(jnp.asarray(x) for x in items))
        buf = rb.update(buf, tuple(_t(x) for x in items))
    return jrb, rb, jbuf, buf


def test_insert_writes_priority_ten(buffers):
    jrb, rb, jbuf, buf = buffers
    assert (buf.ptr, buf.size) == (int(jbuf.ptr), int(jbuf.size)) == (16, 64)
    _assert_tree_equal(jbuf.per_tree, buf.per_tree)
    assert float(buf.per_tree[1][:, :64].min()) == 10.0


def test_sample_for_per_and_priority_update(buffers):
    jrb, rb, jbuf, buf = buffers
    rng = np.random.default_rng(5)
    # exactly-summable priorities first, so the draw is non-trivial
    ids0 = np.arange(64, dtype=np.int32)
    prob = _halves(rng, (64, N))
    jbuf = jbuf._replace(per_tree=jax.jit(jrb.tree.update)(jbuf.per_tree, jnp.asarray(ids0),
                                                            jnp.asarray(prob)))
    buf = buffer_state_from_numpy(jax.tree.map(np.asarray, jbuf), 'cpu')
    key = jax.random.PRNGKey(9)
    want = jax.jit(jrb.sample_for_per, static_argnums=2)(jbuf, key, 32)
    got = rb.sample_for_per(buf, 32, u=_t(jax.jit(lambda k: jax.random.uniform(k, (N, 8)))(key)))
    for name, a, b in zip(('ids0', 'ids1'), want[7], got[7]):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=name)
    for a, b in zip(want[:6], got[:6]):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    np.testing.assert_allclose(got[6].numpy(), np.asarray(want[6]), rtol=1e-6)
    td = rng.uniform(0, 12, 32).astype(np.float32)
    td[5] = 0.0                                            # clipped to 1e-8
    jbuf2 = jax.jit(jrb.td_error_update_for_per)(jbuf, want[7], jnp.asarray(td))
    buf2 = rb.td_error_update_for_per(buf, got[7], _t(td))
    for a, b in zip(jbuf2.per_tree, buf2.per_tree):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6)


def test_update_cum_rewards(buffers):
    jrb, rb, jbuf, buf = buffers
    cum = np.random.default_rng(6).standard_normal((40, N)).astype(np.float32)
    jbuf = jax.jit(jrb.update_cum_rewards, static_argnums=1)(jbuf, 40, jnp.asarray(cum))
    buf = rb.update_cum_rewards(buf, 40, _t(cum))
    np.testing.assert_array_equal(buf.cum_rewards.numpy(), np.asarray(jbuf.cum_rewards))


@pytest.mark.parametrize('writer', ['jax', 'port'])
def test_save_or_load_history_across_packages(buffers, writer):
    """One package writes ``replay_buffer.npz``, the other reads it back:
    every field, the PER leaves (sums rebuilt) and the cumulative returns."""
    jrb, rb, jbuf, buf = buffers
    with tempfile.TemporaryDirectory() as cwd:
        if writer == 'jax':
            jrb.save_or_load_history(jbuf, cwd, if_save=True)
            got = rb.save_or_load_history(rb.init(), cwd, if_save=False)
            got = jax.tree.map(np.asarray, buffer_state_to_numpy(got))
            want = jax.tree.map(np.asarray, jbuf)
        else:
            rb.save_or_load_history(buf, cwd, if_save=True)
            got = jax.tree.map(np.asarray, jrb.save_or_load_history(jrb.init(), cwd,
                                                                    if_save=False))
            want = jax.tree.map(np.asarray, buffer_state_to_numpy(buf))
        assert os.path.isfile(os.path.join(cwd, 'replay_buffer.npz'))
    for a, b in zip(jax.tree.leaves(want), jax.tree.leaves(got)):
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a))
