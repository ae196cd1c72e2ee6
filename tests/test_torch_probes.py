"""The plain versions of the seven Mosaic probes (``elegantrl_tpu_torch/ops/probes.py``)
against the probes of ``scripts/probe_mosaic_ops.py``, run in interpret mode
under ``jax.jit`` (``pl.pallas_call`` patched to ``interpret=True``, as the
JAX package's own tests run Pallas on the CPU).  The script's inputs are the
only ones its functions take; their values are integers in f32, so the
tolerance is zero.
"""
import importlib.util
from functools import partial
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from elegantrl_tpu_torch.ops import probes

SCRIPT = Path(__file__).resolve().parents[1] / 'scripts' / 'probe_mosaic_ops.py'


@pytest.fixture(scope='module')
def script():
    spec = importlib.util.spec_from_file_location('probe_mosaic_ops', SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize('name', list(probes.PROBES))
def test_probe_plain_version_matches_pallas_probe(name, script, monkeypatch):
    monkeypatch.setattr(script.pl, 'pallas_call',
                        partial(script.pl.pallas_call, interpret=True))
    want = torch.from_numpy(np.array(jax.jit(getattr(script, f'probe_{name}'))()))
    _, reference = probes.WRAPPERS[name]
    got = reference(*probes.probe_inputs(name, 'cpu'))
    assert torch.equal(got, want), (name, got.flatten()[:4], want.flatten()[:4])
    # on the CPU the wrapper is the plain version
    wrapper, _ = probes.WRAPPERS[name]
    assert torch.equal(wrapper(*probes.probe_inputs(name, 'cpu')), want)
