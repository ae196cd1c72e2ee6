"""Run the seven Mosaic lowering probes of ``scripts/probe_mosaic_ops.py`` as
the port's CUDA kernels (``elegantrl_tpu_torch/ops/probes.py``) on the card.

    python3 scripts/torch_probe_ops.py

Prints the device, then ``ok <name>: <first values>`` for each probe at the
JAX script's inputs.  Unlike the JAX script it catches nothing: a probe
that fails to build or launch, or whose output differs from its plain
PyTorch version on the same inputs, ends the run with a non-zero exit code.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from elegantrl_tpu_torch.ops import probes  # noqa: E402


def main():
    if not torch.cuda.is_available():
        sys.exit('torch_probe_ops: torch.cuda.is_available() is False; this needs a CUDA card')
    print(f'device: {torch.cuda.get_device_name(0)}', flush=True)
    outs = probes.run_probes('cuda')
    torch.cuda.synchronize()
    for name, out in outs.items():
        _, reference = probes.WRAPPERS[name]
        want = reference(*probes.probe_inputs(name, 'cuda'))
        if not torch.equal(out, want):
            sys.exit(f'FAIL {name}: kernel {out.flatten()[:4].tolist()} differs from its plain '
                     f'version {want.flatten()[:4].tolist()}')
        print(f'ok   {name}: {out.cpu().numpy().ravel()[:4]}', flush=True)


if __name__ == '__main__':
    main()
